"""The port's ground rules: it imports neither JAX nor the JAX package,
builds nothing at import, runs on the card unless asked for the CPU, and
``chip_smoke.py`` fails without a card or without the repository."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import _torch_threads  # noqa: F401,E402

torch = pytest.importorskip("torch")

from repro_torch.core import network  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy, resolve_impl  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


#: The modules of the static verifier, the traffic models and the shims:
#: each must stand in PORT_FILES, so the rule above holds them too.
NEW_MODULES = ("analysis/__init__.py", "analysis/__main__.py",
               "analysis/diagnostics.py", "analysis/planlint.py",
               "analysis/launch_check.py", "analysis/trace_audit.py",
               "kernels/gridspec.py", "kernels/spans.py",
               "core/intensity.py", "core/separable.py", "models/moe.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_are_held_to_the_import_rule(module):
    path = PORT / module
    assert path in PORT_FILES
    assert not {m.split(".")[0] for m in _imported_modules(path)} & {
        "jax", "jaxlib", "repro"}


#: The training slice's modules, whisper's config and ``train_e2e``: held
#: to the same rule.
TRAINING_MODULES = ("optim/__init__.py", "optim/adamw.py",
                    "optim/compress.py", "data/__init__.py",
                    "data/pipeline.py", "train/__init__.py",
                    "train/train_step.py", "train/checkpoint.py",
                    "train/trainer.py", "launch/train.py",
                    "configs/whisper_small.py", "train_e2e.py")


#: The sharding slice's modules: held to the same rule.
SHARDING_MODULES = ("sharding/__init__.py", "sharding/rules.py",
                    "sharding/collectives.py", "launch/mesh.py",
                    "launch/dryrun.py", "launch/serve.py")


@pytest.mark.parametrize("module", SHARDING_MODULES)
def test_sharding_modules_are_held_to_the_import_rule(module):
    path = PORT / module
    assert path in PORT_FILES
    assert not {m.split(".")[0] for m in _imported_modules(path)} & {
        "jax", "jaxlib", "repro"}


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_held_to_the_import_rule(module):
    path = PORT / module
    assert path in PORT_FILES
    assert not {m.split(".")[0] for m in _imported_modules(path)} & {
        "jax", "jaxlib", "repro"}


def test_port_imports_with_jax_and_reference_blocked_and_no_nvcc(tmp_path):
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "for info in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._libs\n"
        "print('ok')\n")
    env = {"PATH": str(tmp_path), "PYTHONPATH": str(ROOT / "src"),
           "CUDA_HOME": str(tmp_path / "no-cuda"), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_default_to_the_card():
    _skip_if_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network.init_network(network.mobilenet_v1_spec(0.25))
    from repro_torch import mobilenet_inference
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mobilenet_inference.main(["--arch", "v1", "--res", "16"])


def test_serving_entry_points_default_to_the_card():
    _skip_if_card()
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(get_config("xlstm-125m", smoke=True))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-125m", "--smoke", "--prompt-len", "4", "--gen", "2"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "[serve]" not in out.stdout


@pytest.mark.parametrize("argv", (
    ("repro_torch.launch.serve", "--arch", "whisper-small", "--smoke",
     "--prompt-len", "4", "--gen", "2"),
    ("repro_torch.launch.train", "--arch", "smollm-360m", "--smoke",
     "--steps", "1"),
    ("repro_torch.launch.train", "--arch", "whisper-small", "--smoke",
     "--steps", "1"),
    ("repro_torch.train_e2e", "--steps", "1")))
def test_whisper_and_training_entry_points_default_to_the_card(argv,
                                                                tmp_path):
    _skip_if_card()
    out = subprocess.run(
        [sys.executable, "-m", *argv, *(("--ckpt-dir", str(tmp_path))
                                        if "train" in argv[0] else ())],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not any(t in out.stdout for t in ("[serve]", "[train]", "[e2e]"))
    assert not list(tmp_path.iterdir())


def test_backend_follows_the_tensor():
    cpu = torch.device("cpu")
    assert resolve_impl("auto", cpu) == "torch"
    assert resolve_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve_impl("torch", torch.device("cuda", 0)) == "torch"
    assert KernelPolicy().resolved(cpu) == "torch"
    with pytest.raises(ValueError, match="impl='cuda'"):
        resolve_impl("cuda", cpu)
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("pallas", cpu)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})


def test_chip_smoke_fails_without_a_card():
    _skip_if_card()
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
