"""Sharded serving on the CPU: the port's ranks over gloo against the
reference's sharded ``prefill`` and ``decode_step`` on the same mesh.

The reference runs in one subprocess (``_torch_tp_oracle.py``: four
forced host devices, every case of ``_torch_tp_cases.CASES`` on its mesh,
jitted under ``use_rules``); the port in one spawned world of gloo ranks a
mesh shape (``_torch_tp_world.py``), with the weights and prompts the
oracle wrote.  The cases, all smoke configs in fp32: qwen3-1.7b (heads
whole at tp 2, KV heads split at tp 4), smollm-360m at tp 2 (split query
and KV heads), internvl2-1b at tp 4 (a split KV head, the frontend's
prefix), qwen3-moe and llama4 (expert parallelism; once more with a
capacity factor of 0.5, so that copies drop; llama4's sliding-window
layers as 32-slot rings that the prompt wraps), qwen3-1.7b with the int8
cache, and the (data 2, model 2) mesh, which splits the batch.

Tolerances: the logits of the prefill and of four greedy decode steps
within ``LOGITS_TOL`` of their largest magnitude (the reference's own
sharded-against-unsharded gap is 1e-6 to 6e-6 on these configs); the MoE's
``aux_loss`` and ``drop_frac`` within ``AUX_TOL``; against the port's own
single rank, within ``SELF_TOL`` relative (the sums run in another order).
A case whose copies drop is held only against the reference at the same
tensor-parallel width: the capacities depend on it.  Every subprocess
runs under a timeout, so a lost rank fails the tests and hangs nothing.
"""
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401,E402

import _torch_tp_cases as C
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import serve_step as S

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
LOGITS_TOL = 1e-4
AUX_TOL = 1e-6
SELF_TOL = 1e-5
ORACLE_TIMEOUT_S = 300
WORLD_TIMEOUT_S = 240
LAUNCH_TIMEOUT_S = 180

MOE = [n for n, c in C.CASES.items()
       if c["arch"].startswith(("qwen3-moe", "llama4"))]
NO_DROP = [n for n, c in C.CASES.items() if not c.get("capacity")]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}


def _run(cmd, timeout: float, env=None) -> subprocess.CompletedProcess:
    """``cmd`` from the repository's root; on its timeout the whole process
    group (a world's ranks with it) is killed and the test fails."""
    p = subprocess.Popen(cmd, cwd=ROOT, env=env or _env(), text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"{cmd} outlived {timeout} s")
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results and every world's."""
    d = tmp_path_factory.mktemp("tp_serve")
    res = _run([sys.executable, str(HERE / "_torch_tp_oracle.py"), str(d)],
               ORACLE_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    for dp, tp in C.MESHES:
        res = _run([sys.executable, str(HERE / "_torch_tp_world.py"),
                    "--data", str(dp), "--model", str(tp), str(d)],
                   WORLD_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
    return d


def _ranks(d, name):
    world = C.CASES[name]["mesh"][0] * C.CASES[name]["mesh"][1]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(world)]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(C.CASES))
def test_sharded_logits_match_the_reference(runs, name):
    """Every rank's prefill and four decode steps' logits (the whole batch
    and vocab) against the reference's sharded ones."""
    want = np.load(runs / f"{name}.npz")["logits"]
    for r, got in enumerate(_ranks(runs, name)):
        assert got["logits"].shape == want.shape
        assert _rel(got["logits"], want) <= LOGITS_TOL, (r, _rel(
            got["logits"], want))


@pytest.mark.parametrize("name", MOE)
def test_moe_aux_loss_and_drop_frac_match_the_reference(runs, name):
    z = np.load(runs / f"{name}.npz")
    for got in _ranks(runs, name):
        for key in ("aux_loss", "drop_frac"):
            assert abs(float(got[key]) - float(z[f"aux.{key}"])) <= AUX_TOL
    dropped = float(z["aux.drop_frac"])
    assert (dropped > 0) == bool(C.CASES[name].get("capacity")), dropped


@pytest.mark.parametrize("name", list(C.CASES))
def test_cache_blocks_have_the_shapes_cache_pspecs_gives(runs, name):
    for got in _ranks(runs, name):
        assert list(got["cache_shapes"]) == list(got["want_shapes"])
    dp, tp = C.CASES[name]["mesh"]
    k = list(_ranks(runs, name)[0]["cache_names"]).index("layers.0.k")
    shape = eval(_ranks(runs, name)[0]["cache_shapes"][k])
    assert shape[0] == C.BATCH // dp        # the batch over "data"


@pytest.mark.parametrize("name", NO_DROP)
def test_sharded_matches_the_single_rank_port(runs, name):
    """The port at its tensor-parallel width against its own single rank,
    from the same weights and tokens."""
    case = C.CASES[name]
    z = np.load(runs / f"{name}.npz")
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    params = C.unflatten({k[len("param."):]: z[k] for k in z.files
                          if k.startswith("param.")})
    tokens = torch.from_numpy(z["tokens"]).long()
    frontend = (torch.from_numpy(z["frontend"]) if "frontend" in z.files
                else None)
    ml = case["max_len"]
    with torch.inference_mode():
        model = convert.lm_params_from_numpy(params, cfg, device="cpu")
        if cfg.kv_quant:
            logits, cache = S.prefill_by_stepping(model, tokens, max_len=ml)
        else:
            logits, cache = S.prefill(model, tokens, max_len=ml,
                                      frontend=frontend)
        out = [logits]
        for tok in z["fed"]:
            logits, cache = S.decode_step(model, cache,
                                          torch.from_numpy(tok).long())
            out.append(logits)
    want = torch.stack(out).numpy()
    for got in _ranks(runs, name):
        assert _rel(got["logits"], want) <= SELF_TOL


@pytest.mark.parametrize("mesh", C.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_draws_the_blocks_of_the_unsharded_weights(runs, mesh):
    names = [n for n, c in C.CASES.items() if c["mesh"] == mesh]
    for name in names:
        assert all(bool(g["blocks_equal"]) for g in _ranks(runs, name))


def test_a_sharded_decode_step_runs_its_collectives(runs):
    """qwen3-1.7b smoke at tp 2, per decode step: an all_gather of q, k, v
    and two all_reduces (flash-decoding's max, then its sums) in each of
    the 2 layers' attention, an all_reduce of w_o and of w_down each, the
    embedding's all_reduce and the logits' all_gather."""
    got = _ranks(runs, "qwen3_tp2")[0]
    reduce_, gather, a2a = got["step_collectives"]
    assert (reduce_, gather, a2a) == (2 * 4 + 1, 2 * 1 + 1, 0)
    moe = _ranks(runs, "qwen3moe_tp2")[0]["step_collectives"]
    assert moe[2] == 2 * 2                  # two exchanges a MoE layer


# ---------------------------------------------------------------------------
# The launcher, the mesh
# ---------------------------------------------------------------------------


def _tokens(out: str) -> str:
    line = next(l for l in out.splitlines() if "sample tokens" in l)
    return line.split(":", 1)[1].strip()


def test_launcher_under_torchrun_matches_one_rank():
    args = ["-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b",
            "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "12", "--gen", "4", "--max-len", "32"]
    run = _run([sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2", *args,
                "--model-parallel", "2"],
               LAUNCH_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    one = _run([sys.executable, *args], LAUNCH_TIMEOUT_S)
    assert one.returncode == 0, one.stderr[-4000:]
    assert "mesh {'data': 1, 'model': 2} over 2 rank(s), backend gloo" in (
        run.stdout)
    assert run.stdout.count("sample tokens") == 1    # rank 0 prints
    assert _tokens(run.stdout) == _tokens(one.stdout)


def test_launcher_refuses_a_model_axis_without_ranks(monkeypatch):
    """No rank quietly serves alone: ``--model-parallel 2`` outside
    ``torchrun`` raises before anything is drawn."""
    from repro_torch.launch import serve
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                    "--model-parallel", "2"])


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL runs one rank a card"):
        mesh_lib.init_world("nccl", "cuda")


def test_an_abstract_mesh_runs_nothing():
    """The production mesh without its 256 ranks gives the rules their
    shape, and raises where a layer would need its groups."""
    mesh = mesh_lib.make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("model")
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.make_host_mesh(model=2)
