"""Sharded training on the CPU: the port's ranks over gloo against the
reference's sharded training on the same mesh (the counterpart of the
reference's ``test_dp_tp_loss_matches_single_device`` and
``test_elastic_reshard_roundtrip``).

The reference runs in one subprocess (``_torch_tp_oracle.py --cases
TRAIN_CASES``: four forced host devices, the train rules, the parameters
placed by ``param_specs``, the batch by ``batch_pspecs`` and the moments
by ``zero1_specs``); the port in one spawned world of gloo ranks a mesh
shape (``_torch_tp_world.py``), with the weights and batch the oracle
wrote.  The cases of ``_torch_tp_cases.TRAIN_CASES``, smoke configs in
fp32 on a global batch of 8 x 32 tokens (some labels ignored):
qwen3-1.7b at (2, 2), (4, 1) and (1, 4) (its KV heads split in halves)
and with 2 microbatches, smollm-360m (tied, heads gathered) at (2, 2),
qwen3-moe at (2, 2) and (1, 2) against the reference's sharded path (each
shard routes its own tokens with its own capacity, so the unsharded MoE
is no oracle), a bf16 qwen3 case against the port's own one-rank step,
and qwen3 served under ``serve_weight_fsdp``.

Bounds: the loss within ``LOSS_RTOL`` (the reference's own test's);
each gathered gradient within ``GRAD_TOL`` of its largest magnitude;
``grad_norm`` and ``param_norm`` within ``NORM_RTOL``; the sharded AdamW
on the reference's gradients within the one-rank check's rtol / atol
(``tests/test_torch_train.py``); bf16 within ``BF16_TOL``; the served
logits within ``LOGITS_TOL``.  The elastic checkpoints and the recovery
under (2, 2) are bit for bit.  Every subprocess runs under a timeout.
"""
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import _torch_threads  # noqa: F401,E402
import torch

import _torch_tp_cases as C

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
ADAM_TOL = 1e-6
BF16_TOL = 5e-2
LOGITS_TOL = 1e-4
ORACLE_TIMEOUT_S = 300
WORLD_TIMEOUT_S = 240
LAUNCH_TIMEOUT_S = 180

CASES = C.TRAIN_CASES
ORACLE = [n for n, c in CASES.items()
          if c.get("oracle", True) and not c.get("serve")]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}


def _start(cmd, env=None) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=ROOT, env=env or _env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


def _finish(p: subprocess.Popen, cmd, timeout: float):
    """``p``'s result; on its timeout the whole process group (a world's
    ranks with it) is killed and the test fails."""
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"{cmd} outlived {timeout} s")
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def _run(cmd, timeout: float, env=None) -> subprocess.CompletedProcess:
    return _finish(_start(cmd, env), cmd, timeout)


def _elastic_one(d: pathlib.Path) -> None:
    """The one-rank checkpoint the (2, 2) world restores: the elastic
    model's state after one step (moments and step set)."""
    import _torch_tp_world as W
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import Checkpointer
    model = W._elastic_model(None)
    step = TS.make_train_step(model, W._tcfg())
    batch = next(DataIterator(DataConfig(vocab_size=model.cfg.vocab_size,
                                         seq_len=16, global_batch=8,
                                         seed=3), prefetch=0))
    state, _ = step(TS.init_train_state(model, W._tcfg()), batch)
    Checkpointer(str(d / "elastic_one")).save(1, state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results and every world's: the
    oracle runs its cases in three processes side by side; the (1, 2) and
    (1, 4) worlds run together, then (2, 2), then (4, 1), which restores
    the checkpoint (2, 2) saved."""
    d = tmp_path_factory.mktemp("tp_train")
    t0 = time.monotonic()
    names = list(CASES)
    oracles = []
    for part in (names[0::3], names[1::3], names[2::3]):
        cmd = [sys.executable, str(HERE / "_torch_tp_oracle.py"), "--cases",
               "TRAIN_CASES", str(d), *part]
        oracles.append((cmd, _start(cmd)))
    _elastic_one(d)
    for cmd, p in oracles:
        res = _finish(p, cmd, ORACLE_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
    assert C.meshes(CASES) == [(1, 2), (1, 4), (2, 2), (4, 1)]
    for wave in (((1, 2), (1, 4)), ((2, 2),), ((4, 1),)):
        worlds = []
        for dp, tp in wave:
            cmd = [sys.executable, str(HERE / "_torch_tp_world.py"),
                   "--cases", "TRAIN_CASES", "--data", str(dp), "--model",
                   str(tp), str(d)]
            worlds.append((cmd, _start(cmd)))
        for cmd, p in worlds:
            res = _finish(p, cmd, WORLD_TIMEOUT_S)
            assert res.returncode == 0, res.stderr[-4000:]
    print(f"[tp_train] oracle and worlds: {time.monotonic() - t0:.1f} s")
    return d


def _ranks(d, name):
    dp, tp = CASES[name]["mesh"]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(dp * tp)]


def _by_port_name(z, prefix: str, arch: str) -> dict:
    """The oracle's arrays under ``prefix`` by the port's names."""
    import _torch_tp_world as W
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    period = len(T.model_pattern(get_config(arch, smoke=True)))
    return {k: np.asarray(v, np.float32)
            for k, v in W._port_leaves(z, prefix, period).items()}


def _assert_each_within(got: dict, want: dict, tol: float):
    """Each array within ``tol`` of its largest magnitude (one whose
    largest magnitude is below 1e-6 of the largest of all within 1e-6 of
    that largest)."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = np.asarray(got[name], np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        if scale < 1e-6 * top:
            assert err <= 1e-6 * top, name
        else:
            assert err <= tol * scale, (name, err / scale)


def _prefixed(z, prefix: str) -> dict:
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


@pytest.mark.parametrize("name", ORACLE)
def test_sharded_loss_matches_the_reference(runs, name):
    """Every rank's loss (the global mean) and metrics against the
    reference's sharded ``loss_fn``; the token count (ignored labels
    differ by rank) exactly."""
    z = np.load(runs / f"{name}.npz")
    for got in _ranks(runs, name):
        np.testing.assert_allclose(float(got["loss"]), float(z["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(got["metric.tokens"]) == float(z["metric.tokens"])
        for k in ("nll", "moe_aux", "moe_drop"):
            if f"metric.{k}" in z.files:
                np.testing.assert_allclose(float(got[f"metric.{k}"]),
                                           float(z[f"metric.{k}"]),
                                           rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("name", ORACLE)
def test_sharded_gradients_match_the_reference(runs, name):
    """The rank's gradient blocks gathered whole: every leaf within 1e-4
    of its largest magnitude (FSDP's reduce-scatter, the leaves whole over
    "data" summed once, the split heads' and vocab's collectives)."""
    z = np.load(runs / f"{name}.npz")
    want = _by_port_name(z, "grad.", CASES[name]["arch"])
    got = _prefixed(_ranks(runs, name)[0], "grad.")
    _assert_each_within(got, want, GRAD_TOL)


@pytest.mark.parametrize("name", ORACLE)
def test_step_norms_match_the_reference(runs, name):
    """One ``make_train_step`` step's loss, ``grad_norm`` and
    ``param_norm`` (the sharded global norms) against the reference's
    jitted, donated step; the AdamW's norms on the reference's
    gradients against its ``apply_updates``'."""
    z = np.load(runs / f"{name}.npz")
    for got in _ranks(runs, name):
        np.testing.assert_allclose(float(got["step.loss"]),
                                   float(z["step.loss"]), rtol=LOSS_RTOL)
        for k in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(float(got[f"step.{k}"]),
                                       float(z[f"step.{k}"]), rtol=NORM_RTOL)
            np.testing.assert_allclose(float(got[f"adam.{k}"]),
                                       float(z[f"adam.{k}"]), rtol=NORM_RTOL)


@pytest.mark.parametrize("name", ORACLE)
def test_sharded_adamw_matches_the_reference(runs, name):
    """The sharded AdamW (ZeRO-1 moments: the norms' scales cut over
    "data") on the reference's gradients: the parameters and moments
    gathered whole against the reference's ``apply_updates`` under
    ``zero1_specs``."""
    z = np.load(runs / f"{name}.npz")
    got = _ranks(runs, name)[0]
    arch = CASES[name]["arch"]
    for part in ("param", "mu", "nu"):
        want = _by_port_name(z, f"adam.{part}.", arch)
        mine = _prefixed(got, f"adam.{part}.")
        assert set(mine) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(mine[k], w, rtol=ADAM_TOL,
                                       atol=ADAM_TOL, err_msg=f"{part} {k}")


def test_bf16_sharded_step_matches_one_rank(runs):
    """qwen3 bf16 at (2, 2): the loss and every gradient against the
    port's own one-rank bf16 step on the same weights and batch (the
    reference's bf16 dots do not run under ``jit`` on this CPU)."""
    got = _ranks(runs, "qwen3_bf16_dp2_tp2")[0]
    assert abs(float(got["loss"]) / float(got["one.loss"]) - 1) <= BF16_TOL
    _assert_each_within(_prefixed(got, "grad."), _prefixed(got, "one.grad."),
                        BF16_TOL)


def test_serve_weight_fsdp_matches_the_reference(runs):
    """qwen3 served with its weights split over "data" too (the FSDP
    gathers in the forward): the prefill's and the decode steps' logits
    against the reference's sharded serving under the same rules; the
    drawn blocks are the unsharded draw's."""
    want = np.load(runs / "qwen3_serve_fsdp.npz")["logits"]
    for got in _ranks(runs, "qwen3_serve_fsdp"):
        assert got["logits"].shape == want.shape
        err = np.abs(got["logits"] - want).max() / np.abs(want).max()
        assert err <= LOGITS_TOL, err
        assert bool(got["blocks_equal"]) and bool(got["gathered_equal"])


def test_elastic_checkpoints_restore_under_any_mesh(runs):
    """A one-rank checkpoint restored under (2, 2), and the one (2, 2)
    saved restored under (4, 1) and under one rank: every leaf, moments
    and step included, bit for bit (the stored arrays are whole)."""
    from repro_torch.train.checkpoint import Checkpointer, _flatten
    for shape, ranks in (("2x2", 4), ("4x1", 4)):
        for r in range(ranks):
            z = np.load(runs / f"port_elastic_{shape}_r{r}.npz")
            assert bool(z["restored_equal"]) and int(z["step"]) == 1
    one = Checkpointer(str(runs / "elastic_one"))
    again = Checkpointer(str(runs / "elastic_22"))
    a = _flatten(one.restore(_template(one))[0])
    b = _flatten(again.restore(_template(again))[0])
    assert set(a) == set(b) and len(a) > 3
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _template(ckpt) -> dict:
    """A template of the stored state's own shapes and dtypes."""
    import json

    from repro_torch.train.checkpoint import SEP
    name = f"step_{ckpt.latest_step():09d}"
    with open(os.path.join(ckpt.dir, name, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    out: dict = {}
    with np.load(os.path.join(ckpt.dir, name, "arrays.npz")) as z:
        for key in z.files:
            node = out
            *path, leaf = key.split(SEP)
            for p in path:
                node = node.setdefault(p, {})
            dt = getattr(torch, dtypes[key].split(".")[-1])
            node[leaf] = torch.empty(z[key].shape, dtype=dt)
    return out


def test_recovery_under_a_mesh_is_bit_exact(runs):
    """``train_loop`` under (2, 2), a fault injected at step 2 on every
    rank: every rank restores step 2's elastic checkpoint together and
    ends with the clean sharded run's state, every block bit for bit, and
    its losses."""
    for r in range(4):
        z = np.load(runs / f"port_elastic_2x2_r{r}.npz")
        assert int(z["recovery_failures"]) == 1
        assert bool(z["recovery_equal"])
        clean, faulty = z["recovery_losses"]
        assert list(clean) == list(faulty) and len(clean) == 4


def test_launcher_trains_under_torchrun(tmp_path):
    """``launch.train`` under ``torchrun``, 4 gloo ranks at
    ``--model-parallel 2`` ((2, 2)): it prints the mesh, the collectives a
    step (FSDP's reduce-scatters among them) and ms/step, and its losses
    match the one-rank launcher's within 2e-5."""
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
            "--smoke", "--device", "cpu", "--steps", "3", "--seq-len",
            "16", "--global-batch", "4"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    four = _start([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", "4", *args,
                   "--backend", "gloo", "--model-parallel", "2",
                   "--ckpt-dir", str(tmp_path / "four")], env)
    one = _start([sys.executable, *args, "--ckpt-dir",
                  str(tmp_path / "one")], env)
    four = _finish(four, "torchrun", LAUNCH_TIMEOUT_S)
    one = _finish(one, "one rank", LAUNCH_TIMEOUT_S)
    assert four.returncode == 0, four.stderr[-4000:]
    assert one.returncode == 0, one.stderr[-4000:]
    assert "mesh {'data': 2, 'model': 2} over 4 rank(s), backend gloo" in (
        four.stdout)
    assert "ms/step" in four.stdout
    line = next(l for l in four.stdout.splitlines()
                if "[train] collectives a step" in l)
    assert "'reduce_scatter': 16" in line, line
    assert four.stdout.count("[train] done: 3 steps") == 1   # rank 0 prints
    np.testing.assert_allclose(_losses(four.stdout), _losses(one.stdout),
                               rtol=LOSS_RTOL)


def _losses(stdout: str) -> list:
    line = next(l for l in stdout.splitlines() if l.startswith(
        "[train] losses "))
    return [float(x) for x in line[len("[train] losses "):].strip(
        "[]").split(",")]


def _abstract_rules(mode="train", **kw):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import make_rules
    mesh = mesh_lib.Mesh(("data", "model"), (2, 2))
    return make_rules(mesh, mode=mode, multi_pod=False, **kw)


@pytest.mark.parametrize("kind", ("topk", "int8"))
def test_compression_under_a_mesh_refuses(kind):
    """No longer refused (4.3.3.2): under a mesh the step is made, its
    compressors the whole tensors' (``optim/compress.py``; held against
    the reference by ``tests/test_torch_tp_compress.py``), and the state
    carries the error of each rank's blocks."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.sharding.rules import use_rules
    from repro_torch.train import train_step as TS
    cfg = get_config("qwen3-1.7b", smoke=True)
    tcfg = TS.TrainConfig(compression=CompressionConfig(kind=kind))
    with use_rules(_abstract_rules()):
        model = T.init_params(cfg, device="cpu")
        assert callable(TS.make_train_step(model, tcfg))
        state = TS.init_train_state(model, tcfg)
    assert {n: e.shape for n, e in state["err"].items()} == {
        n: p.shape for n, p in state["params"].items()}


def test_state_layout_cuts_the_norms_moments_over_data():
    """ZeRO-1 at (2, 2) on qwen3's smoke config: the moments of the 1-D
    norm scales (whole in ``param_specs``) are cut over "data"; every 2-D
    weight's already is, so its moments are its blocks."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import train_layout
    layout = train_layout(T.whole_shapes(get_config("qwen3-1.7b",
                                                    smoke=True)),
                          _abstract_rules())
    cut = sorted(n for n in layout.params if layout.zero1_dim(n) is not None)
    assert cut and all(n.endswith("scale") for n in cut)
    assert "ln_final.scale" in cut and "blocks.0.attn.q_norm.scale" in cut
    assert layout.params["blocks.0.attn.w_q.w"] == ("data", "model")
    assert layout.params["embedding.table"] == ("model", "data")
