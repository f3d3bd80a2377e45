"""Gradient compression under a mesh on the CPU: the port's gloo ranks
compressing their reduced gradient blocks as the whole tensors' against
the reference, whose compressors see the global gradient under GSPMD
(``repro/optim/compress.py``): top-k keeps the whole tensor's top
``topk_frac`` (ties to the lower flat index, as ``lax.top_k``) and int8
scales by its max.  The reference's tensor is a stack of a layer
variant's leaf over its layers, so the port compresses each stack
(``transformer.param_stacks``) as one.

The reference runs every case of ``_torch_tp_cases.COMPRESS_CASES`` in one
subprocess (``_torch_tp_oracle.py``, ``step_only``: one jitted, donated
``make_train_step`` with top-k, its metrics and its state after it); the
port in one spawned world of four gloo ranks (``_torch_tp_world.py``:
(4, 1), then (2, 2), then (1, 4)), which also cuts whole gradients and
errors (``_torch_tp_cases.compress_inputs``) into each rank's blocks and
compresses them under the layout (``run_compress_blocks``): qwen3, whose
MLP gate is split over both axes at (2, 2), and hymba, whose fused
``w_in`` is cut part by part, each with a stack whose top-k threshold is
a tie.

Bounds: the step's loss, norms and parameters within ``STEP_TOL`` of the
reference's, its kept set equal but for entries within ``STEP_TOL`` of
the threshold; the compressed blocks gathered bit for bit the reference's
top-k of the whole stacks and one rank's int8 of them; every rank's
error the residual bit for bit.  Every subprocess runs under a timeout.
"""
import os
import sys
import time

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import _torch_tp_cases as C
from test_torch_tp_train import (HERE, LAUNCH_TIMEOUT_S, ORACLE_TIMEOUT_S,
                                 ROOT, WORLD_TIMEOUT_S, _by_port_name,
                                 _finish, _losses, _prefixed, _start)

SUITE = "COMPRESS_CASES"
CASES = C.COMPRESS_CASES
STEP_TOL = 1e-6
#: The meshes of the world, and of its compressed blocks.
MESHES = ("4x1", "2x2", "1x4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results and the port's world's."""
    d = tmp_path_factory.mktemp("tp_compress")
    t0 = time.monotonic()
    cmd = [sys.executable, str(HERE / "_torch_tp_oracle.py"), "--cases",
           SUITE, str(d)]
    res = _finish(_start(cmd), cmd, ORACLE_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    t1 = time.monotonic()
    cmd = [sys.executable, str(HERE / "_torch_tp_world.py"), "--cases",
           SUITE, "--data", "4", "--model", "1,2,4", str(d)]
    res = _finish(_start(cmd), cmd, WORLD_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    print(f"[tp_compress] oracle {t1 - t0:.1f} s, world "
          f"{time.monotonic() - t1:.1f} s")
    return d


def _ranks(d, name):
    dp, tp = CASES[name]["mesh"]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(dp * tp)]


def test_the_cases_cover_the_meshes():
    assert sorted(c["mesh"] for c in CASES.values()) == [(1, 4), (2, 2),
                                                         (4, 1)]
    assert {c["compression"] for c in CASES.values()} == {"topk"}


@pytest.mark.parametrize("name", list(CASES))
def test_topk_step_matches_the_reference(runs, name):
    """One step with top-k under the mesh against the reference's jitted,
    donated step: the loss, ``grad_norm`` (of the compressed gradient) and
    ``param_norm``, and every parameter after AdamW, on every rank."""
    z = np.load(runs / f"{name}.npz")
    want = _by_port_name(z, "step.param.", CASES[name]["arch"])
    for got in _ranks(runs, name):
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(got[f"step.{k}"]),
                                       float(z[f"step.{k}"]), rtol=STEP_TOL)
        mine = _prefixed(got, "step.param.")
        assert set(mine) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(mine[k], w, rtol=0, atol=STEP_TOL,
                                       err_msg=k)


def test_one_card_topk_step_matches_the_reference(runs):
    """The same step on one device (no mesh: a one-card ``launch.train``)
    compresses the whole stacks too: its loss, norms and parameters
    within ``STEP_TOL`` of the reference's step (compressing each layer
    alone keeps another set and moves ``grad_norm`` by percents)."""
    import _torch_tp_world as W
    from repro_torch.configs.registry import get_config
    from repro_torch.train import train_step as TS
    name = "qwen3_topk_dp4"
    case = CASES[name]
    z = np.load(runs / f"{name}.npz")
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    params = C.unflatten({k[len("param."):]: z[k] for k in z.files
                          if k.startswith("param.")})
    batch = {k: torch.from_numpy(z[k]).long() for k in ("tokens", "labels")}
    model = W._train_model(cfg, params, None)
    tcfg = W._tcfg(1, "topk")
    new, m = TS.make_train_step(model, tcfg)(
        TS.init_train_state(model, tcfg), batch)
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(float(m[k]), float(z[f"step.{k}"]),
                                   rtol=STEP_TOL)
    want = _by_port_name(z, "step.param.", case["arch"])
    assert set(new["params"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(new["params"][k].numpy(), w, rtol=0,
                                   atol=STEP_TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_topk_kept_set_matches_the_reference(runs, name):
    """The entries top-k kept (a zero error after the step, from zero
    errors) are the reference's, but for any within ``STEP_TOL`` of its
    stack's threshold (the largest magnitude it dropped); the error of
    every dropped entry is the reference's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    arch = CASES[name]["arch"]
    want = _by_port_name(np.load(runs / f"{name}.npz"), "step.err.", arch)
    period = len(T.model_pattern(get_config(arch, smoke=True)))
    got = _prefixed(_ranks(runs, name)[0], "step.err.")
    kept = 0
    for names in C.stacks_of(want, period).values():
        w = np.stack([want[n] for n in names])
        g = np.stack([got[n] for n in names])
        threshold = np.abs(w).max()
        moved = (w == 0) != (g == 0)
        assert (np.abs(np.where(w == 0, g, w))[moved]
                >= threshold * (1 - STEP_TOL)).all(), names
        np.testing.assert_allclose(g[~moved], w[~moved], rtol=0,
                                   atol=STEP_TOL, err_msg=str(names))
        kept += int((w == 0).sum())
    assert kept > 0


def _expected(arch: str, kind: str) -> dict:
    """The whole stacks' compression of ``compress_inputs`` by port name:
    top-k the reference's own (``repro.optim.compress`` on the stacked
    arrays), int8 the port's on one rank (its counter-based noise, whose
    bits the reference's threefry draw does not have)."""
    import _torch_tp_world as W
    from repro_torch.models import transformer as T
    from repro_torch.optim import compress as K
    cfg, shapes, _, stacks = W.compress_layout(arch, None)
    period = len(T.model_pattern(cfg))
    whole = C.compress_inputs(shapes, period)
    if kind == "int8":
        c, e = K.compress(
            {n: torch.from_numpy(a) for n, a in whole["grad"].items()},
            {n: torch.from_numpy(a) for n, a in whole["err"].items()},
            K.CompressionConfig(kind=kind, topk_frac=C.TOPK_FRAC),
            key=W.COMPRESS_KEY, stacks=stacks)
        return {n: (c[n].numpy(), e[n].numpy()) for n in c}
    import jax.numpy as jnp
    from repro.optim import compress as JC
    groups = C.stacks_of(shapes, period)
    stacked = {part: {s: jnp.asarray(np.stack([whole[part][n] for n in ns]))
                      for s, ns in groups.items()}
               for part in ("grad", "err")}
    c, e = JC.compress(stacked["grad"], stacked["err"],
                       JC.CompressionConfig(kind="topk",
                                            topk_frac=C.TOPK_FRAC))
    return {n: (np.asarray(c[s])[i], np.asarray(e[s])[i])
            for s, ns in groups.items() for i, n in enumerate(ns)}


@pytest.mark.parametrize("kind", ("topk", "int8"))
@pytest.mark.parametrize("arch", ("qwen3-1.7b", "hymba-1.5b"))
def test_sharded_compress_is_the_whole_stacks(runs, arch, kind):
    """Whole gradients and errors cut into each rank's blocks and
    compressed under the layout, at (4, 1), (2, 2) and (1, 4): the
    compressed gradients and new errors gathered whole on every rank
    (replicas included) are bit for bit the whole stacks' (top-k: the
    reference's; int8: one rank's counter-based draw, so the noise
    depends on no mesh), hymba's fused ``w_in`` and qwen3's gate split on
    both axes among them."""
    want = _expected(arch, kind)
    for mesh in MESHES:
        for r in range(4):
            z = np.load(runs / f"port_compress_{mesh}_r{r}.npz")
            for n, (c, e) in want.items():
                got_c = z[f"{arch}.{kind}.c.{n}"]
                got_e = z[f"{arch}.{kind}.e.{n}"]
                assert np.array_equal(got_c, c), (mesh, r, n)
                assert np.array_equal(got_e, e), (mesh, r, n)


@pytest.mark.parametrize("mesh", MESHES)
def test_error_feedback_holds_on_every_block(runs, mesh):
    """On every rank's blocks the new error is ``g + e_old - c`` bit for
    bit (top-k's also sums back to ``g + e_old`` exactly), and
    ``compress_`` writes ``compress``'s bits into the error in place."""
    for r in range(4):
        z = np.load(runs / f"port_compress_{mesh}_r{r}.npz")
        for arch in ("qwen3-1.7b", "hymba-1.5b"):
            for kind in ("topk", "int8"):
                assert bool(z[f"{arch}.{kind}.residual"]), (arch, kind)
                assert bool(z[f"{arch}.{kind}.in_place"]), (arch, kind)
            assert bool(z[f"{arch}.topk.sums_back"]), arch


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "hymba-1.5b"))
def test_int8_scale_is_the_whole_stacks_max(runs, arch):
    """int8 under the mesh: each stack's compressed entries are integers
    in [-127, 127] times the stack's max magnitude / 127 (the whole
    tensor's scale, not a rank's)."""
    import _torch_tp_world as W
    from repro_torch.models import transformer as T
    cfg, shapes, _, _ = W.compress_layout(arch, None)
    period = len(T.model_pattern(cfg))
    whole = C.compress_inputs(shapes, period)
    z = np.load(runs / "port_compress_2x2_r3.npz")
    for names in C.stacks_of(shapes, period).values():
        g = np.stack([whole["grad"][n] + whole["err"][n] for n in names])
        c = np.stack([z[f"{arch}.int8.c.{n}"] for n in names])
        scale = np.float32(max(np.abs(g).max(), 1e-12)) / np.float32(127)
        q = c / scale
        assert np.abs(q).max() <= 127 + 1e-3, names
        np.testing.assert_allclose(q, np.round(q), atol=1e-3,
                                   err_msg=str(names))


def test_topk_tie_goes_to_the_lower_global_index(runs):
    """A stack whose top-k threshold is a tie (``compress_inputs``' 8
    entries at +-``TIE``, 3 to keep): every mesh keeps the 3 of the
    lowest flat indices of the stacked tensor, as ``lax.top_k`` orders
    ties."""
    import _torch_tp_world as W
    from repro_torch.models import transformer as T
    for arch, stack in zip(("qwen3-1.7b", "hymba-1.5b"), C.TIED_STACKS):
        cfg, shapes, _, _ = W.compress_layout(arch, None)
        names = C.stacks_of(shapes, len(T.model_pattern(cfg)))[stack]
        g = np.stack([C.compress_inputs(
            shapes, len(T.model_pattern(cfg)))["grad"][n]
            for n in names]).reshape(-1)
        tied = np.flatnonzero(np.abs(g) == C.TIE)
        assert len(tied) == 8
        for mesh in MESHES:
            z = np.load(runs / f"port_compress_{mesh}_r0.npz")
            c = np.stack([z[f"{arch}.topk.c.{n}"]
                          for n in names]).reshape(-1)
            assert list(np.flatnonzero(c[tied] != 0)) == [0, 1, 2], mesh


def test_int8_counter_noise_is_unbiased():
    """One rank, the counter-based draw over 256 keys: the mean of the
    compressed gradient is the gradient within a tenth of a step, and the
    error feedback holds."""
    from repro_torch.optim import compress as K
    g = {"w": torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (16, 32)).astype(np.float32))}
    e = K.init_error(g)
    cfg = K.CompressionConfig(kind="int8")
    samples = []
    for key in range(256):
        c, e_new = K.compress(g, e, cfg, key=key)
        assert torch.equal(e_new["w"], g["w"] - c["w"])
        samples.append(c["w"].numpy())
    step = float(g["w"].abs().max()) / 127
    assert np.abs(np.mean(samples, 0) - g["w"].numpy()).max() < 0.1 * step
    again, _ = K.compress(g, e, cfg, key=3)
    assert np.array_equal(again["w"].numpy(), samples[3])


def test_launcher_compresses_under_torchrun(tmp_path):
    """``launch.train --compress topk`` (4 gloo ranks, (2, 2)) and
    ``--compress int8`` (2 ranks, (1, 2)) under ``torchrun``: each trains
    its 3 steps to finite losses."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    base = ["-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
            "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4", "--backend", "gloo", "--model-parallel",
            "2", "--ckpt-every", "0"]
    procs = {}
    for kind, ranks in (("topk", 4), ("int8", 2)):
        procs[kind] = _start([sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc-per-node", str(ranks),
                              *base, "--compress", kind, "--ckpt-dir",
                              str(tmp_path / kind)], env)
    for kind, p in procs.items():
        res = _finish(p, kind, LAUNCH_TIMEOUT_S)
        assert res.returncode == 0, (kind, res.stderr[-4000:])
        losses = _losses(res.stdout)
        assert len(losses) == 3 and np.isfinite(losses).all(), kind


def test_bench_compress_runs_under_torchrun():
    """``bench_compress.py`` (4 gloo ranks on the CPU, (4, 1), the smoke
    config): one line a kind with every rank's figures; device memory is
    not measured on the CPU."""
    import json
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4",
           str(ROOT / "src" / "repro_torch" / "bench_compress.py"),
           "--smoke", "--device", "cpu", "--backend", "gloo", "--reps", "1"]
    res = _finish(_start(cmd, env), "bench_compress", LAUNCH_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(l) for l in res.stdout.splitlines()
             if l.startswith("{")]
    assert [l["kind"] for l in lines] == ["topk", "int8"]
    for line in lines:
        assert line["mesh"] == {"data": 4, "model": 1}
        assert len(line["ranks"]) == 4
        for rk in line["ranks"]:
            assert rk["entries"] > rk["largest_entries"] > 0
            assert rk["temporaries_bytes"] is None
            assert np.isfinite(rk["ms"])
