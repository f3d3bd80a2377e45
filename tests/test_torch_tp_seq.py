"""Sequence-parallel activations under a mesh on the CPU: the port's gloo
ranks with ``seq_axis="model"`` (``make_rules(seq_parallel=True)``)
against the reference's sharded ``value_and_grad`` under the same rules,
as ``tests/test_torch_tp_train.py`` holds sharded training (its helpers
and tolerances).

Under GSPMD the reference's ``seq_axis`` is a layout (the "btd" residual
stream's sequence split over "model" where it divides), so its numbers
are those without it; the port's is Megatron's sequence parallelism: each
rank holds its block of the residual's sequence, gathers the normed block
before the column-parallel projections and reduce-scatters the
row-parallel outputs where it would all-reduce them.

The reference runs every case of ``_torch_tp_cases.SEQ_CASES`` in two
subprocesses side by side (``_torch_tp_oracle.py``: four forced host
devices, the train rules with ``seq_parallel``, ``grads_only``: its loss
and gradients); the port in two spawned worlds side by side
(``_torch_tp_world.py``): two ranks for (1, 2), four for (1, 4) and then
(2, 2).  The cases, smoke configs in fp32 on 8 x 32 tokens: qwen3 at (1, 2)
and (2, 2), smollm at (1, 4), qwen3-moe at (1, 2) (the MoE routing the
rank's block of the sequence as it arrives), hymba (8 meta tokens and 32
positions: 40 divide), xLSTM and whisper (its encoder's 24 frames too)
at (1, 2) at the widths of ``RECURRENT_CASES``, and qwen3 at (1, 4) on 30
positions, which do not divide, so the stream stays whole.  Besides: the
collectives of the gradients with and without sequence parallelism, the
prefill and decode steps of hymba at (1, 4) and whisper at (1, 2) under
the serving rules with and without it, and the launchers under
``torchrun`` with ``--seq-parallel``.

Bounds: the loss within ``LOSS_RTOL``, every gathered gradient within
``GRAD_TOL`` of its largest magnitude (``test_torch_tp_train.py``'s); the
prefill's logits and caches within ``SELF_TOL`` of the prefill without
sequence parallelism (gloo's sums over four ranks may take another
order).  Every subprocess runs under a timeout.
"""
import dataclasses
import sys
import time

import _torch_threads  # noqa: F401
import numpy as np
import pytest

import _torch_tp_cases as C
from test_torch_tp_serve import SELF_TOL, _rel
from test_torch_tp_train import (GRAD_TOL, HERE, LAUNCH_TIMEOUT_S, LOSS_RTOL,
                                 ORACLE_TIMEOUT_S, ROOT, WORLD_TIMEOUT_S,
                                 _assert_each_within, _by_port_name,
                                 _finish, _losses, _prefixed, _start)
from _torch_tp_world import TRAIN_OPS

SUITE = "SEQ_CASES"
CASES = C.SEQ_CASES
ORACLE = [n for n, c in CASES.items() if c.get("oracle", True)]
SERVE = [n for n, c in CASES.items() if c.get("sp_serve")]
#: The worlds: (data, model axis sizes in turn), each over the same ranks.
WORLDS = ((1, "2"), (1, "4,2"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results (two processes side by
    side) and the port's (the two worlds, side by side)."""
    d = tmp_path_factory.mktemp("tp_seq")
    t0 = time.monotonic()
    names = list(CASES)
    oracles = []
    for part in (names[0::2], names[1::2]):
        cmd = [sys.executable, str(HERE / "_torch_tp_oracle.py"), "--cases",
               SUITE, str(d), *part]
        oracles.append((cmd, _start(cmd)))
    for cmd, p in oracles:
        res = _finish(p, cmd, ORACLE_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
    t1 = time.monotonic()
    worlds = []
    for data, models in WORLDS:
        cmd = [sys.executable, str(HERE / "_torch_tp_world.py"), "--cases",
               SUITE, "--data", str(data), "--model", models, str(d)]
        worlds.append((cmd, _start(cmd)))
    for cmd, p in worlds:
        res = _finish(p, cmd, WORLD_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
    print(f"[tp_seq] oracle {t1 - t0:.1f} s, worlds "
          f"{time.monotonic() - t1:.1f} s")
    return d


def _ranks(d, name):
    dp, tp = CASES[name]["mesh"]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(dp * tp)]


def _config(name):
    from repro_torch.configs.registry import get_config
    case = CASES[name]
    return C.config(get_config(case["arch"], smoke=True), case)


def _splits(name) -> bool:
    """Whether the case's residual stream divides over its model axis."""
    cfg, case = _config(name), CASES[name]
    total = C.batch_shape(case)[1] + (cfg.meta_tokens or 0)
    return total % case["mesh"][1] == 0


def test_the_worlds_cover_the_cases():
    run = {(data * int(m.split(",")[0]) // int(t), int(t))
           for data, m in WORLDS for t in m.split(",")}
    assert set(C.meshes(CASES)) <= run
    assert {CASES[n]["arch"] for n in ORACLE} >= {
        "qwen3-1.7b", "smollm-360m", "qwen3-moe-235b-a22b", "hymba-1.5b",
        "xlstm-125m", "whisper-small"}
    assert [n for n in ORACLE if not _splits(n)] == ["qwen3_sp_s30_tp4"]


@pytest.mark.parametrize("name", ORACLE)
def test_sequence_parallel_loss_matches_the_reference(runs, name):
    """Every rank's loss (the global mean) and NLL against the reference's
    sharded ``loss_fn`` under ``seq_axis="model"``; the token count
    exactly; a MoE's auxiliary metrics too."""
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
def test_sequence_parallel_gradients_match_the_reference(runs, name):
    """The rank's gradient blocks gathered whole (fused projections part
    by part): every leaf within 1e-4 of its largest magnitude, the norms'
    scales (applied to the rank's block of the sequence, their gradients'
    parts summed over "model") among them."""
    z = np.load(runs / f"{name}.npz")
    want = _by_port_name(z, "grad.", CASES[name]["arch"])
    for got in _ranks(runs, name)[:2]:
        _assert_each_within(_prefixed(got, "grad."), want, GRAD_TOL)


@pytest.mark.parametrize("name", ORACLE)
def test_row_parallel_outputs_reduce_scatter(runs, name):
    """The collectives of the gradients against the same model's without
    sequence parallelism: where the stream divides, at least a
    row-parallel output a layer reduce-scatters (its backward a gather)
    and the normed blocks' gathers reduce-scatter their gradients (the
    forward's all_reduces that became reduce-scatters are counted on
    their own by the prefill's test: the backward adds the norms' scale
    sums); where it does not, the collectives are those without it."""
    cfg = _config(name)
    layers = cfg.n_layers + (cfg.encdec.n_enc_layers if cfg.encdec else 0)
    ops = dict(zip(TRAIN_OPS, range(len(TRAIN_OPS))))
    for got in _ranks(runs, name):
        sp, whole = got["grad_collectives"], got["whole_grad_collectives"]
        if not _splits(name):
            assert list(sp) == list(whole)
            continue
        assert (sp[ops["reduce_scatter"]] - whole[ops["reduce_scatter"]]
                >= 2 * layers)
        assert (sp[ops["all_gather"]] - whole[ops["all_gather"]]
                >= 2 * layers)


@pytest.mark.parametrize("name", SERVE)
def test_sequence_parallel_prefill_equals_the_whole_prefill(runs, name):
    """The prefill under the serving rules with ``seq_parallel`` against
    the same weights' prefill without it: the logits of the prefill and
    of the decode steps after it, and every cache leaf (the attention's
    K/V slots, the Mamba's or the encoder's), within ``SELF_TOL``; every
    row-parallel output's all_reduce of the prefill is a reduce-scatter
    under sequence parallelism (the Mamba's ``w_dt``, whose output feeds
    the scan, keeps its all_reduce)."""
    for got in _ranks(runs, name):
        assert _rel(got["sp.logits"], got["whole.logits"]) <= SELF_TOL
        names = [k[len("whole.cache."):] for k in got.files
                 if k.startswith("whole.cache.")]
        assert names and {f"sp.cache.{k}" for k in names} == {
            k for k in got.files if k.startswith("sp.cache.")}
        for k in names:
            want = got[f"whole.cache.{k}"]
            err = np.abs(got[f"sp.cache.{k}"] - want).max()
            assert err <= SELF_TOL * max(np.abs(want).max(), 1.0), k
        ops = dict(zip(TRAIN_OPS, range(len(TRAIN_OPS))))
        sp, whole = got["sp.prefill_collectives"], got[
            "whole.prefill_collectives"]
        assert whole[ops["reduce_scatter"]] == 0
        assert sp[ops["reduce_scatter"]] >= _config(name).n_layers
        assert (whole[ops["all_reduce"]] - sp[ops["all_reduce"]]
                == sp[ops["reduce_scatter"]])


def test_seq_axis_other_than_the_model_axis_raises():
    """The port's sequence parallelism runs over the model axis, the only
    one the reference's ``make_rules`` names."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.configs.registry import get_config
    rules = dataclasses.replace(make_rules(
        mesh_lib.Mesh(("data", "model"), (2, 2)), mode="train",
        multi_pod=False), seq_axis="data")
    with pytest.raises(ValueError, match="model axis"):
        T.check_mesh(get_config("qwen3-1.7b", smoke=True), rules)
    T.check_mesh(get_config("qwen3-1.7b", smoke=True),
                 dataclasses.replace(rules, seq_axis="model"))


def test_launchers_take_seq_parallel_under_torchrun(tmp_path):
    """``launch.train --seq-parallel`` under ``torchrun`` (2 gloo ranks,
    (1, 2)): its losses match the same launch without it within 2e-5;
    ``launch.serve --seq-parallel`` serves hymba at (1, 2) and prints
    the tokens of the launch without it."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2"]
    train = ["-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
             "--smoke", "--device", "cpu", "--steps", "3", "--seq-len",
             "16", "--global-batch", "4", "--backend", "gloo",
             "--model-parallel", "2", "--ckpt-every", "0"]
    serve = ["-m", "repro_torch.launch.serve", "--arch", "hymba-1.5b",
             "--smoke", "--device", "cpu", "--prompt-len", "24",
             "--max-len", "40", "--gen", "4", "--model-parallel", "2"]
    procs = {}
    for tag, args in (("train_sp", train + ["--seq-parallel"]),
                      ("train", train),
                      ("serve_sp", serve + ["--seq-parallel"]),
                      ("serve", serve)):
        extra = (["--ckpt-dir", str(tmp_path / tag)]
                 if tag.startswith("train") else [])
        procs[tag] = _start([*run, *args, *extra], env)
    res = {tag: _finish(p, tag, LAUNCH_TIMEOUT_S) for tag, p in procs.items()}
    for tag, r in res.items():
        assert r.returncode == 0, (tag, r.stderr[-4000:])
    np.testing.assert_allclose(_losses(res["train_sp"].stdout),
                               _losses(res["train"].stdout), rtol=LOSS_RTOL)
    line = next(l for l in res["train_sp"].stdout.splitlines()
                if "[train] collectives a step" in l)
    assert "'reduce_scatter': 0" not in line, line

    def tokens(out):
        return next(l for l in out.splitlines() if "sample tokens" in l)
    assert tokens(res["serve_sp"].stdout) == tokens(res["serve"].stdout)
