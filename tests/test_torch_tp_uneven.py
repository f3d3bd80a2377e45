"""Sharded training on batches that do not split evenly, on the CPU: the
port's gloo ranks against the reference's sharded training, as
``tests/test_torch_tp_train.py`` holds the even cases (its helpers and
tolerances), over the cases of ``_torch_tp_cases.UNEVEN_TRAIN_CASES``:

* command-r at (4, 1), 12 rows in 2 microbatches of 6: rows that do not
  divide over "data" in a microbatch;
* qwen3 at (2, 2), 5 rows;
* qwen3-moe at (1, 4), 12 x 42: a MoE layer whose 42 positions do not
  divide over "model", so every model rank routes all the tokens of its
  rows (the reference's ``seq_spec`` None);
* qwen3-moe at (2, 2), 9 x 41: both at once.  The reference's MoE
  ``shard_map`` refuses 9 rows over 2 data ranks, so its oracle runs the
  case at (1, 2): with the rows replicated over "data", each data rank of
  the port computes what a (1, 2) model rank computes.

The port replicates rows that do not divide over the batch axes
(``sharding.rules.act_spec``) and counts each in one rank's share of the
loss (``own_rows``); the reference's partitioner pads them instead.  Each
case: every rank's loss and token count, every gathered gradient, one
step's ``grad_norm`` / ``param_norm``, and the sharded AdamW on the
reference's gradients.  qwen3's table gradient at 5 rows is held against
the reference's one-device gradient (``whole_grads``): its sharded one
scatters the pad row into row 0.
"""
import sys
import time

import numpy as np
import pytest
import torch

import _torch_tp_cases as C
from test_torch_tp_train import (ADAM_TOL, GRAD_TOL, HERE, LOSS_RTOL,
                                 NORM_RTOL, ORACLE_TIMEOUT_S,
                                 WORLD_TIMEOUT_S, _assert_each_within,
                                 _by_port_name, _finish, _prefixed, _start)

SUITE = "UNEVEN_TRAIN_CASES"
CASES = C.UNEVEN_TRAIN_CASES
NAMES = list(CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results (one process, every case)
    and the port's (one world of four ranks that runs the meshes (4, 1),
    (2, 2) and (1, 4) in turn)."""
    d = tmp_path_factory.mktemp("tp_uneven")
    t0 = time.monotonic()
    cmd = [sys.executable, str(HERE / "_torch_tp_oracle.py"), "--cases",
           SUITE, str(d)]
    res = _finish(_start(cmd), cmd, ORACLE_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    models = sorted({tp for _, tp in C.meshes(CASES)})
    assert all(dp * tp == 4 for dp, tp in C.meshes(CASES))
    cmd = [sys.executable, str(HERE / "_torch_tp_world.py"), "--cases",
           SUITE, "--data", str(4 // models[0]), "--model",
           ",".join(map(str, models)), str(d)]
    res = _finish(_start(cmd), cmd, WORLD_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    print(f"[tp_uneven] oracle and world: {time.monotonic() - t0:.1f} s")
    return d


def _ranks(d, name):
    dp, tp = CASES[name]["mesh"]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(dp * tp)]


def test_the_cases_do_not_split():
    """Each case has rows (of a microbatch) that do not divide over
    "data" or, at a MoE layer, positions that do not divide over
    "model"."""
    for case in CASES.values():
        (b, s), (dp, tp) = C.batch_shape(case), case["mesh"]
        rows = b // case.get("microbatches", 1)
        moe = "moe" in case["arch"]
        assert (dp > 1 and rows % dp) or (moe and tp > 1 and s % tp)


@pytest.mark.parametrize("name", NAMES)
def test_uneven_loss_matches_the_reference(runs, name):
    """Every rank's loss (the global mean), NLL and the MoE's aux loss and
    drop fraction against the reference's sharded ``loss_fn``; the token
    count exactly (each row counted once)."""
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


@pytest.mark.parametrize("name", NAMES)
def test_uneven_gradients_match_the_reference(runs, name):
    """The rank's gradient blocks gathered whole: every leaf within 1e-4
    of its largest magnitude, no row counted twice by FSDP's
    reduce-scatter or the sums over "data"; the router's, the experts'
    and the input's through the unsplit MoE (each rank's routing taking
    its share of the output's gradient)."""
    case = CASES[name]
    z = np.load(runs / f"{name}.npz")
    want = _by_port_name(z, "grad.", case["arch"])
    if case.get("whole_grads"):
        whole = _by_port_name(z, "whole.grad.", case["arch"])
        want.update({k: whole[k] for k in case["whole_grads"]})
    got = _prefixed(_ranks(runs, name)[0], "grad.")
    _assert_each_within(got, want, GRAD_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_uneven_step_norms_match_the_reference(runs, name):
    """One ``make_train_step`` step's loss, ``grad_norm`` and
    ``param_norm`` against the reference's jitted, donated step; the
    AdamW's norms on the reference's gradients against its
    ``apply_updates``'."""
    z = np.load(runs / f"{name}.npz")
    for got in _ranks(runs, name):
        np.testing.assert_allclose(float(got["step.loss"]),
                                   float(z["step.loss"]), rtol=LOSS_RTOL)
        for k in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(float(got[f"step.{k}"]),
                                       float(z[f"step.{k}"]), rtol=NORM_RTOL)
            np.testing.assert_allclose(float(got[f"adam.{k}"]),
                                       float(z[f"adam.{k}"]), rtol=NORM_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_uneven_adamw_matches_the_reference(runs, name):
    """The sharded AdamW on the reference's gradients: the parameters and
    moments gathered whole against the reference's ``apply_updates``."""
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


def _rules(mesh_shape):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import make_rules
    mesh = mesh_lib.Mesh(("data", "model"), mesh_shape)
    return make_rules(mesh, mode="train", multi_pod=False)


@pytest.mark.parametrize("rows", (5, 6, 8))
def test_rows_split_where_they_divide_and_count_once(rows, monkeypatch):
    """Under (4, 1): 8 rows split 2 a rank; 5 or 6 stay whole on every
    rank, and the ranks' shares of the labels (blocks of ceil(B / 4), the
    last short or empty) cover each row once."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import rules as R
    rules = _rules((4, 1))
    labels = torch.arange(rows * 3).reshape(rows, 3)
    counted = torch.zeros(rows, dtype=torch.long)
    for coord in range(4):
        monkeypatch.setattr(mesh_lib.Mesh, "coords", property(
            lambda self, c=coord: {"data": c, "model": 0}))
        with R.use_rules(rules):
            mine = R.shard_act(labels, "tokens")
            if rows % 4 == 0:
                assert torch.equal(mine, labels[2 * coord:2 * coord + 2])
                assert torch.equal(R.own_rows(labels), mine)
                continue
            assert torch.equal(mine, labels)
            own = R.own_rows(labels)
            kept = (own >= 0).all(1)
            assert ((own < 0).all(1) | kept).all()
            assert torch.equal(own[kept], labels[kept])
            counted += kept.long()
    if rows % 4:
        assert counted.tolist() == [1] * rows
