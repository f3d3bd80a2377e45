"""Sharded training of the recurrent and encoder-decoder families on the
CPU: hymba, xLSTM and whisper as the port's gloo ranks against the
reference's sharded training on the same mesh, as
``tests/test_torch_tp_train.py`` holds the attention-MLP families (its
helpers and tolerances).

The reference runs every case of ``_torch_tp_cases.RECURRENT_TRAIN_CASES``
in one subprocess (``_torch_tp_oracle.py``: four forced host devices, the
train rules; its sharded ``value_and_grad``, ``apply_updates`` under
``zero1_specs`` and one jitted, donated ``make_train_step``); the port in
two spawned worlds side by side (``_torch_tp_world.py``): two ranks for
(1, 2) and then (2, 1), four for (1, 4) and then (2, 2).  The cases are the
smoke configs in fp32 at the widths of ``RECURRENT_CASES`` (every leaf
the rules split at full width splits there too) on a global batch of 8 x
32 tokens: hymba at (1, 2), (1, 4) and (2, 2) in 2 microbatches (the
Mamba branch over its channels, ``dwconv1d`` and its backward on the
rank's block, the attention over its heads); xLSTM at (1, 4) (a head a
rank) and (2, 2); whisper at (1, 2) and (2, 2) (the encoder and the cross
attention over heads, the frames by batch row).  Besides: a one-layer
hymba bf16 case against the port's own one rank; ``serve_weight_fsdp``
serving of the three families against one rank; the collectives a step;
the ``dwconv1d`` widths of the forward and the backward; the launcher
under ``torchrun``; ``check_mesh`` at full width; and the elastic
checkpoint of a model whose fused projections are cut part by part,
written under (1, 2) and restored under (2, 1) and by one rank.

Bounds as ``test_torch_tp_train.py``'s: the loss within ``LOSS_RTOL``,
every gathered gradient within ``GRAD_TOL`` of its largest magnitude, the
norms within ``NORM_RTOL``, the sharded AdamW within ``ADAM_TOL``; bf16
within ``BF16_TOL``; the served logits within ``SELF_TOL`` of one rank;
the checkpoints bit for bit.  Every subprocess runs under a timeout.
"""
import dataclasses
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

import _torch_tp_cases as C
from test_torch_tp_serve import SELF_TOL, _rel
from test_torch_tp_train import (ADAM_TOL, BF16_TOL, GRAD_TOL, HERE,
                                 LAUNCH_TIMEOUT_S, LOSS_RTOL, NORM_RTOL,
                                 ORACLE_TIMEOUT_S, ROOT, WORLD_TIMEOUT_S,
                                 _assert_each_within, _by_port_name,
                                 _finish, _losses, _prefixed, _start)

SUITE = "RECURRENT_TRAIN_CASES"
CASES = C.RECURRENT_TRAIN_CASES
ORACLE = [n for n, c in CASES.items() if c.get("oracle", True)]
SERVE = [n for n, c in CASES.items() if c.get("serve")]
#: The worlds: (data, model axis sizes in turn), each over the same ranks.
WORLDS = ((1, "2,1"), (1, "4,2"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results (one process, every case)
    and the port's (the two worlds, side by side)."""
    d = tmp_path_factory.mktemp("tp_train_recurrent")
    t0 = time.monotonic()
    cmd = [sys.executable, str(HERE / "_torch_tp_oracle.py"), "--cases",
           SUITE, str(d)]
    res = _finish(_start(cmd), cmd, ORACLE_TIMEOUT_S)
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
    print(f"[tp_train_recurrent] oracle {t1 - t0:.1f} s, worlds "
          f"{time.monotonic() - t1:.1f} s")
    return d


def _ranks(d, name):
    dp, tp = CASES[name]["mesh"]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(dp * tp)]


def _config(name):
    from repro_torch.configs.registry import get_config
    case = CASES[name]
    return C.config(get_config(case["arch"], smoke=True), case)


def test_the_worlds_cover_the_cases():
    """Every case's mesh is one the worlds run, and the checkpoint's two."""
    run = {(data * int(m.split(",")[0]) // int(t), int(t))
           for data, m in WORLDS for t in m.split(",")}
    assert set(C.meshes(CASES)) <= run and {(1, 2), (2, 1)} <= run


@pytest.mark.parametrize("name", ORACLE)
def test_recurrent_sharded_loss_matches_the_reference(runs, name):
    """Every rank's loss (the global mean) and NLL against the reference's
    sharded ``loss_fn``; the token count exactly."""
    z = np.load(runs / f"{name}.npz")
    for got in _ranks(runs, name):
        np.testing.assert_allclose(float(got["loss"]), float(z["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(got["metric.tokens"]) == float(z["metric.tokens"])
        np.testing.assert_allclose(float(got["metric.nll"]),
                                   float(z["metric.nll"]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ORACLE)
def test_recurrent_sharded_gradients_match_the_reference(runs, name):
    """The rank's gradient blocks gathered whole (the fused projections
    part by part): every leaf within 1e-4 of its largest magnitude, the
    Mamba's ``conv``, ``a_log``, ``d_skip``, ``dt_bias``, the sLSTM's
    ``r``, the meta tokens and ``enc_pos`` among them."""
    z = np.load(runs / f"{name}.npz")
    want = _by_port_name(z, "grad.", CASES[name]["arch"])
    for got in _ranks(runs, name)[:1]:
        _assert_each_within(_prefixed(got, "grad."), want, GRAD_TOL)


@pytest.mark.parametrize("name", ORACLE)
def test_recurrent_step_norms_match_the_reference(runs, name):
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


@pytest.mark.parametrize("name", ORACLE)
def test_recurrent_sharded_adamw_matches_the_reference(runs, name):
    """The sharded AdamW on the reference's gradients: the parameters and
    ZeRO-1 moments gathered whole (part by part) against the reference's
    ``apply_updates`` under ``zero1_specs``."""
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


def test_bf16_recurrent_sharded_step_matches_one_rank(runs):
    """hymba bf16 at (2, 2), one layer: the loss and every gradient
    against the port's own one-rank bf16 step on the same weights and
    batch (the reference's bf16 dots do not run under ``jit`` on this
    CPU)."""
    got = _ranks(runs, "hymba_bf16_dp2_tp2")[0]
    assert abs(float(got["loss"]) / float(got["one.loss"]) - 1) <= BF16_TOL
    _assert_each_within(_prefixed(got, "grad."), _prefixed(got, "one.grad."),
                        BF16_TOL)


@pytest.mark.parametrize("name", SERVE)
def test_serve_weight_fsdp_matches_one_rank(runs, name):
    """hymba, xLSTM and whisper served at (2, 2) with their weights split
    over "data" too (``serve_weight_fsdp``: the FSDP gathers in the
    forward): the prefill's and four decode steps' logits within
    ``SELF_TOL`` of the port's one rank; the drawn blocks are the
    unsharded draw's, and gathered give it back."""
    from repro_torch import convert
    from repro_torch.serve import serve_step as S
    case, cfg = CASES[name], _config(name)
    z = np.load(runs / f"{name}.npz")
    params = C.unflatten({k[len("param."):]: z[k] for k in z.files
                          if k.startswith("param.")})
    frontend = (torch.from_numpy(z["frontend"]) if "frontend" in z.files
                else None)
    with torch.inference_mode():
        model = convert.lm_params_from_numpy(params, cfg, device="cpu")
        logits, cache = S.prefill(model, torch.from_numpy(z["tokens"]).long(),
                                  max_len=case["max_len"], frontend=frontend)
        out = [logits]
        for tok in z["fed"]:
            logits, cache = S.decode_step(model, cache,
                                          torch.from_numpy(tok).long())
            out.append(logits)
    want = torch.stack(out).numpy()
    for got in _ranks(runs, name):
        assert got["logits"].shape == want.shape
        assert _rel(got["logits"], want) <= SELF_TOL, _rel(got["logits"],
                                                           want)
        assert bool(got["blocks_equal"]) and bool(got["gathered_equal"])


#: A layer's collectives in training, (all_reduce, all_gather,
#: reduce_scatter) of its forward and of its backward, under a model axis
#: of more than one rank, as the modules' docstrings state them
#: (``models/ssm.py``, ``models/xlstm.py``, ``models/attention.py``,
#: ``models/mlp.py``): hymba's attention (its query and KV columns
#: gathered at the smoke widths, as at full width) + its Mamba branch +
#: the MLP; the mLSTM; the sLSTM; whisper's encoder layer (heads whole a
#: rank) and its decoder layer (self and cross attention + the MLP).  The
#: per-layer remat runs the forward's again in the backward but its last
#: (the closing row-parallel sum, which no saved tensor needs:
#: ``torch.utils.checkpoint`` stops early; ``models/transformer.py``).
LAYER_TRAIN_COLLECTIVES = {
    "hymba": ((1 + 2 + 1, 1 + 2, 0), (1 + 2 + 1, 1 + 2, 1)),
    "mlstm": ((2, 1, 0), (2, 1, 1)),
    "slstm": ((1, 2, 0), (1, 1, 1)),
    "enc": ((1 + 1, 0, 0), (1 + 1, 0, 0)),
    "dec": ((1 + 1 + 1, 0, 0), (1 + 2 + 1, 0, 0)),
}


def _step_collectives(name: str) -> tuple:
    """(all_reduce, all_gather, all_to_all, reduce_scatter) of one step
    of the case: each microbatch's layers (forward, remat, backward), its
    vocab-parallel embedding and loss (``models/layers.py``: the
    embedding's sum; two sums a loss chunk, again in the chunk's
    recomputation; the loss input's ``copy_to_split``), its loss sums
    over "data" and FSDP's gathers (each use of a weight split over
    "data", again in the remat; the table's twice, outside it) and their
    reduce-scatters; then the replicated leaves' gradients summed over
    "data" (one a dtype), the global norms of the gradients and the new
    parameters (one sum a split axis each) and ZeRO-1's gathers of the
    parameters whose moments are cut further (``train/train_step.py``,
    ``optim/adamw.py``)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import spec_axes
    from repro_torch.train import train_step as TS
    cfg, case = _config(name), CASES[name]
    dp, tp = case["mesh"]
    rules = _train_rules((dp, tp))
    kinds = [v.kind for v in (T.model_pattern(cfg) * cfg.n_layers)
             [:cfg.n_layers]]
    if cfg.encdec is not None:
        kinds += ["enc"] * cfg.encdec.n_enc_layers
    ar = ag = rs = 0
    for kind in kinds:
        (fa, fg, _), (ba, bg, br) = LAYER_TRAIN_COLLECTIVES[kind]
        ar, ag, rs = ar + 2 * fa - 1 + ba, ag + 2 * fg + bg, rs + br
    if tp > 1 and cfg.vocab_size % tp == 0:
        chunks = -(-C.TRAIN_SEQ // cfg.loss_chunk)
        ar += 1 + 1 + 2 * 2 * chunks
    model = T.LMModel(cfg, generator=torch.Generator(), device="meta")
    layout = TS.state_layout(model, rules)
    if dp > 1:
        layer = sum(1 for n in layout.params if n.endswith(".w")
                    and "data" in spec_axes(layout.params[n]))
        table = 2 if "data" in spec_axes(layout.params[
            "embedding.table"]) else 0
        ar, ag, rs = ar + 1, ag + 2 * layer + table, rs + layer + table
    mb = case.get("microbatches", 1)
    ar, ag, rs = mb * ar, mb * ag, mb * rs
    axes = {a for n in layout.params for a in layout.axes(n)}
    ar += 2 * len(axes) + (1 if dp > 1 else 0)
    ag += sum(1 for n in layout.params if layout.zero1_dim(n) is not None)
    return ar, ag, 0, rs


@pytest.mark.parametrize("name", ORACLE)
def test_recurrent_step_collectives(runs, name):
    """The collectives of one ``make_train_step`` step on every rank, by
    op: equal on every rank, and those of the layer counts the modules'
    docstrings state (:data:`LAYER_TRAIN_COLLECTIVES`,
    :func:`_step_collectives`)."""
    got = [tuple(int(v) for v in r["step_collectives"])
           for r in _ranks(runs, name)]
    assert len(set(got)) == 1, got
    assert got[0] == _step_collectives(name)


@pytest.mark.parametrize("name", [n for n in ORACLE
                                  if CASES[n]["arch"] != "whisper-small"])
def test_dwconv1d_runs_on_the_rank_channel_block(runs, name):
    """Every ``dwconv1d`` call of a rank's step, forward (again in the
    per-layer remat) and backward, takes a contiguous (B, L, D / tp) block:
    hymba's d_inner, the mLSTM's d_inner and the sLSTM's d_model over the
    model axis; the calls a microbatch are ``expected_train_launches``'."""
    from repro_torch.launch.train import expected_train_launches
    dp, tp = CASES[name]["mesh"]
    cfg = _config(name)
    mb = CASES[name].get("microbatches", 1)
    if cfg.ssm is not None:
        layer = [cfg.d_model * cfg.ssm.expand // tp] * cfg.n_layers
    else:
        layer = [(2 * cfg.d_model if i % 2 == 0 else cfg.d_model) // tp
                 for i in range(cfg.n_layers)]
    launches = expected_train_launches(cfg)
    for got in _ranks(runs, name):
        fwd, bwd = got["dwconv1d_fwd_widths"], got["dwconv1d_bwd_widths"]
        assert len(fwd) == mb * launches["dwconv1d"]
        assert len(bwd) == mb * launches["dwconv1d_bwd"]
        assert sorted(fwd[:, 0]) == sorted(layer * (len(fwd) // len(layer)))
        assert sorted(bwd[:, 0]) == sorted(layer * mb)
        assert fwd[:, 1].all() and bwd[:, 1].all()        # contiguous


def test_recurrent_checkpoint_restores_under_another_mesh_and_one_rank(
        runs):
    """hymba's and xLSTM's train states written under (1, 2), where their
    fused projections (the Mamba's ``w_in``, the mLSTM's ``w_up`` and
    gates, the sLSTM's gates) are cut part by part over "model": restored
    under (2, 1) every rank's blocks are those drawn under (2, 1), and by
    one rank the whole state is the one-rank draw, parameters, moments
    and step bit for bit."""
    import _torch_tp_world as W
    from repro_torch.train.checkpoint import Checkpointer, _flatten
    for r in range(2):
        z = np.load(runs / f"port_ckpt_2x1_r{r}.npz")
        for arch in W.CKPT_ARCHS:
            assert int(z[f"{arch}.step"]) == W.CKPT_STEP
            assert list(z[f"{arch}.equal"]) == [""], (arch, z[f"{arch}.equal"])
    for arch in W.CKPT_ARCHS:
        want, _ = W.ckpt_state(W.ckpt_config(arch), None)
        got, step, _ = Checkpointer(str(runs / f"ckpt_{arch}")).restore(want)
        assert step == W.CKPT_STEP
        got, want = _flatten(got), _flatten(want)
        assert set(got) == set(want) and len(got) > 20
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, (arch, bad)


def test_launcher_trains_the_three_families_under_torchrun(tmp_path):
    """``launch.train --model-parallel 2`` under ``torchrun`` (2 gloo
    ranks, (1, 2)) for hymba, xLSTM and whisper, side by side: each prints
    its mesh and a step's collectives, and its losses match the one-rank
    launcher's within 2e-5."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = {}
    for arch in ("hymba-1.5b", "xlstm-125m", "whisper-small"):
        args = ["-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
                "--device", "cpu", "--steps", "3", "--seq-len", "16",
                "--global-batch", "2"]
        runs[arch] = (
            _start([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2", *args,
                    "--backend", "gloo", "--model-parallel", "2",
                    "--ckpt-dir", str(tmp_path / f"two_{arch}")], env),
            _start([sys.executable, *args, "--ckpt-dir",
                    str(tmp_path / f"one_{arch}")], env))
    for arch, (two, one) in runs.items():
        two = _finish(two, f"torchrun {arch}", LAUNCH_TIMEOUT_S)
        one = _finish(one, f"one rank {arch}", LAUNCH_TIMEOUT_S)
        assert two.returncode == 0, two.stderr[-4000:]
        assert one.returncode == 0, one.stderr[-4000:]
        assert ("mesh {'data': 1, 'model': 2} over 2 rank(s), backend gloo"
                in two.stdout), arch
        assert "[train] collectives a step" in two.stdout
        np.testing.assert_allclose(_losses(two.stdout), _losses(one.stdout),
                                   rtol=LOSS_RTOL, err_msg=arch)


# ---------------------------------------------------------------------------
# check_mesh, FSDP, and the cases' widths
# ---------------------------------------------------------------------------


def _train_rules(mesh_shape, mode="train"):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import make_rules
    return make_rules(mesh_lib.Mesh(("data", "model"), mesh_shape),
                      mode=mode, multi_pod=False)


@pytest.mark.parametrize("mesh", ((1, 2), (1, 4), (2, 1), (2, 2)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ("hymba-1.5b", "xlstm-125m",
                                  "whisper-small"))
def test_check_mesh_accepts_training_and_fsdp(arch, mesh):
    """The three families train and take FSDP under every mesh of (1, 2),
    (1, 4), (2, 1) and (2, 2) at their published widths (``check_mesh``
    under the train rules, ``training=True``), and a model drawn under
    the train rules holds each leaf's block of the rules' spec."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import (local_shape, param_specs,
                                            use_rules)
    rules = _train_rules(mesh)
    T.check_mesh(get_config(arch), rules, training=True)
    cfg = get_config(arch, smoke=True)
    if cfg.n_heads % mesh[1] == 0:
        with use_rules(rules):
            model = T.init_params(cfg, device="meta")
        specs = param_specs(T.whole_shapes(cfg), rules)
        whole = T.whole_shapes(cfg)
        for n, p in model.named_parameters():
            assert tuple(p.shape) == local_shape(whole[n], specs[n],
                                                 rules.mesh), n


def _split_leaves(cfg, mesh_shape) -> dict:
    """The parameters the train rules split, by axis (layer indices
    dropped)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import param_specs, spec_axes
    pattern = T.model_pattern(cfg)
    cut = dataclasses.replace(cfg, n_layers=len(pattern))
    if cfg.encdec is not None:
        cut = dataclasses.replace(cut, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=1))
    specs = param_specs(T.whole_shapes(cut), _train_rules(mesh_shape))
    return {axis: {re.sub(r"\.\d+\.", ".*.", n) for n, s in specs.items()
                   if axis in spec_axes(s)} for axis in ("data", "model")}


@pytest.mark.parametrize("name", ORACLE)
def test_the_cases_widths_split_what_full_width_splits(name):
    """Guard: under the train rules the leaves split over "model" and over
    "data" at the case's widths are those split at the family's published
    widths on the same mesh."""
    from repro_torch.configs.registry import get_config
    case = CASES[name]
    got = _split_leaves(_config(name), case["mesh"])
    assert got == _split_leaves(get_config(case["arch"]), case["mesh"])
