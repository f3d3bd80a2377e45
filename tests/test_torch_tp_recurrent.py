"""Sharded serving of the recurrent and encoder-decoder families on the
CPU: hymba, xLSTM and whisper as the port's gloo ranks against the
reference's sharded ``prefill`` and ``decode_step`` on the same mesh.

The reference runs every case of ``_torch_tp_cases.RECURRENT_CASES`` in
one subprocess (``_torch_tp_oracle.py --cases RECURRENT_CASES``: four
forced host devices, jitted under ``use_rules``); the port in one spawned
world of gloo ranks a mesh shape (``_torch_tp_world.py``), with the
weights and prompts the oracle wrote.  The cases are the smoke configs in
fp32 with their widths changed so that every leaf the rules split at the
family's published widths at the case's tp splits too (the guard test
holds them to it): hymba at tp 2 and 4, its 8 meta tokens and 30-token
prompt in a 40-slot ring the decode steps wrap; xLSTM at tp 2, tp 4 (a
head a rank) and (data 2, model 2); whisper at tp 2 and 4, its cross
attention's cache split by frame.

Tolerances as ``test_torch_tp_serve.py``'s: the logits of the prefill and
of four greedy decode steps within ``LOGITS_TOL`` of their largest
magnitude against the reference, within ``SELF_TOL`` against the port's
own single rank.  Every subprocess runs under a timeout.
"""
import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import _torch_tp_cases as C
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import make_rules
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step as S
from repro_torch.sharding.rules import param_specs, use_rules
from test_torch_tp_serve import (HERE, LAUNCH_TIMEOUT_S, LOGITS_TOL,
                                 ORACLE_TIMEOUT_S, SELF_TOL, WORLD_TIMEOUT_S,
                                 _rel, _run, _tokens)

CASES = C.RECURRENT_CASES


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory with the oracle's results and every world's."""
    d = tmp_path_factory.mktemp("tp_recurrent")
    res = _run([sys.executable, str(HERE / "_torch_tp_oracle.py"),
                "--cases", "RECURRENT_CASES", str(d)], ORACLE_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    for dp, tp in C.meshes(CASES):
        res = _run([sys.executable, str(HERE / "_torch_tp_world.py"),
                    "--data", str(dp), "--model", str(tp), "--cases",
                    "RECURRENT_CASES", str(d)], WORLD_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
    return d


def _ranks(d, name):
    dp, tp = CASES[name]["mesh"]
    return [np.load(d / f"port_{name}_r{r}.npz") for r in range(dp * tp)]


def _config(name):
    case = CASES[name]
    return C.config(get_config(case["arch"], smoke=True), case)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_logits_match_the_reference(runs, name):
    """Every rank's prefill and four decode steps' logits (the whole batch
    and vocab) against the reference's sharded ones, the same tokens
    fed."""
    want = np.load(runs / f"{name}.npz")["logits"]
    for r, got in enumerate(_ranks(runs, name)):
        assert got["logits"].shape == want.shape
        assert _rel(got["logits"], want) <= LOGITS_TOL, (r, _rel(
            got["logits"], want))
        assert np.array_equal(got["logits"].argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_the_single_rank_port(runs, name):
    case = CASES[name]
    z = np.load(runs / f"{name}.npz")
    cfg = _config(name)
    params = C.unflatten({k[len("param."):]: z[k] for k in z.files
                          if k.startswith("param.")})
    tokens = torch.from_numpy(z["tokens"]).long()
    frontend = (torch.from_numpy(z["frontend"]) if "frontend" in z.files
                else None)
    with torch.inference_mode():
        model = convert.lm_params_from_numpy(params, cfg, device="cpu")
        logits, cache = S.prefill(model, tokens, max_len=case["max_len"],
                                  frontend=frontend)
        out = [logits]
        for tok in z["fed"]:
            logits, cache = S.decode_step(model, cache,
                                          torch.from_numpy(tok).long())
            out.append(logits)
    want = torch.stack(out).numpy()
    for got in _ranks(runs, name):
        assert _rel(got["logits"], want) <= SELF_TOL


def _state_split(cfg, names: list, tp: int, dp: int) -> dict:
    """{cache leaf: its block's shape} of the recurrent states and the
    encoder's K/V, with the shapes the slice's layout states: the batch
    over "data", heads and channels over "model" (the port's states), the
    frames over "model" (the reference's cache spec)."""
    b = C.BATCH // dp
    want = {}
    di = cfg.d_model * (cfg.ssm.expand if cfg.ssm else 2)
    for name in names:
        leaf = name.split(".")[-1]
        if ".mamba." in name:
            want[name] = ((b, di // tp, cfg.ssm.d_state) if leaf == "h"
                          else (b, cfg.ssm.conv_k - 1, di // tp))
        elif cfg.xlstm is not None and name.startswith("layers."):
            i = int(name.split(".")[1])
            width = cfg.d_model * (2 if i % 2 == 0 else 1)
            dh = width // cfg.n_heads
            h = cfg.n_heads // tp
            want[name] = {"c": (b, h, dh, dh) if i % 2 == 0 else (b, h, dh),
                          "n": (b, h, dh), "h": (b, h, dh),
                          "m": (b, h) if i % 2 == 0 else (b, h, dh),
                          "conv": (b, cfg.xlstm.conv_k - 1, width // tp)
                          }[leaf]
        elif leaf in ("enc_k", "enc_v"):
            want[name] = (cfg.n_layers, b, cfg.encdec.enc_seq // tp,
                          cfg.n_kv_heads, cfg.head_dim)
    return want


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_have_the_layouts_shapes(runs, name):
    """Each rank's cache has the shapes ``serve_step.cache_layout`` gives
    its blocks; the recurrent states are the rank's heads and channels and
    the encoder's K/V its frames, as the slice states them."""
    dp, tp = CASES[name]["mesh"]
    cfg = _config(name)
    for got in _ranks(runs, name):
        assert list(got["cache_shapes"]) == list(got["want_shapes"])
        names = list(got["cache_names"])
        shapes = [eval(s) for s in got["cache_shapes"]]
        want = _state_split(cfg, names, tp, dp)
        assert want, names
        for n, shape in zip(names, shapes):
            if n in want:
                assert shape == want[n], (n, shape, want[n])


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_do_not_grow_with_the_prompt(runs, name):
    """A prefill and a decode step make as many collectives at prompt
    lengths 9 and the case's: none sits in a time loop (the selective
    scan's, the mLSTM's, the sLSTM's)."""
    for got in _ranks(runs, name):
        assert np.array_equal(got["prefill_collectives"],
                              got["other_prefill_collectives"])
        assert np.array_equal(got["step_collectives"],
                              got["other_step_collectives"])
        assert got["prefill_collectives"].sum() > 0


@pytest.mark.parametrize("name", ["hymba_ring_tp2", "xlstm_tp2",
                                  "whisper_tp2"])
def test_the_collectives_of_each_family(runs, name):
    """Per prefill and per decode step, (all_reduce, all_gather,
    all_to_all) over the smoke configs' 2 / 4 / 2 + 2 layers:

    * hymba, a layer: the attention's gather of q, k, v and its w_o; the
      Mamba's two gathers (the conv's output, bcdt's columns), w_dt's and
      w_out's partial sums; the MLP's w_down; a step adds flash-decoding's
      max and sums;
    * xLSTM: an mLSTM layer one gather (xv and the conv's output) and two
      reductions (the output norm's sums of squares, w_down); an sLSTM
      layer two gathers (the conv's output, the cell's) and w_ff_down's
      reduction; the vocab-parallel embedding's reduction and the logits'
      gather;
    * whisper: an encoder layer w_o's and w_down's reductions; a decoder
      layer in a prefill its self-attention's K/V gather, three
      reductions and the cross K/V's all_to_all from heads to frames, in a
      step two gathers (the self and the cross queries) and seven
      reductions."""
    got = _ranks(runs, name)[0]
    want = {"hymba_ring_tp2": ((2 * 4, 2 * 3, 0), (2 * 6, 2 * 3, 0)),
            "xlstm_tp2": ((2 * 2 + 2 * 1 + 1, 2 * 1 + 2 * 2 + 1, 0),
                          (7, 7, 0)),
            "whisper_tp2": ((2 * 2 + 2 * 3, 2 * 1, 2 * 1),
                            (2 * 7, 2 * 2, 0))}[name]
    assert tuple(got["prefill_collectives"]) == want[0]
    assert tuple(got["step_collectives"]) == want[1]


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c["arch"] != "whisper-small"])
def test_each_rank_runs_dwconv1d_on_its_channel_block(runs, name):
    """Every ``dwconv1d`` call of a rank's prefill takes a contiguous
    (B, L, D / tp) block: hymba's d_inner, the mLSTM's d_inner and the
    sLSTM's d_model over the model axis, one call a layer."""
    dp, tp = CASES[name]["mesh"]
    cfg = _config(name)
    if cfg.ssm is not None:
        want = [cfg.d_model * cfg.ssm.expand // tp] * cfg.n_layers
    else:
        want = [(2 * cfg.d_model if i % 2 == 0 else cfg.d_model) // tp
                for i in range(cfg.n_layers)]
    for got in _ranks(runs, name):
        widths = got["dwconv1d_widths"]
        assert list(widths[:, 0]) == want
        assert widths[:, 1].all()                 # contiguous


@pytest.mark.parametrize("mesh", C.meshes(CASES),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_draws_the_blocks_of_the_unsharded_weights(runs, mesh):
    """The blocks a rank draws are the unsharded draw's (the fused
    projections part by part), and the ranks' blocks gathered over the
    mesh give the unsharded weights."""
    for name in [n for n, c in CASES.items() if c["mesh"] == mesh]:
        for got in _ranks(runs, name):
            assert bool(got["blocks_equal"]) and bool(got["gathered_equal"])


def _split_leaves(cfg, mesh) -> set:
    """The parameters the serving rules split over "model" under ``mesh``
    (layer indices dropped)."""
    pattern = T.model_pattern(cfg)
    cut = dataclasses.replace(cfg, n_layers=len(pattern))
    if cfg.encdec is not None:
        cut = dataclasses.replace(cut, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=1))
    model = T.LMModel(cut, generator=torch.Generator(), device="meta")
    rules = make_rules(mesh, mode="serve", multi_pod=False)
    return {re.sub(r"\.\d+\.", ".*.", n)
            for n, spec in param_specs(model, rules).items()
            if "model" in [a for e in spec if e
                           for a in ((e,) if isinstance(e, str) else e)]}


@pytest.mark.parametrize("name", list(CASES))
def test_the_cases_widths_split_what_full_width_splits(name):
    """Guard: the leaves split over "model" at the case's widths are those
    split at the family's published widths at the same mesh, so that a
    narrowed config fails here rather than quietly testing less."""
    case = CASES[name]
    mesh = mesh_lib.Mesh(("data", "model"), case["mesh"])
    full = get_config(case["arch"])
    got = _split_leaves(_config(name), mesh)
    assert got == _split_leaves(full, mesh)
    assert any("conv" in n or "w_q" in n for n in got), got


# ---------------------------------------------------------------------------
# The launcher, the refusals that stay (FSDP serves: the serve_fsdp cases
# of tests/test_torch_tp_train_recurrent.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("hymba-1.5b", "xlstm-125m",
                                  "whisper-small"))
def test_launcher_under_torchrun_matches_one_rank(arch):
    args = ["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
            "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--gen", "4", "--max-len", "32"]
    run = _run([sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2", *args,
                "--model-parallel", "2"], LAUNCH_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    one = _run([sys.executable, *args], LAUNCH_TIMEOUT_S)
    assert one.returncode == 0, one.stderr[-4000:]
    assert "mesh {'data': 1, 'model': 2} over 2 rank(s), backend gloo" in (
        run.stdout)
    assert run.stdout.count("sample tokens") == 1    # rank 0 prints
    assert _tokens(run.stdout) == _tokens(one.stdout)


def _rules(**kw):
    mesh = mesh_lib.Mesh(("data", "model"), (2, 2))
    return dataclasses.replace(make_rules(mesh, mode="serve",
                                          multi_pod=False), **kw)


@pytest.mark.parametrize("kw", [dict(seq_axis="data")], ids=["seq_axis"])
def test_sequence_parallel_and_fsdp_still_refuse_a_mesh(kw):
    """Sequence parallelism is no longer refused (4.3.3.3): over the model
    axis a model is drawn under it; over another axis (which the
    reference's ``make_rules`` never names, and whose "btd" spec would
    name "data" twice) it raises."""
    cfg = get_config("hymba-1.5b", smoke=True)
    with use_rules(_rules(seq_axis="model")):
        T.init_params(cfg, device="cpu")
    with use_rules(_rules(**kw)), pytest.raises(ValueError,
                                                match="model axis"):
        T.init_params(cfg, device="cpu")


@pytest.mark.parametrize("arch", ("hymba-1.5b", "xlstm-125m"))
def test_recurrent_widths_that_do_not_split_refuse(arch):
    """A recurrent layer runs on whole heads or channels a rank: xLSTM's
    smoke config has 2 heads and hymba's a d_inner of 80, and neither
    splits over 3 ranks."""
    mesh = mesh_lib.Mesh(("data", "model"), (1, 3))
    cfg = get_config(arch, smoke=True)
    with use_rules(make_rules(mesh, mode="serve", multi_pod=False)), \
            pytest.raises(NotImplementedError, match="split over 3 ranks"):
        T.check_mesh(cfg)
