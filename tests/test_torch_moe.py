"""The port's Mixture-of-Experts on the CPU, held against the JAX package:
``models/moe.py`` (the router, the load-balance loss, the rank-by-position
dispatch with its capacities, drops, the one-device body ``_moe_local``,
``moe_forward`` with and without a shared expert, the dense oracle) and
the MoE transformers' layers at their smoke configs (qwen3-moe:
top-2 of 4 experts on every layer; llama4: three sliding-window layers
and a global NoPE one, top-1 plus a shared expert on every other layer,
8 fusion embeddings) and their metrics with drops; their prefill, decode
steps and generation are in ``tests/test_torch_moe_serving.py``.

Seeded weights and inputs as in ``tests/test_torch_dense.py``; the
reference's MoE runs with ``mesh=None`` (its ``_moe_local`` at
``tp=1``).  Tolerances: fp32 ops 2e-5; blocks, caches and logits 1e-4;
bf16 ``BF16_REL_TOL``; ``aux_loss`` and ``drop_frac`` to fp32 rounding
(bf16 models: 1e-3 relative, the router reading bf16 activations).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (BLOCK_TOL, LM_DTYPES, PROMPTS,  # noqa: E402
                           TORCH, assert_close, assert_moe_aux,
                           check_layer_decode, check_layer_forward, configs,
                           lm_frontend, lm_tokens, perturbed, rand, to_jax,
                           to_torch)
from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import serve_step as TS  # noqa: E402

MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
D, FF, E = 24, 32, 4


def _cfgs(top_k=2, n_shared=0, capacity_factor=2.0, norm_topk=True):
    kw = dict(n_experts=E, top_k=top_k, d_ff_expert=FF, n_shared=n_shared,
              capacity_factor=capacity_factor, norm_topk=norm_topk)
    return jbase.MoEConfig(**kw), tbase.MoEConfig(**kw)


def _moe_pair(jcfg, dtype, seed=0, skew=0.0):
    """(reference params, port module) of one MoE block; ``skew`` added to
    expert 0's router column sends most copies of positive inputs to it
    (drops at small capacities)."""
    jp = perturbed(jm.init_moe(jax.random.PRNGKey(seed), D, jcfg, 40,
                               dtype=to_jax(np.zeros(1), dtype).dtype), seed)
    jp["router"]["w"] = np.array(jp["router"]["w"])
    jp["router"]["w"][:, 0] += skew
    tcfg = tbase.MoEConfig(**dataclasses.asdict(jcfg))
    m = tm.MoE(D, tcfg, 40, generator=torch.Generator(), dtype=TORCH[dtype],
               device="cpu")
    convert.load_tree_(m, convert.flatten_tree(jp))
    return jax.tree_util.tree_map(jnp.asarray, jp), m


def _assert_scalar(got, want, tol=1e-6):
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=1e-7)


# ---------------------------------------------------------------------------
# Params, router, loss, ranks, capacities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("n_shared", (0, 1))
def test_moe_init_has_the_reference_names_shapes_and_dtypes(n_shared, dtype):
    jcfg, tcfg = _cfgs(n_shared=n_shared)
    jp = jm.init_moe(jax.random.PRNGKey(0), D, jcfg, 40,
                     dtype=to_jax(np.zeros(1), dtype).dtype)
    m = tm.MoE(D, tcfg, 40, generator=torch.Generator().manual_seed(0),
               dtype=TORCH[dtype], device="cpu")
    got = {k: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for k, p in m.named_parameters()}
    want = {k: (a.shape, str(a.dtype))
            for k, a in convert.flatten_tree(jp).items()}
    assert got == want
    assert got["router.w"] == ((D, E), "float32")
    std = float(m.w_down_e.float().std())
    assert abs(std - FF ** -0.5) < 0.1 * FF ** -0.5


@pytest.mark.parametrize("norm_topk", (True, False))
@pytest.mark.parametrize("k", (1, 2, 4))
def test_router_topk_matches_reference(k, norm_topk):
    logits = rand(np.random.default_rng(k), (37, 6), 2.0)
    wj, ij, pj = jm.router_topk(jnp.asarray(logits), k, norm_topk)
    wt, it, pt = tm.router_topk(torch.from_numpy(logits), k, norm_topk)
    assert wt.dtype == pt.dtype == torch.float32
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert_close(wt, wj, "float32")
    assert_close(pt, pj, "float32")


@pytest.mark.parametrize("k", (1, 2, 8))
def test_load_balance_loss_matches_reference(k):
    rng = np.random.default_rng(k)
    probs = rng.dirichlet(np.ones(16), 50).astype(np.float32)
    ids = np.stack([rng.permutation(16)[:k] for _ in range(50)])
    _assert_scalar(tm.load_balance_loss(torch.from_numpy(probs),
                                        torch.from_numpy(ids), 16),
                   jm.load_balance_loss(jnp.asarray(probs), jnp.asarray(ids),
                                        16))


@pytest.mark.parametrize("n,groups", [(1, 1), (50, 1), (50, 3), (200, 9),
                                      (64, 129)])
def test_ranks_by_group_matches_reference(n, groups):
    ids = np.random.default_rng(n + groups).integers(0, groups, n)
    got = tm._ranks_by_group(torch.from_numpy(ids), groups)
    want = jm._ranks_by_group(jnp.asarray(ids, jnp.int32), groups)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,share,cf,want", [
    (74, 4, 1.0, 24), (64, 4, 1.25, 24), (5, 1, 2.0, 5), (3, 4, 2.0, 3),
    (32, 4, 4.0, 32), (4096 * 8, 128, 2.0, 512), (64, 128, 2.0, 8),
    (200, 4, 0.5, 32)])
def test_capacity_rounds_as_the_reference(n, share, cf, want):
    """The balanced share times the factor, up to a multiple of 8, at least
    8 and at most every copy (``moe.py:155-158, 181-184``): e.g.
    qwen3-moe's batch-8 512-token prefill, 32768 copies over 128 experts,
    gets 512 slots an expert; a batch-8 decode step's 64 copies get 8."""
    assert tm._capacity(n, share, cf) == want


# ---------------------------------------------------------------------------
# The one-device body, moe_forward, the dense oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("skew", (0.0, 3.0))
@pytest.mark.parametrize("cf", (1.0, 4.0))
@pytest.mark.parametrize("t", (1, 5, 37, 64))
def test_moe_local_matches_reference(t, cf, skew, dtype):
    """Token counts under one capacity quantum, ragged and whole; a
    balanced and a skewed router; capacities that drop copies (skewed at
    factor 1) and that keep all: the output, the aux loss and the drop
    fraction."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp, m = _moe_pair(jcfg, dtype, seed=t, skew=skew)
    x = rand(np.random.default_rng(t), (t, D))
    if skew:                     # positive inputs: expert 0's logit grows
        x = np.abs(x)
    yj, auxj, dropj = jm._moe_local(jp, to_jax(x, dtype), jcfg, tp=1,
                                    axis_name=None)
    yt, auxt, dropt = tm._moe_local(m, to_torch(x, dtype), tcfg)
    assert yt.dtype == torch.float32
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    _assert_scalar(auxt, auxj)
    _assert_scalar(dropt, dropj)
    if skew and cf == 1.0 and t >= 37:
        assert float(dropt) > 0.1


def test_drop_frac_counts_the_dropped_copies():
    """Skewed routing at factor 1: each expert keeps its first cap_e copies
    by position; the drop fraction is the rest over all copies, and a
    token whose copies were all dropped gets zero."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0, top_k=1)
    _, m = _moe_pair(jcfg, "float32", seed=5, skew=6.0)
    x = torch.from_numpy(np.abs(rand(np.random.default_rng(5), (64, D))))
    y, _, drop = tm._moe_local(m, x, tcfg)
    ids = tm.router_topk(tm._router_logits(m, x), 1, True)[1][:, 0]
    cap = tm._capacity(64, E, 1.0)
    counts = torch.bincount(ids, minlength=E)
    assert float(drop) == pytest.approx(
        float((counts - counts.clamp(max=cap)).sum()) / 64, abs=1e-7)
    ranks = tm._ranks_by_group(ids, E)
    dropped = ranks >= cap
    assert bool(dropped.any())
    assert torch.equal(y[dropped], torch.zeros_like(y[dropped]))


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("top_k,n_shared", [(2, 0), (1, 1)])
def test_moe_forward_matches_reference(top_k, n_shared, dtype):
    jcfg, tcfg = _cfgs(top_k=top_k, n_shared=n_shared)
    jp, m = _moe_pair(jcfg, dtype, seed=7)
    x = rand(np.random.default_rng(7), (2, 9, D), 0.5)
    yj, aj = jm.moe_forward(jp, to_jax(x, dtype), jcfg)
    yt, at = tm.moe_forward(m, to_torch(x, dtype), tcfg)
    assert yt.dtype == TORCH[dtype]
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    assert_moe_aux(at, aj, "float32")


@pytest.mark.parametrize("n_shared", (0, 1))
def test_moe_dense_ref_matches_reference(n_shared):
    jcfg, tcfg = _cfgs(n_shared=n_shared)
    jp, m = _moe_pair(jcfg, "float32", seed=8)
    x = rand(np.random.default_rng(8), (3, 5, D), 0.5)
    yj, aj = jm.moe_dense_ref(jp, jnp.asarray(x), jcfg)
    yt, at = tm.moe_dense_ref(m, torch.from_numpy(x), tcfg)
    assert_close(yt, yj, "float32")
    assert_moe_aux(at, aj, "float32")


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("top_k,n_shared", [(2, 0), (1, 1)])
def test_no_drop_equals_moe_dense_ref(top_k, n_shared, dtype):
    """At factor 4 every copy of 16 tokens fits: ``moe_forward`` is the
    dense oracle (bf16: the routed outputs round to bf16 once more)."""
    jcfg, tcfg = _cfgs(top_k=top_k, n_shared=n_shared, capacity_factor=4.0)
    _, m = _moe_pair(jcfg, dtype, seed=9)
    x = to_torch(rand(np.random.default_rng(9), (2, 8, D), 0.5), dtype)
    y, aux = tm.moe_forward(m, x, tcfg)
    ref, ref_aux = tm.moe_dense_ref(m, x, tcfg)
    assert float(aux["drop_frac"]) == 0.0
    _assert_scalar(aux["aux_loss"], ref_aux["aux_loss"])
    assert_close(y, ref, dtype)


def test_moe_dispatch_reads_nothing_back_to_the_host():
    """No op of a MoE layer's prefill or decode step reads a device value
    to the host (``.item()``, ``nonzero``, boolean indexing) or has a
    data-dependent shape, so it captures: the aten ops that would, traced
    through a dispatch mode, never appear."""
    from torch.utils._python_dispatch import TorchDispatchMode
    syncing = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique")
    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))
    model = TT.init_params(registry.get_config("qwen3-moe-235b-a22b",
                                               smoke=True), device="cpu")
    _, tt = lm_tokens(2, 20, 1)
    with Record():
        logits, cache = TS.prefill(model, tt, max_len=24)
        TS.decode_step(model, cache, logits.argmax(-1)[:, None])
    assert "bmm" in seen and "index_copy_" in seen
    assert not [op for op in seen if op.startswith(syncing)]


# ---------------------------------------------------------------------------
# The MoE transformers' serving path at their smoke configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_layer_forward_matches_reference(arch, s, dtype):
    check_layer_forward(arch, dtype, s)


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("arch,max_len,steps", [
    ("qwen3-moe-235b-a22b", 24, 12), ("llama4-maverick-400b-a17b", 40, 36)])
def test_layer_decode_matches_reference(arch, max_len, steps, dtype):
    """qwen3-moe on a plain cache; llama4's sliding-window layers on
    32-slot rings that 36 steps wrap, its global layer on the whole
    cache."""
    check_layer_decode(arch, dtype, max_len, steps)


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_and_drop_frac_with_drops_match_reference(arch, dtype):
    """The layers' MoE metrics averaged over all layers, as the reference
    does, at a capacity factor of 0.5 where copies drop."""
    jcfg, tcfg = configs(arch, dtype)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(3)))
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    tj, tt = lm_tokens(2, 40, 4)
    fj, ft = lm_frontend(jcfg, 2, 4, dtype)
    xj, _, aj = JT.hidden_states(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                              jp), tj,
                                 frontend=fj)
    xt, _, at = TT.hidden_states(model, tt, frontend=ft)
    assert float(at["drop_frac"]) > 0.0
    assert_moe_aux(at, aj, dtype)
    assert_close(xt, xj, dtype, fp32_tol=BLOCK_TOL)


def test_full_width_patterns_and_launches():
    """qwen3-moe at 94 layers: 4 pwconv a layer (q, k, v, o), 376 a prefill
    and a decode step.  llama4 at 48 layers: three sliding-window layers
    (window 8192, a ring cache past it) then a global NoPE layer, MoE (top-1
    plus a shared expert) on every other layer: 7 a layer, 336."""
    qm = registry.get_config("qwen3-moe-235b-a22b")
    assert [v.use_moe for v in TT.layer_pattern(qm)] == [True]
    for phase in ("prefill", "decode"):
        assert tserve.expected_launches(qm, phase) == {"dwconv1d": 0,
                                                       "pwconv": 376}
    ll = registry.get_config("llama4-maverick-400b-a17b")
    pattern = TT.layer_pattern(ll)
    assert [(v.window, v.rope, v.use_moe) for v in pattern] == [
        (8192, True, False), (8192, True, True), (8192, True, False),
        (None, False, True)]
    for phase in ("prefill", "decode"):
        assert tserve.expected_launches(ll, phase) == {"dwconv1d": 0,
                                                       "pwconv": 336}
    assert TT.cache_len(pattern[0], 9000) == 8192
    assert TT.cache_len(pattern[3], 9000) == 9000
    model = TT.LMModel(qm, generator=torch.Generator(), device="meta")
    per_layer = sum(p.numel() for p in model.blocks[0].parameters())
    assert 2.48e9 < per_layer < 2.50e9
