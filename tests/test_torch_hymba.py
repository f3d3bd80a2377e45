"""The port's hymba serving slice on the CPU, held against the JAX package.

Seeded numpy inputs and reference weights (``repro.models``' own inits,
with the zero-initialized norm scales and biases perturbed so that they
count) go through the reference on its ``impl="xla"`` path with
``scan_layers=False`` and through ``repro_torch`` with the weights carried
by ``convert.lm_params_from_numpy`` / ``convert.load_tree_``.
``dwconv1d_causal_pallas`` still runs in interpret mode on this jax, so the
Mamba conv is held against it too, at the smoke config's d_inner.

Model-level runs use ``hymba_1_5b.smoke_config()`` (2 layers, d_model 40,
window 32, 8 meta tokens, ``attn_chunk`` 64): a 20-token prompt takes the
dense attention path and a plain cache; a 100-token prompt (108 positions
with the meta tokens) the blockwise path, a window that excludes keys and
a ring cache of 40 slots.

Tolerances: fp32 ops 2e-5 (rtol = atol), fp32 blocks and logits 1e-4,
bf16 ``BF16_REL_TOL`` relative to the largest magnitude.  The reference's
bf16 model runs op by op (``tests/test_torch_lm.py`` says why); its
``prefill_by_stepping`` primes the meta tokens inside a ``lax.scan``, so
it is compared in fp32.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (BF16_REL_TOL, FP32_TOL, as_f32, rand,  # noqa: E402
                           rel_err, to_jax, to_torch)
from repro.configs import base as jbase  # noqa: E402
from repro.configs import hymba_1_5b as jcfg_mod  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.kernels.dwconv1d import dwconv1d_causal_pallas  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro_torch import convert, graphs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import hymba_1_5b as tcfg_mod  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import dwconv1d  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import sampler  # noqa: E402
from repro_torch.serve import serve_step as TS  # noqa: E402

DTYPES = ("float32", "bfloat16")
#: fp32 blocks and logits (the reference's own, tests/test_ssm_xlstm.py).
BLOCK_TOL = 1e-4
#: A prompt on the dense path with a plain cache (28 positions in 36
#: slots, under window + sink = 40), and one on the blockwise path (108
#: positions > attn_chunk 64) whose cache is the 40-slot ring: the
#: ``max_len`` of each.
PROMPTS = {20: 36, 100: 160}
MAX_LEN = 160


def assert_close(got, want, dtype: str, fp32_tol: float = FP32_TOL):
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=fp32_tol,
                                   atol=fp32_tol)
    else:
        assert rel_err(got, want) <= BF16_REL_TOL, rel_err(got, want)


def assert_trees(got, want, dtype: str, fp32_tol: float = BLOCK_TOL):
    """Nested dicts of tensors against the reference's, key for key."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees(got[k], want[k], dtype, fp32_tol)
    else:
        assert_close(got, want, dtype, fp32_tol)


def perturbed(tree, seed: int = 0):
    """Reference params as numpy, each all-zero leaf (norm scales, biases)
    replaced by seeded noise in its dtype."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if np.any(a.astype(np.float32)):
            return a
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
    return jax.tree_util.tree_map(leaf, tree)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def torch_dtype(dtype: str) -> torch.dtype:
    return to_torch(np.zeros(1), dtype).dtype


def jax_dtype(dtype: str):
    return to_jax(np.zeros(1), dtype).dtype


def _module(cls, jp, dtype, *args, **kwargs):
    """A port module of ``cls(*args)`` holding the reference params ``jp``."""
    m = cls(*args, generator=torch.Generator().manual_seed(0),
            dtype=torch_dtype(dtype), device="cpu", **kwargs)
    return convert.load_tree_(m, convert.flatten_tree(jp))


# ---------------------------------------------------------------------------
# Layers: RoPE, the SwiGLU MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rand(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 5000, (2, 7))
    got = tlayers.apply_rope(to_torch(x, dtype), torch.from_numpy(pos), 1e4)
    want = jlayers.apply_rope(to_jax(x, dtype), jnp.asarray(pos), 1e4)
    assert got.dtype == torch_dtype(dtype)
    assert_close(got, want, dtype)
    assert_close(tlayers.rope_freqs(16, 1e4, "cpu"),
                 jlayers.rope_freqs(16, 1e4), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_matches_reference(dtype):
    jp = perturbed(jmlp.init_mlp(jax.random.PRNGKey(1), 24, 56,
                                 dtype=jax_dtype(dtype)))
    m = _module(tmlp.MLP, jp, dtype, 24, 56)
    x = rand(np.random.default_rng(1), (2, 5, 24))
    assert_close(m(to_torch(x, dtype)), jmlp.mlp(jtree(jp), to_jax(x, dtype)),
                 dtype)


# ---------------------------------------------------------------------------
# The Mamba heads
# ---------------------------------------------------------------------------


def _scan_inputs(b, l, di, n, seed):
    rng = np.random.default_rng(seed)
    u = rand(rng, (b, l, di))
    dt = np.log1p(np.exp(rand(rng, (b, l, di)))).astype(np.float32)
    a = -np.exp(rand(rng, (di, n), 0.5)).astype(np.float32)
    bb, c = rand(rng, (b, l, n)), rand(rng, (b, l, n))
    d = rand(rng, (di,))
    h0 = rand(rng, (b, di, n))
    return (u, dt, a, bb, c, d), h0


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("l,chunk", [(37, 8), (40, 8), (5, 16), (33, 128)])
def test_selective_scan_matches_reference(l, chunk, with_h0):
    """Chunks that divide L, a ragged last chunk, L shorter than a chunk,
    with and without a carried-in state."""
    args, h0 = _scan_inputs(2, l, 6, 4, l)
    yj, hj = js.selective_scan(*map(to_jax, args), chunk=chunk,
                               h0=to_jax(h0) if with_h0 else None)
    yt, ht = tssm.selective_scan(*map(to_torch, args), chunk=chunk,
                                 h0=to_torch(h0) if with_h0 else None)
    assert yt.dtype == ht.dtype == torch.float32
    assert_close(yt, yj, "float32")
    assert_close(ht, hj, "float32")


def test_selective_step_matches_reference_and_scan():
    args, h0 = _scan_inputs(2, 6, 6, 4, 3)
    u, dt, a, b, c, d = args
    hj, ht = to_jax(h0), to_torch(h0)
    ys = []
    for t in range(6):
        step = (u[:, t], dt[:, t], a, b[:, t], c[:, t], d)
        hj, yj = js.selective_step(hj, *(to_jax(s) for s in step[:2]),
                                   to_jax(a), *(to_jax(s) for s in step[3:]))
        ht, yt = tssm.selective_step(ht, *(to_torch(s) for s in step[:2]),
                                     to_torch(a),
                                     *(to_torch(s) for s in step[3:]))
        assert_close(yt, yj, "float32")
        ys.append(yt)
    assert_close(ht, hj, "float32")
    ys_scan, h_scan = tssm.selective_scan(*map(to_torch, args), chunk=4,
                                          h0=to_torch(h0))
    assert_close(torch.stack(ys, 1), ys_scan, "float32")
    assert_close(ht, h_scan, "float32")


_JSSM = jbase.SSMConfig(d_state=4, conv_k=4, expand=2, chunk=16)
_TSSM = tbase.SSMConfig(d_state=4, conv_k=4, expand=2, chunk=16)


def _mamba_pair(dtype, d=40, seed=2):
    jp = perturbed(js.init_mamba(jax.random.PRNGKey(seed), d, _JSSM,
                                 dtype=jax_dtype(dtype)), seed)
    return jtree(jp), _module(tssm.Mamba, jp, dtype, d, _TSSM)


def test_mamba_init_has_the_reference_shapes_and_values():
    jp = js.init_mamba(jax.random.PRNGKey(0), 40, _JSSM, dtype=jnp.bfloat16)
    m = tssm.Mamba(40, _TSSM, generator=torch.Generator().manual_seed(0),
                   dtype=torch.bfloat16, device="cpu")
    got = dict(m.named_parameters())
    want = convert.flatten_tree(jp)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
    for k in ("a_log", "d_skip"):
        assert torch.equal(got[k], torch.from_numpy(np.array(want[k])))
    # softplus(dt_bias) spans [dt_min, dt_max]
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l", (37, 2))
def test_mamba_mixer_and_state_match_reference(l, dtype):
    """L over two chunks with a ragged tail, and L < K-1 (the conv tail
    left-padded)."""
    jp, m = _mamba_pair(dtype)
    x = rand(np.random.default_rng(l), (2, l, 40), 0.5)
    yj, sj = js.mamba_mixer(jp, to_jax(x, dtype), _JSSM, return_state=True)
    yt, st = tssm.mamba_mixer(m, to_torch(x, dtype), _TSSM,
                              return_state=True)
    assert yt.dtype == torch_dtype(dtype)
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    assert_trees(st, sj, dtype)
    assert all(v.dtype == torch.float32 for v in st.values())


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_mixer_step_matches_reference_and_mixer(dtype):
    jp, m = _mamba_pair(dtype, seed=3)
    b, l = 2, 12
    x = rand(np.random.default_rng(4), (b, l, 40), 0.5)
    sj = js.init_mamba_state(b, 40, _JSSM)
    st = tssm.init_mamba_state(b, 40, _TSSM, device="cpu")
    assert_trees(st, sj, "float32")
    outs = []
    for t in range(l):
        yj, sj = js.mamba_mixer_step(jp, to_jax(x[:, t:t + 1], dtype), sj,
                                     _JSSM)
        yt, st = tssm.mamba_mixer_step(m, to_torch(x[:, t:t + 1], dtype), st,
                                       _TSSM)
        assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
        outs.append(yt)
    assert_trees(st, sj, dtype)
    y_full, s_full = tssm.mamba_mixer(m, to_torch(x, dtype), _TSSM,
                                      return_state=True)
    assert_close(torch.cat(outs, 1), y_full, dtype, fp32_tol=BLOCK_TOL)
    assert_trees(st, {k: as_f32(v) for k, v in s_full.items()}, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dwconv1d_pallas_matches_port_at_smoke_d_inner(dtype):
    """The TPU kernel in interpret mode against the port's plain conv at
    the smoke config's d_inner (80) and a 108-row prefill."""
    rng = np.random.default_rng(80)
    x, f = rand(rng, (2, 108, 80)), rand(rng, (4, 80), 0.5)
    pallas = dwconv1d_causal_pallas(to_jax(x, dtype), to_jax(f, dtype),
                                    block_l=32, block_d=16, interpret=True)
    assert_close(dwconv1d.dwconv1d_causal(to_torch(x, dtype),
                                          to_torch(f, dtype)), pallas, dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _qkv(b, sq, sk, hq, hkv, dh, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    q, k, v = (rand(rng, (b, s, h, dh)) for s, h in
               ((sq, hq), (sk, hkv), (sk, hkv)))
    return [to_jax(a, dtype) for a in (q, k, v)], [to_torch(a, dtype)
                                                   for a in (q, k, v)]


#: (window, sink): global, a window, a window with sink tokens.
WINDOWS = [(None, 0), (12, 0), (12, 5)]


@pytest.mark.parametrize("window,sink", WINDOWS)
@pytest.mark.parametrize("causal", (True, False))
def test_dense_attention_matches_reference(causal, window, sink):
    aj, at = _qkv(2, 30, 30, 6, 2, 8, 1)
    want = ja.dense_attention(*aj, causal=causal, window=window, sink=sink)
    got = ta.dense_attention(*at, causal=causal, window=window, sink=sink)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("window,sink", WINDOWS + [(40, 9)])
@pytest.mark.parametrize("s,chunk", [(50, 16), (64, 16), (37, 64)])
def test_blockwise_attention_matches_reference_and_dense(s, chunk, window,
                                                         sink):
    """Ragged chunks, whole chunks, one chunk; windows that drop blocks
    and sink chunks that keep them."""
    aj, at = _qkv(2, s, s, 6, 2, 8, s)
    want = ja.blockwise_attention(*aj, causal=True, window=window,
                                  sink=sink, chunk=chunk)
    got = ta.blockwise_attention(*at, causal=True, window=window, sink=sink,
                                 chunk=chunk)
    assert_close(got, want, "float32")
    assert_close(got, ta.dense_attention(*at, causal=True, window=window,
                                         sink=sink), "float32")


def test_pair_list_and_flags_match_reference():
    for args in ((4, 4, True, 1, 1), (5, 5, True, 2, 0), (3, 3, False, None,
                                                         0)):
        pairs = ta._pair_list(*args)
        assert pairs == [tuple(p) for p in ja._pair_list(*args).tolist()]
        jf, jl = ja._pair_flags(np.asarray(pairs))
        tf, tl = ta._pair_flags(pairs)
        assert tf == jf.tolist() and tl == jl.tolist()


def _attention_pair(dtype, qkv_bias, qk_norm, seed=0):
    jp = perturbed(ja.init_attention(
        jax.random.PRNGKey(seed), 40, 5, 1, 8, qkv_bias=qkv_bias,
        qk_norm=qk_norm, dtype=jax_dtype(dtype)), seed)
    return jtree(jp), _module(ta.Attention, jp, dtype, 40, 5, 1, 8,
                              qkv_bias=qkv_bias, qk_norm=qk_norm)


_HEADS = dict(n_heads=5, n_kv_heads=1, head_dim=8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", (20, 100))
@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, False), (True, True)])
def test_attention_layer_matches_reference(qkv_bias, qk_norm, s, dtype):
    """The layer with its projections and RoPE at positions offset by a
    meta prefix, on the dense path (S <= chunk) and the blockwise one; the
    captured K/V too."""
    jp, m = _attention_pair(dtype, qkv_bias, qk_norm)
    x = rand(np.random.default_rng(s), (2, s, 40), 0.5)
    pos = np.broadcast_to(np.arange(s) + 8, (2, s))
    kw = dict(_HEADS, window=32, sink=8, chunk=64, qk_norm=qk_norm)
    yj, (kj, vj) = ja.attention(jp, to_jax(x, dtype),
                                positions=jnp.asarray(pos), return_kv=True,
                                **kw)
    yt, (kt, vt) = ta.attention(m, to_torch(x, dtype),
                                positions=torch.from_numpy(pos.copy()),
                                return_kv=True, **kw)
    assert yt.dtype == torch_dtype(dtype)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ring,pos", [(False, (3, 17)), (True, (5, 20)),
                                      (True, (41, 77))])
def test_attention_decode_matches_reference(ring, pos, dtype):
    """A plain cache with a window and sink, a ring cache still filling,
    and one that has wrapped; the in-place write gives the functional
    result's bits and writes into the cache it was handed."""
    jp, m = _attention_pair(dtype, False, False, seed=4)
    rng = np.random.default_rng(sum(pos))
    smax = 40
    ck, cv = rand(rng, (2, smax, 1, 8)), rand(rng, (2, smax, 1, 8))
    x = rand(rng, (2, 1, 40), 0.5)
    p = np.asarray(pos, np.int32)
    kw = dict(_HEADS, window=32, sink=8, ring=ring)
    yj, kj, vj = ja.attention_decode(jp, to_jax(x, dtype), to_jax(ck, dtype),
                                     to_jax(cv, dtype), jnp.asarray(p), **kw)
    ckt, cvt = to_torch(ck, dtype), to_torch(cv, dtype)
    yt, kt, vt = ta.attention_decode(m, to_torch(x, dtype), ckt, cvt,
                                     torch.from_numpy(p), **kw)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)
    yi, ki, vi = ta.attention_decode(m, to_torch(x, dtype), ckt, cvt,
                                     torch.from_numpy(p), in_place=True, **kw)
    assert ki is ckt and vi is cvt
    assert torch.equal(yi, yt) and torch.equal(ki, kt) and torch.equal(vi, vt)


def test_ring_slot_and_int8_cache():
    """The ring's slot function, and the int8 cache now that it runs: a
    hymba cache under ``kv_quant`` is int8 K/V with fp32 scales per (B, S,
    Hkv) beside the Mamba state, and ``attention_decode`` with scales
    writes the quantized vector and its scale at the ring's slot."""
    pos = torch.tensor([0, 39, 40, 41, 71, 72, 1000], dtype=torch.int32)
    want = np.where(pos.numpy() < 40, pos.numpy(),
                    8 + (pos.numpy() - 8) % 32)
    assert ta.ring_slot(pos, 40, 8).tolist() == want.tolist()
    cfg = dataclasses.replace(tcfg_mod.smoke_config(), kv_quant=True)
    layer = TS.init_cache(cfg, 1, 60, device="cpu")["layers"][0]
    assert set(layer) == {"k", "v", "k_scale", "v_scale", "mamba"}
    assert layer["k"].dtype == torch.int8 and layer["k"].shape == (1, 40, 1,
                                                                   8)
    assert layer["v_scale"].dtype == torch.float32
    assert layer["v_scale"].shape == (1, 40, 1)
    _, m = _attention_pair("float32", False, False)
    x = torch.from_numpy(rand(np.random.default_rng(0), (1, 1, 40)))
    out, k, v, (ks, vs) = ta.attention_decode(
        m, x, layer["k"], layer["v"], torch.tensor([41]), **_HEADS,
        window=32, sink=8, ring=True, scales=(layer["k_scale"],
                                              layer["v_scale"]))
    slot = int(ta.ring_slot(torch.tensor(41), 40, 8))
    assert slot == 9 and k.dtype == torch.int8
    assert int(k[0, slot].abs().max()) == 127 and float(ks[0, slot]) > 0
    assert not k[0, :slot].any() and not ks[0, slot + 1:].any()
    assert out.shape == (1, 1, 40) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("s,s_c,sink", [(20, 40, 8), (40, 40, 8),
                                        (108, 40, 8), (77, 33, 0)])
def test_ring_fill_matches_reference(s, s_c, sink):
    kv = rand(np.random.default_rng(s), (2, s, 1, 8))
    want = JS._ring_fill(to_jax(kv), s_c, sink, s)
    got = TS._ring_fill(to_torch(kv), s_c, sink)
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))
    if s > s_c:        # each slot holds the latest position it serves
        slots = ta.ring_slot(torch.arange(s), s_c, sink)
        for r in range(s_c):
            p = int(torch.nonzero(slots == r).max())
            assert torch.equal(got[:, r], to_torch(kv)[:, p])


# ---------------------------------------------------------------------------
# The hymba layer, the model and the serving path on the smoke config
# ---------------------------------------------------------------------------


def _configs(dtype):
    return (dataclasses.replace(jcfg_mod.smoke_config(), dtype=dtype,
                                scan_layers=False),
            dataclasses.replace(tcfg_mod.smoke_config(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _lm(dtype):
    """(reference config, reference params, port model), the port's weights
    carried from the reference's."""
    jcfg, tcfg = _configs(dtype)
    jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    return jcfg, jtree(jp), model


def _tokens(b, s, seed, vocab=128):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


def _layer_params(jp, i):
    return jax.tree_util.tree_map(lambda a: a[i], jp["blocks_v0"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", PROMPTS)
def test_hymba_layer_forward_matches_reference(s, dtype):
    jcfg, jp, model = _lm(dtype)
    variant = JT.layer_pattern(jcfg)[0]
    tvariant = model.variant(0)
    assert dataclasses.asdict(tvariant) == dataclasses.asdict(variant)
    x = rand(np.random.default_rng(s), (2, s, 40), 0.5)
    pos = np.broadcast_to(np.arange(s), (2, s))
    yj, aj = JT.layer_forward(_layer_params(jp, 1), to_jax(x, dtype), jcfg,
                              variant, positions=jnp.asarray(pos),
                              capture_kv=True)
    yt, at = TT.layer_forward(model.blocks[1], to_torch(x, dtype), model.cfg,
                              tvariant, positions=torch.from_numpy(pos.copy()),
                              capture_kv=True)
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    for got, want in zip(at["kv"], aj["kv"]):
        assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)
    assert_trees(at["state"], aj["state"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_len", (24, 60))
def test_hymba_layer_decode_matches_reference(max_len, dtype):
    """A plain cache (24 slots) and the ring (max_len 60 > window + sink =
    40), over steps that wrap it."""
    jcfg, jp, model = _lm(dtype)
    variant = JT.layer_pattern(jcfg)[0]
    cj = JT.init_layer_cache(jcfg, variant, 2, max_len)
    ct = TT.init_layer_cache(model.cfg, model.variant(0), 2, max_len,
                             device="cpu")
    assert_trees(ct, cj, dtype)
    rng = np.random.default_rng(max_len)
    steps = 24 if max_len == 24 else 46
    for t in range(steps):
        x = rand(rng, (2, 1, 40), 0.5)
        pos = np.full((2,), t, np.int32)
        yj, cj = JT.layer_decode(_layer_params(jp, 0), to_jax(x, dtype), cj,
                                 jnp.asarray(pos), jcfg, variant)
        yt, ct = TT.layer_decode(model.blocks[0], to_torch(x, dtype), ct,
                                 torch.from_numpy(pos), model.cfg,
                                 model.variant(0))
        assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    assert_trees(ct, cj, dtype)


def _port_cache(cj, cfg):
    """The reference's stacked cache in the port's per-layer layout."""
    def layer(tree, g):
        return {k: layer(v, g) if isinstance(v, dict)
                else torch.from_numpy(np.array(v[g]).astype(np.float32)).to(
                    torch_dtype(str(v.dtype))) for k, v in tree.items()}
    return {"pos": torch.from_numpy(np.array(cj["pos"])),
            "layers": [layer(cj["v0"], i) for i in range(cfg.n_layers)]}


def _assert_caches(ct, cj, dtype):
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    assert len(ct["layers"]) == 2
    for i, layer in enumerate(ct["layers"]):
        assert_trees(layer, jax.tree_util.tree_map(lambda a: a[i], cj["v0"]),
                     dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", PROMPTS)
def test_hidden_states_and_prefill_match_reference(s, dtype):
    jcfg, jp, model = _lm(dtype)
    tj, tt = _tokens(2, s, s)
    xj, pj, _ = JT.hidden_states(jcfg, jp, tj)
    xt, pt, _ = TT.hidden_states(model, tt)
    assert pt == pj == 8
    assert_close(xt, xj, dtype, fp32_tol=BLOCK_TOL)
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=PROMPTS[s])
    lt, ct = TS.prefill(model, tt, max_len=PROMPTS[s])
    assert lt.dtype == torch.float32 and bool(torch.isfinite(lt).all())
    assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
    assert ct["layers"][0]["k"].shape[1] == min(PROMPTS[s], 40)
    _assert_caches(ct, cj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
    """Decode steps from the reference's prefill cache at prompt 100 (the
    ring, wrapped), each taken by the port from the reference's cache."""
    jcfg, jp, model = _lm(dtype)
    tj, _ = _tokens(2, 100, 5)
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=MAX_LEN)
    tok = jsampler.greedy(lj)[:, None]
    for _ in range(3):
        lt, ct = TS.decode_step(model, _port_cache(cj, model.cfg),
                                torch.from_numpy(np.asarray(tok)).long())
        lj, cj = JS.decode_step(jcfg, jp, cj, tok)
        assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
        _assert_caches(ct, cj, dtype)
        tok = jsampler.greedy(lj)[:, None]


def test_prefill_by_stepping_matches_reference_fp32():
    """The meta tokens primed through decode steps from their embeddings,
    then the prompt, in both packages; then one decode step."""
    jcfg, jp, model = _lm("float32")
    tj, tt = _tokens(2, 6, 7)
    lj, cj = JS.prefill_by_stepping(jcfg, jp, tj, max_len=MAX_LEN)
    lt, ct = TS.prefill_by_stepping(model, tt, max_len=MAX_LEN)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    _assert_caches(ct, cj, "float32")
    nj, nt = _tokens(2, 1, 8)
    lj, cj = JS.decode_step(jcfg, jp, cj, nj)
    lt, ct = TS.decode_step(model, ct, nt)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    _assert_caches(ct, cj, "float32")


@pytest.mark.parametrize("dtype,s,max_len", [
    ("float32", 3, 16), ("float32", 40, 60), ("float32", 40, 48),
    ("bfloat16", 9, 24)])
def test_prefill_equals_prefill_by_stepping(dtype, s, max_len):
    """The oracle relation on the port itself: a plain cache, a ring the
    prompt wraps (48 positions in 40 slots) and a plain cache of exactly
    window + sink slots that decode takes as the ring; then two decode
    steps from each cache."""
    model = _lm(dtype)[2]
    _, tt = _tokens(2, s, 11 + s)
    lp, cp = TS.prefill(model, tt, max_len=max_len)
    ls, cs = TS.prefill_by_stepping(model, tt, max_len=max_len)
    assert_close(lp, ls, dtype, fp32_tol=BLOCK_TOL)
    for _ in range(2):
        nxt = sampler.greedy(lp)[:, None]
        lp, cp = TS.decode_step(model, cp, nxt)
        ls, cs = TS.decode_step(model, cs, nxt)
        assert_close(lp, ls, dtype, fp32_tol=BLOCK_TOL)


def test_greedy_generate_matches_reference_fp32():
    jcfg, jp, model = _lm("float32")
    tj, tt = _tokens(2, 30, 12)
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=MAX_LEN)
    lt, ct = TS.prefill(model, tt, max_len=MAX_LEN)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    toks_j, _ = jsampler.generate(
        lambda c, t: JS.decode_step(jcfg, jp, c, t), cj,
        jsampler.greedy(lj)[:, None], 6, jax.random.PRNGKey(2))
    toks_t, _ = sampler.generate(lambda c, t: TS.decode_step(model, c, t),
                                 ct, sampler.greedy(lt)[:, None], 6)
    assert np.array_equal(toks_t.numpy(), np.asarray(toks_j))


def test_decode_step_into_writes_in_place_and_matches_decode_step():
    """The body ``capture_decode_step`` captures, on the CPU, over steps
    that wrap the ring: the logits and cache of the functional step, every
    tensor of the static cache kept at its address."""
    model = _lm("float32")[2]
    _, tt = _tokens(2, 30, 3)
    logits, ref = TS.prefill(model, tt, max_len=MAX_LEN)
    cache = TS.init_cache(model.cfg, 2, MAX_LEN, "cpu")
    graphs.copy_tree_(cache, ref)

    def leaves(c):
        return [c["pos"]] + [t for layer in c["layers"] for t in (
            layer["k"], layer["v"], *layer["mamba"].values())]
    addresses = [t.data_ptr() for t in leaves(cache)]
    out = torch.empty_like(logits)
    tokens = sampler.greedy(logits)[:, None]
    for _ in range(14):
        want, ref = TS.decode_step(model, ref, tokens)
        got, same = TS.decode_step_into(model, cache, tokens, out)
        assert got is out and same is cache
        assert torch.equal(got, want)
        for a, b in zip(leaves(cache), leaves(ref)):
            assert torch.equal(a, b)
        tokens = sampler.greedy(want)[:, None]
    assert addresses == [t.data_ptr() for t in leaves(cache)]
    assert cache["pos"].tolist() == [8 + 30 + 14] * 2


@pytest.mark.parametrize("max_len", (16, 40, 41))
def test_init_cache_matches_reference_layout(max_len):
    jcfg, tcfg = _configs("float32")
    cj = JS.init_cache(jcfg, 3, max_len)
    ct = TS.init_cache(tcfg, 3, max_len, device="cpu")
    assert ct["pos"].dtype == torch.int32
    assert ct["layers"][0]["k"].shape[1] == min(max_len, 40)
    _assert_caches(ct, cj, "float32")
    dtypes = jax.tree_util.tree_map(lambda a: str(a.dtype), cj["v0"])
    assert dtypes == {"k": "float32", "v": "float32",
                      "mamba": {"h": "float32", "conv": "float32"}}


# ---------------------------------------------------------------------------
# Weights, configs, the entry point, the kernels' operands
# ---------------------------------------------------------------------------


def test_lm_params_from_numpy_layer_order_and_meta():
    jcfg, tcfg = _configs("float32")
    jp = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    jp["blocks_v0"]["ln_attn"]["scale"] = np.stack(
        [np.full(40, g, np.float32) for g in range(2)])
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    for i, block in enumerate(model.blocks):
        assert isinstance(block, TT.HymbaLayer)
        assert float(block.ln_attn["scale"][0]) == i
        assert torch.equal(block.mamba.w_bcdt["w"], torch.from_numpy(
            jp["blocks_v0"]["mamba"]["w_bcdt"]["w"][i]))
    assert torch.equal(model.meta, torch.from_numpy(jp["meta"]))
    jp["blocks_v0"]["mamba"]["conv"] = jp["blocks_v0"]["mamba"]["conv"][:, 1:]
    with pytest.raises(ValueError, match="mamba.conv: reference"):
        convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    del jp["meta"]
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_numpy(jp, tcfg, device="cpu")


def test_init_params_is_shaped_like_reference_and_cast_params_equals_it():
    jcfg, tcfg = _configs("bfloat16")
    m16 = TT.init_params(tcfg, seed=3, device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)),
        jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    for name, p in m16.named_parameters():
        parts = name.split(".")
        node = jshapes
        if parts[0] == "blocks":
            node, parts = jshapes["blocks_v0"], parts[2:]
        for k in parts:
            node = node[k]
        shape = node[0][1:] if name.startswith("blocks") else node[0]
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).replace("torch.", "") == node[1], name
    m32 = TT.init_params(dataclasses.replace(tcfg, dtype="float32"), seed=3,
                         device="cpu")
    cast = TT.cast_params(m32, tcfg)
    assert cast.cfg == tcfg
    for (n1, a), (n2, b) in zip(cast.named_parameters(),
                                m16.named_parameters(), strict=True):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b), n1
        assert not a.requires_grad


@pytest.mark.parametrize("smoke", (False, True))
def test_hymba_configs_match_reference(smoke):
    t = registry.get_config("hymba-1.5b", smoke=smoke)
    j = jregistry.get_config("hymba-1.5b", smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.sub_quadratic and j.sub_quadratic
    if not smoke:
        assert 1.55e9 < t.n_params() < 1.65e9


def test_full_width_shapes_and_launches():
    """hymba-1.5b: 32 dwconv1d + 352 pwconv a prefill, 0 + 352 a decode
    step; the Linears whose Ci or Co is not a multiple of 8 (w_bcdt 3200
    -> 132, w_dt 100 -> 3200) stay on simt in bf16."""
    from repro_torch.kernels import blocking
    cfg = registry.get_config("hymba-1.5b")
    assert tserve.expected_launches(cfg, "prefill") == {"dwconv1d": 32,
                                                        "pwconv": 352}
    assert tserve.expected_launches(cfg, "decode") == {"dwconv1d": 0,
                                                       "pwconv": 352}
    model = TT.LMModel(cfg, generator=torch.Generator(), device="meta")
    linears = {n[:-2]: tuple(p.shape) for n, p in
               model.blocks[0].named_parameters() if n.endswith(".w")}
    assert len(linears) == tserve.LAYER_LAUNCHES["prefill"]["hymba"]["pwconv"]
    assert linears["mamba.w_bcdt"] == (3200, 132)
    assert linears["mamba.w_dt"] == (100, 3200)
    g = 8 * (1536 + 128)
    simt = {k for k, (ci, co) in linears.items()
            if blocking.pw_variant(g, ci, co, torch.bfloat16) == "simt"}
    assert simt == {"mamba.w_bcdt", "mamba.w_dt"}


def test_hymba_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = registry.get_config("hymba-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "hymba-1.5b", "--smoke"])
    model = TT.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        TS.capture_prefill(model, 1, 4)
    with pytest.raises(ValueError, match="on the card"):
        TS.capture_decode_step(model, 1, 16)


def test_serve_launcher_runs_hymba_on_the_cpu(capsys):
    rc = tserve.main(["--arch", "hymba-1.5b", "--smoke", "--batch", "2",
                      "--prompt-len", "40", "--gen", "3", "--max-len", "60",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "[serve] hymba-1.5b-smoke on cpu" in out
    assert "'pwconv': 0" in out        # CPU tensors launch no kernel


def test_operands_reach_the_kernels_contiguous(monkeypatch):
    """On the card the kernel wrappers refuse strided operands: every
    operand the hymba serving path hands to ``pwconv`` or ``dwconv1d`` is
    contiguous (the Mamba conv's input is a half of ``w_in``'s output, and
    ``w_dt``'s a column slice of ``w_bcdt``'s), in prefill (dense and
    blockwise) and in decode, and the conv filter has the input's dtype."""
    from repro_torch.core import dwconv as core_dw
    from repro_torch.core import pwconv as core_pw
    from repro_torch.kernels import ops
    seen = {"pwconv": 0, "dwconv1d": 0}

    def checked(name, fn):
        def wrapper(x, w, *args, **kwargs):
            assert x.is_contiguous() and w.is_contiguous(), name
            if name == "dwconv1d":
                assert x.dtype == w.dtype
            seen[name] += 1
            return fn(x, w, *args, **kwargs)
        return wrapper
    monkeypatch.setattr(core_pw.ops, "pwconv", checked("pwconv", ops.pwconv))
    monkeypatch.setattr(core_dw.ops, "dwconv1d_causal",
                        checked("dwconv1d", ops.dwconv1d_causal))
    for dtype in DTYPES:
        model = TT.init_params(_configs(dtype)[1], device="cpu")
        for s, max_len in PROMPTS.items():
            _, tt = _tokens(2, s, 0)
            logits, cache = TS.prefill(model, tt, max_len=max_len)
            TS.decode_step(model, cache, sampler.greedy(logits)[:, None])
    assert seen == {"pwconv": 2 * 2 * 2 * 22, "dwconv1d": 2 * 2 * 2}
