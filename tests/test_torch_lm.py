"""The port's xLSTM serving slice on the CPU, held against the JAX package.

Seeded numpy inputs and reference weights (``repro.models``' own inits,
with the zero-initialized norm scales and biases perturbed so that they
count) go through the reference on its ``impl="xla"`` path and through
``repro_torch`` with the weights carried by ``convert.lm_params_from_numpy``
/ ``convert.load_tree_``.  ``dwconv1d_causal_pallas`` still runs in
interpret mode on this jax, so the conv is held against it too.

Tolerances: fp32 ops 2e-5 (rtol = atol), fp32 blocks and logits 1e-4
(the reference's own, ``tests/test_ssm_xlstm.py``), bf16 ``BF16_REL_TOL``
relative to the largest magnitude.

bf16 and the reference: compiled as a whole (under ``jit``, or inside a
``lax.scan``), the reference's bf16 x bf16 -> fp32 dots fail on this jax's
CPU runtime ("Unsupported element type for DotThunk").  Its bf16 model
runs therefore go op by op with ``scan_layers=False``, with its
``prefill_by_stepping`` scan written as a loop of the same decode steps,
and within one mLSTM chunk, where no scan over chunks is compiled; longer
bf16 prompts are checked layer by layer.
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
from repro.configs import registry as jregistry  # noqa: E402
from repro.configs import xlstm_125m as jcfg_mod  # noqa: E402
from repro.core import dwconv as jdwconv  # noqa: E402
from repro.core import pwconv as jpwconv  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dwconv1d import dwconv1d_causal_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs import xlstm_125m as tcfg_mod  # noqa: E402
from repro_torch.core import dwconv as tdwconv  # noqa: E402
from repro_torch.core import pwconv as tpwconv  # noqa: E402
from repro_torch.kernels import dwconv1d, ops, ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.serve import sampler  # noqa: E402
from repro_torch.serve import serve_step as TS  # noqa: E402

DTYPES = ("float32", "bfloat16")
#: fp32 blocks and logits (the reference's own, tests/test_ssm_xlstm.py).
BLOCK_TOL = 1e-4

#: (B, L, D, K, block_l, block_d): tests/test_kernels.py's DW1D_CASES, and
#: L < K-1.
DW1D_CASES = [(1, 16, 8, 4, 8, 8), (2, 100, 48, 4, 32, 16),
              (2, 64, 64, 3, 64, 64), (1, 37, 20, 5, 8, 8),
              (2, 2, 6, 4, 8, 8)]


def assert_close(got, want, dtype: str, fp32_tol: float = FP32_TOL):
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=fp32_tol,
                                   atol=fp32_tol)
    else:
        assert rel_err(got, want) <= BF16_REL_TOL, rel_err(got, want)


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


# ---------------------------------------------------------------------------
# dwconv1d: the op, the kernel wrapper's CPU path, the decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,d,k,bl,bd", DW1D_CASES)
def test_dwconv1d_causal_matches_reference(b, l, d, k, bl, bd, dtype):
    rng = np.random.default_rng(k + l)
    x, f = rand(rng, (b, l, d)), rand(rng, (k, d), k ** -0.5)
    xt, ft = to_torch(x, dtype), to_torch(f, dtype)
    want = jref.dwconv1d_causal_ref(to_jax(x, dtype), to_jax(f, dtype))
    assert_close(ops.dwconv1d_causal(xt, ft), want, dtype)
    assert_close(dwconv1d.dwconv1d_causal(xt, ft), want, dtype)
    assert_close(tdwconv.depthwise1d_causal(xt, ft),
                 jdwconv.depthwise1d_causal(to_jax(x, dtype),
                                            to_jax(f, dtype)), dtype)
    if min(l, bl) >= k - 1:   # the TPU kernel's carry needs K-1 rows a block
        pallas = dwconv1d_causal_pallas(to_jax(x, dtype), to_jax(f, dtype),
                                        block_l=bl, block_d=bd,
                                        interpret=True)
        assert_close(dwconv1d.dwconv1d_causal_plain(xt, ft), pallas, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,d,k", [(2, 20, 6, 4), (1, 7, 16, 3),
                                     (2, 5, 8, 5), (1, 4, 8, 1)])
def test_dwconv1d_step_matches_reference_and_full(b, l, d, k, dtype):
    rng = np.random.default_rng(l * d)
    x, f = rand(rng, (b, l, d)), rand(rng, (k, d), k ** -0.5)
    xt, ft = to_torch(x, dtype), to_torch(f, dtype)
    st = tdwconv.init_conv_state(b, k, d, dtype=xt.dtype, device="cpu")
    sj = jdwconv.init_conv_state(b, k, d, dtype=to_jax(x, dtype).dtype)
    assert tuple(st.shape) == tuple(sj.shape)
    outs_t, outs_j = [], []
    for t in range(l):
        st, yt = tdwconv.depthwise1d_step(st, xt[:, t], ft)
        sj, yj = jref.dwconv1d_step_ref(sj, to_jax(x[:, t], dtype),
                                        to_jax(f, dtype))
        outs_t.append(yt)
        outs_j.append(yj)
    assert_close(torch.stack(outs_t, 1), jnp.stack(outs_j, 1), dtype)
    assert_close(st, sj, dtype)
    if k > 1:
        assert_close(torch.stack(outs_t, 1),
                     ref.dwconv1d_causal_ref(xt, ft), dtype)


def test_dwconv1d_wrapper_checks():
    m = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA tensors"):
        dwconv1d.dwconv1d_causal(m(1, 4, 8), m(3, 8))
    with pytest.raises(ValueError, match="dwconv1d shapes"):
        dwconv1d.dwconv1d_causal(torch.zeros(1, 4, 8), torch.zeros(3, 6))
    with pytest.raises(ValueError, match="a tap and a row"):
        dwconv1d.dwconv1d_causal(torch.zeros(1, 4, 8), torch.zeros(3, 8),
                                 rows=0)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.dwconv1d_causal(torch.zeros(1, 4, 8), torch.zeros(3, 8),
                            impl="cuda")


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (1536, torch.float32, True, 4), (1536, torch.bfloat16, True, 8),
    (1000, torch.bfloat16, True, 8), (1002, torch.float32, True, 1),
    (20, torch.bfloat16, True, 1), (64, torch.float32, False, 1)])
def test_dwconv1d_vector_width(d, dtype, aligned, want):
    """16-byte vectors of channels where D divides into them and both
    operands are 16-byte aligned; else one channel per thread."""
    buf = torch.zeros(3 * d + 1, dtype=dtype)
    x = (buf[:3 * d] if aligned else buf[1:]).reshape(1, 3, d)
    f = torch.zeros((4, d), dtype=dtype)
    assert dwconv1d.vector_width(x, f) == want


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_linear_embedding_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rand(rng, (2, 5, 24), 2.0)
    scale, bias = rand(rng, (24,), 0.3), rand(rng, (24,), 0.3)
    xt, xj = to_torch(x, dtype), to_jax(x, dtype)
    assert_close(tlayers.rms_norm(xt, to_torch(scale)),
                 jlayers.rms_norm(xj, to_jax(scale)), dtype)
    assert_close(tlayers.layer_norm(xt, to_torch(scale), to_torch(bias)),
                 jlayers.layer_norm(xj, to_jax(scale), to_jax(bias)), dtype)
    p_t = {"scale": to_torch(scale), "bias": to_torch(bias)}
    p_j = {"scale": to_jax(scale), "bias": to_jax(bias)}
    for kind in ("rms", "layer"):
        assert_close(tlayers.norm(xt, p_t, kind), jlayers.norm(xj, p_j, kind),
                     dtype)
    w, b = rand(rng, (24, 40), 24 ** -0.5), rand(rng, (40,), 0.2)
    for act in (None, "silu"):
        got = tlayers.linear({"w": to_torch(w, dtype), "b": to_torch(b, dtype)},
                             xt, activation=act)
        want = jlayers.linear({"w": to_jax(w, dtype), "b": to_jax(b, dtype)},
                              xj, activation=act)
        assert got.dtype == xt.dtype
        assert_close(got, want, dtype)
    assert_close(tpwconv.pointwise(xt, to_torch(w, dtype)),
                 jpwconv.pointwise(xj, to_jax(w, dtype)), dtype)
    table = rand(rng, (50, 24), 0.2)
    toks = rng.integers(0, 50, (2, 5))
    emb = tlayers.embed({"table": to_torch(table, dtype)},
                        torch.from_numpy(toks))
    assert_close(emb, jlayers.embed({"table": to_jax(table, dtype)},
                                    jnp.asarray(toks)), dtype)
    logits = tlayers.unembed_logits(xt, to_torch(table, dtype))
    assert logits.dtype == torch.float32
    assert_close(logits, jlayers.unembed_logits(xj, to_jax(table, dtype)),
                 dtype)


def test_layer_inits_have_the_reference_shapes_and_dtypes():
    g = torch.Generator().manual_seed(0)
    lin = tlayers.init_linear(g, 6, 9, bias=True, dtype=torch.bfloat16,
                              device="cpu")
    jlin = jlayers.init_linear(jax.random.PRNGKey(0), 6, 9, bias=True,
                               dtype=jnp.bfloat16)
    for k in ("w", "b"):
        assert tuple(lin[k].shape) == jlin[k].shape
        assert lin[k].dtype == torch.bfloat16 and not lin[k].requires_grad
    assert float(lin["w"].float().std()) == pytest.approx(6 ** -0.5, rel=0.5)
    n = tlayers.init_norm("layer", 7, with_bias=True, device="cpu")
    assert set(n) == set(jlayers.init_norm("layer", 7, with_bias=True))
    e = tlayers.init_embedding(g, 11, 4, device="cpu")
    assert tuple(e["table"].shape) == (11, 4)


# ---------------------------------------------------------------------------
# Recurrent cells
# ---------------------------------------------------------------------------


def _cell_inputs(b=2, l=40, h=3, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rand(rng, (b, l, h, dh)) for _ in range(3))
    ig = rand(rng, (b, l, h), 2.0)
    lf = np.asarray(jax.nn.log_sigmoid(rand(rng, (b, l, h), 2.0)))
    return q, k, v, ig, lf


def _jt(arrays):
    return ([to_jax(a) for a in arrays], [to_torch(a) for a in arrays])


def test_mlstm_recurrent_matches_reference():
    arrays = _cell_inputs(l=20)
    aj, at = _jt(arrays)
    hj, sj = jx.mlstm_recurrent(*aj)
    ht, st = tx.mlstm_recurrent(*at)
    assert_close(ht, hj, "float32")
    for a, b in zip(st, sj):
        assert_close(a, b, "float32")


@pytest.mark.parametrize("l,chunk", [(40, 8), (40, 16), (40, 40), (37, 8),
                                     (5, 16), (1, 8)])
def test_mlstm_chunkwise_matches_reference(l, chunk):
    """Chunks that divide L, a ragged last chunk, and L shorter than one
    chunk (the NEG_INF pad and the -inf initial m)."""
    aj, at = _jt(_cell_inputs(l=l, seed=l))
    hj, sj = jx.mlstm_chunkwise(*aj, chunk=chunk)
    ht, st = tx.mlstm_chunkwise(*at, chunk=chunk)
    assert bool(torch.isfinite(ht).all())
    assert_close(ht, hj, "float32")
    for a, b in zip(st, sj):
        assert_close(a, b, "float32")
    hr, _ = tx.mlstm_recurrent(*at)
    assert_close(ht, hr, "float32", fp32_tol=2e-4)


def test_mlstm_chunkwise_threads_state_like_reference():
    aj, at = _jt(_cell_inputs(l=32))
    _, sj = jx.mlstm_chunkwise(*(a[:, :16] for a in aj), chunk=8)
    hj, _ = jx.mlstm_chunkwise(*(a[:, 16:] for a in aj), chunk=8, state=sj)
    _, st = tx.mlstm_chunkwise(*(a[:, :16] for a in at), chunk=8)
    ht, _ = tx.mlstm_chunkwise(*(a[:, 16:] for a in at), chunk=8, state=st)
    assert_close(ht, hj, "float32")


@pytest.mark.parametrize("l,jchunk", [(24, 8), (24, 24), (7, 128)])
def test_slstm_scan_matches_reference(l, jchunk):
    """The reference's checkpointed chunks equal its plain scan in
    inference; the port runs the plain loop."""
    rng = np.random.default_rng(l)
    gates = [rand(rng, (2, l, 2, 4)) for _ in range(4)]
    r = rand(rng, (2, 4, 16), 0.5)
    hj, sj = jx.slstm_scan(*map(to_jax, gates), to_jax(r), chunk=jchunk)
    ht, st = tx.slstm_scan(*map(to_torch, gates), to_torch(r))
    assert_close(ht, hj, "float32")
    for a, b in zip(st, sj):
        assert_close(a, b, "float32")


def test_cell_steps_match_reference():
    aj, at = _jt(_cell_inputs(l=1))
    hj, sj = jx.mlstm_step(*(a[:, 0] for a in aj),
                           jx.mlstm_recurrent(*aj)[1])
    ht, st = tx.mlstm_step(*(a[:, 0] for a in at),
                           tx.mlstm_recurrent(*at)[1])
    assert_close(ht, hj, "float32")
    rng = np.random.default_rng(3)
    gates = [rand(rng, (2, 2, 4)) for _ in range(4)]
    r = rand(rng, (2, 4, 16), 0.5)
    state = tuple(rand(rng, (2, 2, 4)) for _ in range(4))
    hj, sj = jx.slstm_step(*map(to_jax, gates), to_jax(r),
                           tuple(map(to_jax, state)))
    ht, st = tx.slstm_step(*map(to_torch, gates), to_torch(r),
                           tuple(map(to_torch, state)))
    assert_close(ht, hj, "float32")
    for a, b in zip(st, sj):
        assert_close(a, b, "float32")


# ---------------------------------------------------------------------------
# Blocks and their step forms
# ---------------------------------------------------------------------------

_JX = jbase.XLSTMConfig(conv_k=4, proj_factor=2.0)
_TX = tbase.XLSTMConfig(conv_k=4, proj_factor=2.0)
_BLOCKS = {"mlstm": (jx.init_mlstm_block, jx.mlstm_block, jx.mlstm_block_step,
                     jx.init_mlstm_cache, tx.MLSTMBlock, tx.init_mlstm_cache),
           "slstm": (jx.init_slstm_block, jx.slstm_block, jx.slstm_block_step,
                     jx.init_slstm_cache, tx.SLSTMBlock, tx.init_slstm_cache)}


def _block_pair(kind, d, nh, dtype, seed):
    jinit, *_, tcls, _ = _BLOCKS[kind]
    jp = perturbed(jinit(jax.random.PRNGKey(seed), d, nh, _JX,
                         dtype=to_jax(np.zeros(1), dtype).dtype), seed)
    block = tcls(d, nh, _TX, generator=torch.Generator().manual_seed(seed),
                 dtype=to_torch(np.zeros(1), dtype).dtype, device="cpu")
    convert.load_tree_(block, convert.flatten_tree(jp))
    return jtree(jp), block


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,l", [("mlstm", 20), ("mlstm", 3),
                                    ("slstm", 20), ("slstm", 2)])
def test_block_forward_and_cache_match_reference(kind, l, dtype):
    _, jfwd, *_ = _BLOCKS[kind]
    d, nh, b = 24, 2, 2
    jp, block = _block_pair(kind, d, nh, dtype, seed=l)
    x = rand(np.random.default_rng(l), (b, l, d), 0.5)
    kw = dict(chunk=8) if kind == "mlstm" else {}
    yj, cj = jfwd(jp, to_jax(x, dtype), n_heads=nh, cfg=_JX,
                  return_cache=True, **kw)
    yt, ct = block(to_torch(x, dtype), return_cache=True, **kw)
    assert yt.dtype == to_torch(x, dtype).dtype
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    assert set(ct) == set(cj)
    for key in cj:
        assert ct[key].dtype == torch.float32
        assert_close(ct[key], cj[key], dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_block_step_matches_reference_and_forward(kind, dtype):
    _, _, jstep, jcache, _, tcache = _BLOCKS[kind]
    d, nh, b, l = 24, 2, 2, 10
    jp, block = _block_pair(kind, d, nh, dtype, seed=5)
    x = rand(np.random.default_rng(5), (b, l, d), 0.5)
    cj = jcache(b, d, nh, _JX)
    ct = tcache(b, d, nh, _TX, device="cpu")
    assert set(ct) == set(cj)
    ys_j, ys_t = [], []
    for t in range(l):
        yj, cj = jstep(jp, to_jax(x[:, t:t + 1], dtype), cj, n_heads=nh,
                       cfg=_JX)
        yt, ct = block.step(to_torch(x[:, t:t + 1], dtype), ct)
        ys_j.append(yj)
        ys_t.append(yt)
    assert_close(torch.cat(ys_t, 1), jnp.concatenate(ys_j, 1), dtype,
                 fp32_tol=BLOCK_TOL)
    for key in cj:
        assert_close(ct[key], cj[key], dtype, fp32_tol=BLOCK_TOL)
    kw = dict(chunk=4) if kind == "mlstm" else {}
    assert_close(torch.cat(ys_t, 1), block(to_torch(x, dtype), **kw), dtype,
                 fp32_tol=BLOCK_TOL)


# ---------------------------------------------------------------------------
# The model and the serving path on xlstm_125m.smoke_config()
# ---------------------------------------------------------------------------

#: Prompt lengths: shorter than one mLSTM chunk (attn_chunk // 8 = 8), and
#: a ragged last chunk (fp32).  In bf16 the model is held to the reference
#: within one chunk (module note); longer prompts layer by layer.
PROMPTS = [("float32", 5), ("float32", 21), ("bfloat16", 5),
           ("bfloat16", 8)]


def _configs(dtype):
    return (dataclasses.replace(jcfg_mod.smoke_config(), dtype=dtype,
                                scan_layers=dtype == "float32"),
            dataclasses.replace(tcfg_mod.smoke_config(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _lm(dtype):
    """(reference config, reference params, port config, port model), the
    port's weights carried from the reference's."""
    jcfg, tcfg = _configs(dtype)
    jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    return jcfg, jtree(jp), model


def _tokens(b, s, seed, vocab=128):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


def _ref_prefill_by_stepping(jcfg, jp, tj):
    """The reference's oracle.  It scans decode_step over the prompt; in
    bf16 the same steps run in a Python loop (module note)."""
    if jcfg.dtype == "float32":
        return JS.prefill_by_stepping(jcfg, jp, tj, max_len=64)
    cache = JS.init_cache(jcfg, tj.shape[0], 64)
    for t in range(tj.shape[1]):
        logits, cache = JS.decode_step(jcfg, jp, cache, tj[:, t:t + 1])
    return logits, cache


def _assert_caches(ct, cj, dtype, cfg):
    """The port's per-layer cache against the reference's stacked one."""
    pattern = TT.layer_pattern(cfg)
    assert len(ct["layers"]) == cfg.n_layers
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for i, layer in enumerate(ct["layers"]):
        g, vi = divmod(i, len(pattern))
        ref_layer = cj[f"v{vi}"]
        assert set(layer) == set(ref_layer)
        for key, val in layer.items():
            assert_close(val, ref_layer[key][g], dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("dtype,s", PROMPTS)
def test_hidden_states_and_prefill_match_reference(dtype, s):
    jcfg, jp, model = _lm(dtype)
    tj, tt = _tokens(2, s, s)
    xj, pj, _ = JT.hidden_states(jcfg, jp, tj)
    xt, pt, _ = TT.hidden_states(model, tt)
    assert pt == pj == 0
    assert_close(xt, xj, dtype, fp32_tol=BLOCK_TOL)
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=64)
    lt, ct = TS.prefill(model, tt, max_len=64)
    assert lt.dtype == torch.float32 and bool(torch.isfinite(lt).all())
    assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
    _assert_caches(ct, cj, dtype, model.cfg)


def test_bf16_layers_match_reference_at_a_ragged_prompt():
    """S=21 in bf16: each port layer fed the reference's input to that
    layer.  (Chained, bf16 rounding differences grow through the random
    exponential gates: at this prompt the reference's own bf16 hidden
    states differ from its fp32 ones by about 6% of their largest value.)"""
    jcfg, jp, model = _lm("bfloat16")
    tj, tt = _tokens(2, 21, 21)
    x = jlayers.embed(jp["embedding"], tj)
    assert_close(tlayers.embed(model.embedding, tt), x, "bfloat16")
    for i, block in enumerate(model.blocks):
        g, vi = divmod(i, len(model.pattern))
        p = jax.tree_util.tree_map(lambda a: a[g], jp[f"blocks_v{vi}"])
        if vi == 0:
            y = jx.mlstm_block(p, x, n_heads=jcfg.n_heads, cfg=jcfg.xlstm,
                               chunk=8)
        else:
            y = jx.slstm_block(p, x, n_heads=jcfg.n_heads, cfg=jcfg.xlstm)
        xt = to_torch(np.asarray(x, np.float32), "bfloat16")
        got, _ = TT.layer_forward(block, xt, model.cfg, model.variant(i))
        assert_close(got, y, "bfloat16")
        x = y


def _port_cache(cj, cfg):
    """The reference's stacked cache in the port's per-layer layout."""
    period = len(TT.layer_pattern(cfg))
    return {"pos": torch.from_numpy(np.array(cj["pos"])),
            "layers": [{k: torch.from_numpy(np.array(v[i // period]))
                        for k, v in cj[f"v{i % period}"].items()}
                       for i in range(cfg.n_layers)]}


def test_decode_and_prefill_by_stepping_match_reference_fp32():
    jcfg, jp, model = _lm("float32")
    tj, tt = _tokens(2, 6, 7)
    lj, cj = _ref_prefill_by_stepping(jcfg, jp, tj)
    lt, ct = TS.prefill_by_stepping(model, tt, max_len=64)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    _assert_caches(ct, cj, "float32", model.cfg)
    nj, nt = _tokens(2, 1, 8)
    lj, cj = JS.decode_step(jcfg, jp, cj, nj)
    lt, ct = TS.decode_step(model, ct, nt)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    _assert_caches(ct, cj, "float32", model.cfg)


def test_decode_steps_match_reference_bf16():
    """bf16: every decode step of the reference's stepping prefill, taken by
    the port from the reference's cache (chained, bf16 differences grow
    through the gates as in the layer test above)."""
    jcfg, jp, model = _lm("bfloat16")
    tj, tt = _tokens(2, 6, 7)
    cj = JS.init_cache(jcfg, 2, 64)
    for t in range(tj.shape[1]):
        lt, ct = TS.decode_step(model, _port_cache(cj, model.cfg),
                                tt[:, t:t + 1])
        lj, cj = JS.decode_step(jcfg, jp, cj, tj[:, t:t + 1])
        assert_close(lt, lj, "bfloat16")
        _assert_caches(ct, cj, "bfloat16", model.cfg)


@pytest.mark.parametrize("dtype,s", [("float32", 2), ("float32", 9),
                                     ("bfloat16", 2), ("bfloat16", 9)])
def test_prefill_equals_prefill_by_stepping(dtype, s):
    """The oracle relation on the port itself, S < K-1 included (the conv
    tail is left-padded), then one decode step from each cache."""
    model = _lm(dtype)[2]
    _, tt = _tokens(3, s, 11 + s)
    lp, cp = TS.prefill(model, tt, max_len=32)
    ls, cs = TS.prefill_by_stepping(model, tt, max_len=32)
    assert_close(lp, ls, dtype, fp32_tol=BLOCK_TOL)
    nxt = sampler.greedy(lp)[:, None]
    assert_close(TS.decode_step(model, cp, nxt)[0],
                 TS.decode_step(model, cs, nxt)[0], dtype,
                 fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_generate_matches_reference(dtype):
    """fp32: the same greedy tokens.  bf16: each step taken by the port
    from the reference's cache and token gives the reference's logits."""
    jcfg, jp, model = _lm(dtype)
    tj, tt = _tokens(2, 8, 12)
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=64)
    lt, ct = TS.prefill(model, tt, max_len=64)
    assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
    first_j = jsampler.greedy(lj)[:, None]
    if dtype == "float32":
        toks_j, _ = jsampler.generate(
            lambda c, t: JS.decode_step(jcfg, jp, c, t), cj, first_j, 6,
            jax.random.PRNGKey(2))
        toks_t, _ = sampler.generate(
            lambda c, t: TS.decode_step(model, c, t), ct,
            sampler.greedy(lt)[:, None], 6)
        assert np.array_equal(toks_t.numpy(), np.asarray(toks_j))
        return
    tok_j = first_j
    for _ in range(4):
        lt, _ = TS.decode_step(
            model, _port_cache(cj, model.cfg),
            torch.from_numpy(np.asarray(tok_j).astype(np.int64)))
        lj, cj = JS.decode_step(jcfg, jp, cj, tok_j)
        assert_close(lt, lj, dtype)
        tok_j = jsampler.greedy(lj)[:, None]


def test_init_cache_matches_reference_layout():
    jcfg, tcfg = _configs("float32")
    cj = JS.init_cache(jcfg, 3, 16)
    ct = TS.init_cache(tcfg, 3, 16, device="cpu")
    assert ct["pos"].dtype == torch.int32 and tuple(ct["pos"].shape) == (3,)
    _assert_caches(ct, cj, "float32", tcfg)


# ---------------------------------------------------------------------------
# Weights, configs, samplers, entry point
# ---------------------------------------------------------------------------


def test_lm_params_from_numpy_layer_order():
    """Layer 2g + vi takes blocks_v{vi}[g]."""
    jcfg, tcfg = _configs("float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    groups = tcfg.n_layers // 2
    for vi in range(2):
        jp[f"blocks_v{vi}"]["norm"]["scale"] = np.stack(
            [np.full(tcfg.d_model, 10 * g + vi, np.float32)
             for g in range(groups)])
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    for i, block in enumerate(model.blocks):
        g, vi = divmod(i, 2)
        assert isinstance(block, (tx.MLSTMBlock, tx.SLSTMBlock)[vi])
        assert float(block.norm["scale"][0]) == 10 * g + vi
    assert torch.equal(model.embedding["table"],
                       torch.from_numpy(np.asarray(jp["embedding"]["table"])))
    jp["blocks_v1"]["r"] = jp["blocks_v1"]["r"][..., :-1]
    with pytest.raises(ValueError, match="r: reference"):
        convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    del jp["ln_final"]
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_numpy(jp, tcfg, device="cpu")


def test_init_params_is_seeded_and_shaped_like_reference():
    jcfg, tcfg = _configs("bfloat16")
    m1 = TT.init_params(tcfg, seed=3, device="cpu")
    m2 = TT.init_params(tcfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)),
        jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    period = len(m1.pattern)
    for (name, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p1, p2) and not p1.requires_grad
        parts = name.split(".")
        if parts[0] == "blocks":
            g, vi = divmod(int(parts[1]), period)
            node = jshapes[f"blocks_v{vi}"]
            for k in parts[2:]:
                node = node[k]
            shape, dt = node[0][1:], node[1]
        else:
            shape, dt = jshapes[parts[0]][parts[1]]
        assert tuple(p1.shape) == tuple(shape), name
        assert str(p1.dtype).replace("torch.", "") == dt, name


@pytest.mark.parametrize("smoke", (False, True))
def test_configs_match_reference(smoke):
    t = registry.get_config("xlstm-125m", smoke=smoke)
    j = jregistry.get_config("xlstm-125m", smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.torch_dtype == (torch.bfloat16 if j.jax_dtype == jnp.bfloat16
                             else torch.float32)
    assert registry.list_archs() == jregistry.list_archs()
    with pytest.raises(KeyError):
        registry.get_config("xlstm-350m")


@pytest.mark.parametrize("where", ("registry", "model"))
def test_encoder_decoder_is_ported(where):
    """The encoder-decoder, which the port refused until it was ported:
    the registry gives whisper-small the reference's config, and a model,
    a cache and the launch counts of an enc-dec config built from the
    reference's fields exist (its encoder and ``dec`` layers, the
    encoder's K/V in the cache)."""
    if where == "registry":
        t = registry.get_config("whisper-small", smoke=True)
        j = jregistry.get_config("whisper-small", smoke=True)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        return
    j = jregistry.get_config("whisper-small", smoke=True)
    fields = {f.name for f in dataclasses.fields(tbase.ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(j).items() if k in fields}
    kw["encdec"] = tbase.EncDecConfig(**kw["encdec"])
    cfg = tbase.ModelConfig(**kw)
    model = TT.init_params(cfg, device="cpu")
    assert len(model.enc_blocks) == cfg.encdec.n_enc_layers
    assert tuple(model.enc_pos.shape) == (cfg.encdec.enc_seq, cfg.d_model)
    cache = TS.init_cache(cfg, 1, 16, device="cpu")
    assert tuple(cache["enc_k"].shape) == (cfg.n_layers, 1,
                                           cfg.encdec.enc_seq,
                                           cfg.n_kv_heads, cfg.head_dim)
    assert tserve.expected_launches(cfg, "decode") == {
        "dwconv1d": 0, "pwconv": 9 * cfg.n_layers}


#: Launches of one prefill and one decode step at full width and depth:
#: per layer 7 ``pwconv`` (q, k, v, o, gate, up, down) for an attention-MLP
#: layer, 4 (q, k, v, o) for a MoE layer plus 3 for a shared expert;
#: whisper-small's prefill 7 an encoder layer and 11 a decoder layer, its
#: decode step 9 a decoder layer (the cross attention's K/V are cached).
FULL_WIDTH_LAUNCHES = {
    "whisper-small": ({"dwconv1d": 0, "pwconv": 12 * 7 + 12 * 11},
                      {"dwconv1d": 0, "pwconv": 12 * 9}),
    "xlstm-125m": ({"dwconv1d": 12, "pwconv": 60},
                   {"dwconv1d": 0, "pwconv": 60}),
    "hymba-1.5b": ({"dwconv1d": 32, "pwconv": 352},
                   {"dwconv1d": 0, "pwconv": 352}),
    "smollm-360m": 32 * 7, "qwen3-1.7b": 28 * 7, "internvl2-1b": 24 * 7,
    "command-r-35b": 40 * 7, "qwen1.5-110b": 80 * 7,
    "qwen3-moe-235b-a22b": 94 * 4, "llama4-maverick-400b-a17b": 48 * 7,
}


@pytest.mark.parametrize("arch", tuple(FULL_WIDTH_LAUNCHES))
def test_expected_launches_at_full_width(arch):
    want = FULL_WIDTH_LAUNCHES[arch]
    if isinstance(want, int):
        want = ({"dwconv1d": 0, "pwconv": want},) * 2
    cfg = registry.get_config(arch)
    assert tserve.expected_launches(cfg, "prefill") == want[0]
    assert tserve.expected_launches(cfg, "decode") == want[1]


def test_sample_temperature_zero_is_greedy_and_top_k_masks():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rand(rng, (4, 30), 3.0))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(sampler.sample(logits, g, temperature=0.0),
                       logits.argmax(-1))
    assert np.array_equal(sampler.greedy(logits).numpy(),
                          np.asarray(jsampler.greedy(jnp.asarray(logits))))
    top3 = torch.topk(logits, 3, dim=-1).indices
    seen = set()
    for _ in range(200):
        tok = sampler.sample(logits, g, temperature=1.5, top_k=3)
        assert bool((tok[:, None] == top3).any(-1).all())
        seen.update(tok.tolist())
    assert len(seen) > 4      # more than the argmax of each row
    a = sampler.sample(logits, torch.Generator().manual_seed(5), top_k=3)
    b = sampler.sample(logits, torch.Generator().manual_seed(5), top_k=3)
    assert torch.equal(a, b)


def test_generate_at_temperature_zero_is_the_greedy_loop():
    def step(cache, tok):
        logits = torch.zeros((tok.shape[0], 10))
        logits[torch.arange(tok.shape[0]), (tok[:, 0] + cache) % 10] = 1.0
        return logits, cache + 1
    toks, cache = sampler.generate(step, 1, torch.tensor([[0], [4]]), 4)
    assert cache == 5
    assert toks.tolist() == [[1, 3, 6, 0], [5, 7, 0, 4]]


def test_serve_launcher_runs_on_the_cpu(capsys):
    rc = tserve.main(["--arch", "xlstm-125m", "--smoke", "--batch", "2",
                      "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "[serve] xlstm-125m-smoke on cpu" in out
    assert "'dwconv1d': 0" in out      # CPU tensors launch no kernel


def test_operands_reach_the_kernels_contiguous(monkeypatch):
    """On the card the kernel wrappers refuse strided operands (the halves
    of ``torch.chunk`` are views): every operand the serving path hands to
    ``pwconv`` or ``dwconv1d`` is contiguous, in prefill and in decode."""
    from repro_torch.core import dwconv as core_dw
    from repro_torch.core import pwconv as core_pw
    seen = {"pwconv": 0, "dwconv1d": 0}

    def checked(name, fn):
        def wrapper(x, w, *args, **kwargs):
            assert x.is_contiguous() and w.is_contiguous(), name
            seen[name] += 1
            return fn(x, w, *args, **kwargs)
        return wrapper
    monkeypatch.setattr(core_pw.ops, "pwconv",
                        checked("pwconv", ops.pwconv))
    monkeypatch.setattr(core_dw.ops, "dwconv1d_causal",
                        checked("dwconv1d", ops.dwconv1d_causal))
    for dtype in DTYPES:
        model = TT.init_params(_configs(dtype)[1], device="cpu")
        _, tt = _tokens(2, 5, 0)
        logits, cache = TS.prefill(model, tt, max_len=16)
        TS.decode_step(model, cache, sampler.greedy(logits)[:, None])
    assert seen == {"pwconv": 2 * 40, "dwconv1d": 2 * 4}
