"""The encoder-decoder slice of the port (whisper-small) against the JAX
reference on ``whisper_small.smoke_config()``: cross attention and the
bidirectional blockwise attention over padded keys, the encoder,
``hidden_states``, ``prefill`` (logits, the self-attention cache and the
encoder's K/V), decode steps from the reference's prefilled cache,
``generate``, the registry and the shapes.

The reference's ``prefill_by_stepping`` never runs the encoder (its
cross attention reads the zeroed ``enc_k``/``enc_v``), so it is no oracle
here: decode steps are held against the reference's ``decode_step`` from
the reference's own ``prefill``.  The reference's encoder is a
``lax.scan`` whatever ``scan_layers`` says, which a bf16 dot cannot run in
on this jax's CPU: bf16 is held layer by layer (the reference's
``layer_forward`` and ``layer_decode`` op by op), fp32 end to end.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (BLOCK_TOL, LM_DTYPES, TORCH, assert_caches,
                           assert_close, configs, jtree, lm_tokens, perturbed,
                           port_cache, rand, to_jax, to_torch)
from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve import sampler as jsampler
from repro.serve import serve_step as JS
from repro_torch import convert, graphs
from repro_torch.configs import base as tbase
from repro_torch.configs import registry
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve import sampler as tsampler
from repro_torch.serve import serve_step as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-small"
#: The smoke config's chunk (64: every attention dense) and 16, under
#: which the encoder's self-attention over its 24 frames and the decoder's
#: cross attention are blockwise with 8 padded keys masked.
CHUNKS = (64, 16)
PROMPT, MAX_LEN = 10, 24


_MODELS = {}


def whisper(dtype: str, chunk: int = 64):
    """(reference config, reference params, port model) of the smoke
    config at ``attn_chunk=chunk``, the port's weights carried from the
    reference's (every zero leaf, norm scales and biases, made nonzero)."""
    key = (dtype, chunk)
    if key not in _MODELS:
        jcfg, tcfg = configs(ARCH, dtype, attn_chunk=chunk)
        jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(0)))
        _MODELS[key] = (jcfg, jtree(jp),
                        convert.lm_params_from_numpy(jp, tcfg, device="cpu"))
    return _MODELS[key]


def frames(cfg, b: int, seed: int, dtype: str = "float32"):
    f = rand(np.random.default_rng(seed), (b, cfg.encdec.enc_seq,
                                           cfg.d_model), 0.5)
    return to_jax(f, dtype), to_torch(f, dtype)


def _layer(jp, key, g):
    return jax.tree_util.tree_map(lambda a: a[g], jp[key])


def ref_encoder(jcfg, jp, fj):
    """The reference's ``_run_encoder``, its layers run one by one (the
    same ``layer_forward`` calls outside the scan)."""
    x = fj + jp["enc_pos"][None].astype(fj.dtype)
    for g in range(jcfg.encdec.n_enc_layers):
        x, _ = JT.layer_forward(_layer(jp, "enc_blocks", g), x, jcfg,
                                JT.LayerVariant(kind="attn_mlp"),
                                causal=False)
    return JT.norm(x, jp["enc_ln_final"], jcfg.norm_type)


# ---------------------------------------------------------------------------
# Attention: cross attention, bidirectional blockwise over padded keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_cross_attention_matches_reference(dtype, chunk):
    """``attention(xkv=...)``: q from the decoder's 10 positions, K/V from
    24 encoder rows, no mask and no RoPE; at chunk 16 the blockwise path
    with the keys padded to 32."""
    jcfg, jp, model = whisper(dtype, chunk)
    rng = np.random.default_rng(chunk)
    x = rand(rng, (2, PROMPT, jcfg.d_model), 0.5)
    src = rand(rng, (2, jcfg.encdec.enc_seq, jcfg.d_model), 0.5)
    kw = dict(n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
              head_dim=jcfg.head_dim, chunk=chunk, return_kv=True)
    yj, kvj = JA.attention(_layer(jp, "blocks_v0", 0)["cross"],
                           to_jax(x, dtype), xkv=to_jax(src, dtype), **kw)
    yt, kvt = TA.attention(model.blocks[0].cross, to_torch(x, dtype),
                           xkv=to_torch(src, dtype), **kw)
    assert yt.dtype == TORCH[dtype]
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    for got, want in zip(kvt, kvj, strict=True):
        assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_blockwise_over_padded_keys_matches_reference(dtype, causal):
    """The blockwise core at chunk 16 over 24 positions (8 padded keys,
    masked), bidirectional as the encoder runs it and causal, against the
    reference's and against the dense path."""
    rng = np.random.default_rng(5)
    q, k, v = (rand(rng, (2, 24, h, 8)) for h in (4, 2, 2))
    want = JA.blockwise_attention(to_jax(q, dtype), to_jax(k, dtype),
                                  to_jax(v, dtype), causal=causal, chunk=16)
    got = TA.blockwise_attention(to_torch(q, dtype), to_torch(k, dtype),
                                 to_torch(v, dtype), causal=causal, chunk=16)
    assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)
    dense = TA.dense_attention(to_torch(q, dtype), to_torch(k, dtype),
                               to_torch(v, dtype), causal=causal)
    assert_close(got, dense.float().numpy(), dtype, fp32_tol=BLOCK_TOL)


# ---------------------------------------------------------------------------
# Layers, encoder, hidden states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_encoder_matches_reference(dtype, chunk):
    """``run_encoder`` (frames + enc_pos, bidirectional layers with RoPE at
    the frame positions, the final LayerNorm) against the reference's
    layers; in fp32 also against ``_run_encoder`` itself."""
    jcfg, jp, model = whisper(dtype, chunk)
    fj, ft = frames(jcfg, 2, 1, dtype)
    got = TT.run_encoder(model, ft)
    assert got.dtype == TORCH[dtype]
    assert_close(got, ref_encoder(jcfg, jp, fj), dtype, fp32_tol=BLOCK_TOL)
    if dtype == "float32":
        assert_close(got, JT._run_encoder(jcfg, jp, fj, JT.DEFAULT_POLICY),
                     dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_dec_layer_forward_matches_reference(dtype, chunk):
    """One ``dec`` layer over 10 positions with an encoder output of 24
    rows: its output, self-attention K/V and cross attention K/V."""
    jcfg, jp, model = whisper(dtype, chunk)
    rng = np.random.default_rng(2)
    x = rand(rng, (2, PROMPT, jcfg.d_model), 0.5)
    enc = rand(rng, (2, jcfg.encdec.enc_seq, jcfg.d_model), 0.5)
    pos = np.broadcast_to(np.arange(PROMPT), (2, PROMPT))
    yj, aj = JT.layer_forward(_layer(jp, "blocks_v0", 1), to_jax(x, dtype),
                              jcfg, JT.LayerVariant(kind="dec"),
                              positions=jnp.asarray(pos),
                              xkv=to_jax(enc, dtype), capture_kv=True)
    assert model.variant(1) == TT.LayerVariant(kind="dec")
    yt, at = TT.layer_forward(model.blocks[1], to_torch(x, dtype), model.cfg,
                              model.variant(1),
                              positions=torch.from_numpy(pos.copy()),
                              xkv=to_torch(enc, dtype), capture_kv=True)
    assert set(at) == set(aj) == {"kv", "cross_kv"}
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    for name in ("kv", "cross_kv"):
        for got, want in zip(at[name], aj[name], strict=True):
            assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_dec_layer_decode_matches_reference(dtype):
    """One ``dec`` layer stepped 6 tokens from a zeroed cache with the
    encoder's K/V: the port projects the cross query alone, the reference
    all three (same numbers)."""
    jcfg, jp, model = whisper(dtype)
    rng = np.random.default_rng(4)
    ek, ev = (rand(rng, (2, jcfg.encdec.enc_seq, jcfg.n_kv_heads,
                         jcfg.head_dim)) for _ in range(2))
    variant = JT.LayerVariant(kind="dec")
    cj = JT.init_layer_cache(jcfg, variant, 2, MAX_LEN)
    ct = TT.init_layer_cache(model.cfg, model.variant(0), 2, MAX_LEN,
                             device="cpu")
    for t in range(6):
        x = rand(rng, (2, 1, jcfg.d_model), 0.5)
        pos = np.full((2,), t, np.int32)
        yj, cj = JT.layer_decode(_layer(jp, "blocks_v0", 0), to_jax(x, dtype),
                                 cj, jnp.asarray(pos), jcfg, variant,
                                 enc_kv=(to_jax(ek, dtype), to_jax(ev, dtype)))
        yt, ct = TT.layer_decode(model.blocks[0], to_torch(x, dtype), ct,
                                 torch.from_numpy(pos), model.cfg,
                                 model.variant(0),
                                 enc_kv=(to_torch(ek, dtype),
                                         to_torch(ev, dtype)))
        assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    for name in ("k", "v"):
        assert_close(ct[name], cj[name], dtype, fp32_tol=BLOCK_TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_hidden_states_matches_reference(chunk):
    """``hidden_states`` with the frames: no prefix, the decoder's final
    hidden states and ``aux["enc_out"]``."""
    jcfg, jp, model = whisper("float32", chunk)
    tj, tt = lm_tokens(2, PROMPT, 3)
    fj, ft = frames(jcfg, 2, 3)
    xj, pj, aj = JT.hidden_states(jcfg, jp, tj, frontend=fj)
    xt, pt, at = TT.hidden_states(model, tt, frontend=ft)
    assert pt == pj == 0
    assert_close(xt, xj, "float32", fp32_tol=BLOCK_TOL)
    assert_close(at["enc_out"], aj["enc_out"], "float32", fp32_tol=BLOCK_TOL)
    with pytest.raises(ValueError, match="encoder frames"):
        TT.hidden_states(model, tt)


# ---------------------------------------------------------------------------
# Serving: prefill, decode steps, generate
# ---------------------------------------------------------------------------


_PREFILLS = {}


def ref_prefill(chunk: int):
    if chunk not in _PREFILLS:
        jcfg, jp, _ = whisper("float32", chunk)
        tj, _ = lm_tokens(2, PROMPT, 6)
        fj, _ = frames(jcfg, 2, 6)
        _PREFILLS[chunk] = JS.prefill(jcfg, jp, tj, max_len=MAX_LEN,
                                      frontend=fj)
    return _PREFILLS[chunk]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_prefill_matches_reference(chunk):
    """``prefill``'s last logits, its self-attention cache and the
    encoder's K/V (n_layers, B, 24, Hkv, dh) in the model's dtype."""
    jcfg, jp, model = whisper("float32", chunk)
    _, tt = lm_tokens(2, PROMPT, 6)
    _, ft = frames(jcfg, 2, 6)
    lj, cj = ref_prefill(chunk)
    lt, ct = TS.prefill(model, tt, max_len=MAX_LEN, frontend=ft)
    assert lt.dtype == torch.float32 and bool(torch.isfinite(lt).all())
    assert ct["enc_k"].shape == (jcfg.n_layers, 2, jcfg.encdec.enc_seq,
                                 jcfg.n_kv_heads, jcfg.head_dim)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    assert_caches(ct, cj, "float32", model.cfg)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_decode_steps_match_reference(chunk):
    """Eight greedy decode steps from the reference's prefilled cache,
    each taken by the port from the reference's cache; the encoder's K/V
    pass through unchanged."""
    jcfg, jp, model = whisper("float32", chunk)
    lj, cj = ref_prefill(chunk)
    tok = jsampler.greedy(lj)[:, None]
    for _ in range(8):
        ct_in = port_cache(cj, model.cfg)
        lt, ct = TS.decode_step(model, ct_in, torch.from_numpy(
            np.array(tok)).long())
        lj, cj = JS.decode_step(jcfg, jp, cj, tok)
        assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
        assert_caches(ct, cj, "float32", model.cfg)
        assert ct["enc_k"] is ct_in["enc_k"] and ct["enc_v"] is ct_in["enc_v"]
        tok = jsampler.greedy(lj)[:, None]


def test_decode_step_into_keeps_the_encoder_cache():
    """The body ``capture_decode_step`` captures, on the CPU: the logits
    and cache of the functional step, every tensor of the static cache at
    its address and the encoder's K/V never written."""
    jcfg, _, model = whisper("float32")
    _, tt = lm_tokens(2, PROMPT, 8)
    _, ft = frames(jcfg, 2, 8)
    logits, ref = TS.prefill(model, tt, max_len=MAX_LEN, frontend=ft)
    cache = TS.init_cache(model.cfg, 2, MAX_LEN, "cpu")
    graphs.copy_tree_(cache, ref)
    enc = [cache["enc_k"].clone(), cache["enc_v"].clone()]
    addresses = [cache[k].data_ptr() for k in ("pos", "enc_k", "enc_v")]
    out = torch.empty_like(logits)
    tok = tsampler.greedy(logits)[:, None]
    for _ in range(5):
        want, ref = TS.decode_step(model, ref, tok)
        got, same = TS.decode_step_into(model, cache, tok, out)
        assert same is cache and got is out
        assert torch.equal(got, want)
        assert torch.equal(cache["layers"][1]["k"], ref["layers"][1]["k"])
        tok = tsampler.greedy(want)[:, None]
    assert [cache[k].data_ptr() for k in ("pos", "enc_k", "enc_v")] == \
        addresses
    assert torch.equal(cache["enc_k"], enc[0])
    assert torch.equal(cache["enc_v"], enc[1])


def test_generate_matches_reference():
    """Greedy generation of 6 tokens equals the reference's; sampling with
    a fixed generator is reproducible, and at ``top_k=1`` gives the greedy
    tokens."""
    jcfg, jp, model = whisper("float32")
    tj, tt = lm_tokens(2, PROMPT, 12)
    fj, ft = frames(jcfg, 2, 12)
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=MAX_LEN, frontend=fj)
    lt, ct = TS.prefill(model, tt, max_len=MAX_LEN, frontend=ft)
    toks_j, _ = jsampler.generate(
        lambda c, t: JS.decode_step(jcfg, jp, c, t), cj,
        jsampler.greedy(lj)[:, None], 6, jax.random.PRNGKey(2))
    step = lambda c, t: TS.decode_step(model, c, t)  # noqa: E731
    first = tsampler.greedy(lt)[:, None]
    toks_t, _ = tsampler.generate(step, ct, first, 6)
    assert np.array_equal(toks_t.numpy(), np.asarray(toks_j))
    sampled = [tsampler.generate(step, ct, first, 6,
                                 torch.Generator().manual_seed(3),
                                 temperature=0.8)[0] for _ in range(2)]
    assert torch.equal(sampled[0], sampled[1])
    assert int(sampled[0].min()) >= 0
    assert int(sampled[0].max()) < jcfg.vocab_size
    top1 = tsampler.generate(step, ct, first, 6,
                             torch.Generator().manual_seed(3),
                             temperature=0.8, top_k=1)[0]
    assert torch.equal(top1, toks_t)


@pytest.mark.parametrize("kv_quant", (False, True))
def test_kv_quant_keeps_the_encoder_cache_in_the_model_dtype(kv_quant):
    """Under ``kv_quant`` only the self-attention cache is int8; the
    encoder's K/V stay in the model's dtype, equal to the unquantized
    prefill's."""
    jcfg, jp, model = whisper("float32")
    _, tt = lm_tokens(2, PROMPT, 9)
    _, ft = frames(jcfg, 2, 9)
    m = model
    if kv_quant:
        m = convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp),
            dataclasses.replace(model.cfg, kv_quant=True), device="cpu")
    lt, ct = TS.prefill(m, tt, max_len=MAX_LEN, frontend=ft)
    _, c32 = TS.prefill(model, tt, max_len=MAX_LEN, frontend=ft)
    assert ct["layers"][0]["k"].dtype == (torch.int8 if kv_quant
                                          else torch.float32)
    assert ct["enc_k"].dtype == torch.float32
    assert torch.equal(ct["enc_k"], c32["enc_k"])
    assert torch.equal(ct["enc_v"], c32["enc_v"])
    logits, _ = TS.decode_step(m, ct, tsampler.greedy(lt)[:, None])
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# Configs, registry, shapes, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_registry_round_trip_for_every_reference_id(arch, smoke):
    """Every reference id resolves to the reference's config, field for
    field (whisper-small's ``encdec`` included)."""
    t = registry.get_config(arch, smoke=smoke)
    j = jregistry.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.head_dim == j.head_dim


def test_whisper_config_is_the_reference_field_for_field():
    t, j = registry.get_config(ARCH), jregistry.get_config(ARCH)
    for f in dataclasses.fields(tbase.ModelConfig):
        want = getattr(j, f.name)
        got = getattr(t, f.name)
        if f.name == "encdec":
            assert isinstance(got, tbase.EncDecConfig)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert (t.encdec.n_enc_layers, t.encdec.enc_seq, t.d_model, t.n_layers,
            t.vocab_size) == (12, 1500, 768, 12, 51865)
    assert {f.name for f in dataclasses.fields(tbase.EncDecConfig)} == {
        f.name for f in dataclasses.fields(jbase.EncDecConfig)}


@pytest.mark.parametrize("shape", list(tbase.SHAPES))
def test_input_specs_match_reference(shape):
    for smoke in (False, True):
        t = tbase.input_specs(registry.get_config(ARCH, smoke=smoke), shape)
        j = jbase.input_specs(jregistry.get_config(ARCH, smoke=smoke), shape)
        assert set(t) == set(j)
        for k in t:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == tuple(j[k].shape), k
            assert str(t[k].dtype).replace("torch.", "") == str(j[k].dtype)


@pytest.mark.parametrize("kv_quant", (False, True))
@pytest.mark.parametrize("smoke", (False, True))
def test_cache_specs_match_reference(smoke, kv_quant):
    """``cache_specs`` at batch 8 and 448 positions (whisper's decoder
    context): the self-attention cache per layer and the encoder's K/V
    (442 MB in bf16 at full width), against the reference's
    ``jax.eval_shape``."""
    jcfg = dataclasses.replace(jregistry.get_config(ARCH, smoke=smoke),
                               kv_quant=kv_quant)
    tcfg = dataclasses.replace(registry.get_config(ARCH, smoke=smoke),
                               kv_quant=kv_quant)
    j = JS.cache_specs(jcfg, 8, 448)
    t = TS.cache_specs(tcfg, 8, 448)
    for name in ("enc_k", "enc_v"):
        assert tuple(t[name].shape) == tuple(j[name].shape)
        assert str(t[name].dtype).replace("torch.", "") == str(j[name].dtype)
    for i, layer in enumerate(t["layers"]):
        for k, v in layer.items():
            assert tuple(v.shape) == tuple(j["v0"][k].shape[1:]), k
            assert str(v.dtype).replace("torch.", "") == str(j["v0"][k].dtype)
    if not smoke:
        assert t["enc_k"].numel() * 2 * 2 == 8 * 12 * 1500 * 768 * 4


def test_expected_launches_count_the_encoder():
    """A prefill launches ``pwconv`` 7 times an encoder layer and 11 times a
    decoder layer; a decode step 9 times a decoder layer (the cross
    attention's K/V are cached)."""
    cfg = registry.get_config(ARCH)
    assert tserve.expected_launches(cfg, "prefill") == {
        "dwconv1d": 0, "pwconv": 12 * 7 + 12 * 11}
    assert tserve.expected_launches(cfg, "decode") == {
        "dwconv1d": 0, "pwconv": 12 * 9}
    assert tserve.frontend_len(cfg) == 1500


def test_frontend_stub_draws_frames_from_the_seed():
    cfg = registry.get_config(ARCH, smoke=True)
    a = tserve.frontend_stub(cfg, 2, "cpu", seed=0)
    assert a.shape == (2, 24, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, tserve.frontend_stub(cfg, 2, "cpu", seed=0))
    assert not torch.equal(a, tserve.frontend_stub(cfg, 2, "cpu", seed=1))
    assert float(a.std()) > 0.5


def test_launcher_serves_whisper_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
         "--gen", "4", "--max-len", "16"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "[serve] whisper-small-smoke on cpu" in out.stdout
    assert "sample tokens" in out.stdout
