"""The port's attention-MLP serving slice on the CPU, held against the JAX
package: the dense and VLM transformers (smollm-360m, qwen3-1.7b,
internvl2-1b, command-r-35b, qwen1.5-110b), the configs and registry, the
shape set and input specs, the cache specs, and the int8 KV cache.  The
MoE transformers and ``models/moe.py`` are in ``tests/test_torch_moe.py``,
the dense models' prefill, decode steps and generation in
``tests/test_torch_dense_serving.py``; they run the checks of
``_torch_parity.py``.

Seeded numpy weights (the reference's own inits, zero-initialized norm
scales and biases perturbed so that they count) go through the reference
on its ``impl="xla"`` path with ``scan_layers=False`` (its bf16 model runs
op by op) and through ``repro_torch`` with the weights carried by
``convert.lm_params_from_numpy``.  Each arch runs at its
``smoke_config()``: a 20-token prompt takes the dense attention path, a
100-token one (108 positions with internvl2's 8 frontend embeddings) the
blockwise path.

Tolerances: fp32 ops 2e-5; blocks, caches and logits 1e-4; bf16
``BF16_REL_TOL`` of the largest magnitude.  int8 caches: the values equal
the reference's except where a scaled value lies within rounding of a
half, and then by one step (``INT8_FLIPS`` says how many entries, as
measured; the scales within 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (BLOCK_TOL, LM_DTYPES, PROMPTS,  # noqa: E402
                           assert_caches, assert_close, check_cache_specs,
                           check_decode_step_into, check_init_params_and_cast,
                           check_layer_decode, check_layer_forward,
                           int8_diff, lm, lm_frontend, lm_tokens, perturbed,
                           port_cache, rand, ref_prefill_by_stepping, rel_err,
                           to_jax, to_torch)
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro_torch import convert, graphs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import blocking  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import sampler  # noqa: E402
from repro_torch.serve import serve_step as TS  # noqa: E402

DENSE = ("smollm-360m", "qwen3-1.7b", "internvl2-1b", "command-r-35b",
         "qwen1.5-110b")
NEW = DENSE + ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
#: int8 entries that may differ by one step from the reference's over a
#: whole cache (measured: 0 in every case here).
INT8_FLIPS = 0


# ---------------------------------------------------------------------------
# Configs, registry, shape set, input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch, smoke):
    t = registry.get_config(arch, smoke=smoke)
    j = jregistry.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.sub_quadratic == j.sub_quadratic
    assert t.torch_dtype == (torch.bfloat16 if j.jax_dtype == jnp.bfloat16
                             else torch.float32)


def test_registry_lists_every_reference_arch():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.list_archs() == registry.ARCH_IDS
    assert 1.70e9 < registry.get_config("qwen3-1.7b").n_params() < 1.75e9


@pytest.mark.parametrize("smoke", (False, True))
def test_whisper_small_config_matches_reference(smoke):
    """The encoder-decoder, which the registry refused until it was
    ported, resolves to the reference's config field for field; an
    unknown id is a KeyError."""
    t = registry.get_config("whisper-small", smoke=smoke)
    j = jregistry.get_config("whisper-small", smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert TT.model_pattern(t) == [TT.LayerVariant(kind="dec")]
    with pytest.raises(KeyError):
        registry.get_config("whisper-tiny", smoke=smoke)


@pytest.mark.parametrize("arch", NEW)
def test_layer_pattern_matches_reference(arch):
    for smoke in (False, True):
        j = JT.layer_pattern(jregistry.get_config(arch, smoke=smoke))
        t = TT.layer_pattern(registry.get_config(arch, smoke=smoke))
        assert [dataclasses.asdict(v) for v in t] == [
            dataclasses.asdict(v) for v in j]


@pytest.mark.parametrize("shape", tuple(jbase.SHAPES))
@pytest.mark.parametrize("arch", NEW + ("xlstm-125m", "hymba-1.5b"))
def test_input_specs_and_shape_set_match_reference(arch, shape):
    assert tbase.SHAPES == jbase.SHAPES
    tcfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert (tbase.shape_skip_reason(tcfg, shape)
            == jbase.shape_skip_reason(jcfg, shape))
    got, want = tbase.input_specs(tcfg, shape), jbase.input_specs(jcfg, shape)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape, k
        assert str(got[k].dtype) == "torch." + str(spec.dtype), k


# ---------------------------------------------------------------------------
# The layers, the model and the serving path on each smoke config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("arch", DENSE)
def test_layer_forward_matches_reference(arch, s, dtype):
    check_layer_forward(arch, dtype, s)


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_layer_decode_matches_reference(arch, dtype):
    """No dense arch has a window: a plain cache over 12 steps (llama4's
    rings are in tests/test_torch_moe.py)."""
    check_layer_decode(arch, dtype, 24, 12)


@pytest.mark.parametrize("kv_quant", (False, True))
@pytest.mark.parametrize("max_len", (16, 40))
@pytest.mark.parametrize("arch", NEW)
def test_cache_specs_match_reference(arch, max_len, kv_quant):
    check_cache_specs(arch, max_len, kv_quant)


@pytest.mark.parametrize("arch", NEW)
def test_init_params_is_shaped_like_reference_and_cast_params_equals_it(
        arch):
    check_init_params_and_cast(arch)


def test_parallel_block_has_one_norm_and_sequential_two():
    """command-r's parallel residual shares ``ln_attn`` between attention
    and MLP and has no ``ln_mlp``; qwen3's sequential layer has both."""
    par = lm("command-r-35b", "float32")[2].blocks[0]
    seq = lm("qwen3-1.7b", "float32")[2].blocks[0]
    assert not hasattr(par, "ln_mlp") and hasattr(seq, "ln_mlp")
    assert set(dict(par.named_children())) == {"ln_attn", "attn", "mlp"}
    assert set(dict(seq.named_children())) == {"ln_attn", "attn", "ln_mlp",
                                               "mlp"}


def test_lm_params_from_numpy_maps_groups_to_layers():
    """Two groups of a one-variant pattern: layer g takes
    ``blocks_v0[g]``; a wrong shape names the leaf."""
    jcfg, tcfg = (jregistry.get_config("qwen3-1.7b", smoke=True),
                  registry.get_config("qwen3-1.7b", smoke=True))
    jp = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    jp["blocks_v0"]["ln_attn"]["scale"] = np.stack(
        [np.full(48, g, np.float32) for g in range(2)])
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    for i, block in enumerate(model.blocks):
        assert isinstance(block, TT.AttnMLPLayer)
        assert float(block.ln_attn["scale"][0]) == i
        assert torch.equal(block.attn.q_norm["scale"], torch.from_numpy(
            np.array(jp["blocks_v0"]["attn"]["q_norm"]["scale"][i])))
    jp["blocks_v0"]["mlp"]["w_up"]["w"] = jp["blocks_v0"]["mlp"]["w_up"][
        "w"][:, 1:]
    with pytest.raises(ValueError, match="mlp.w_up.w: reference"):
        convert.lm_params_from_numpy(jp, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("shape", [(2, 1, 3, 16), (4, 7, 8), (5, 128)])
def test_quantize_vec_matches_reference(shape, dtype):
    """Random vectors, a zero vector, and values exactly half a step from
    two levels (round half to even in both packages)."""
    x = rand(np.random.default_rng(sum(shape)), shape)
    x.reshape(-1, shape[-1])[0] = 0.0
    halves = np.arange(shape[-1], dtype=np.float32) + 0.5
    halves[-1] = 127.0                                  # scale exactly 1
    x.reshape(-1, shape[-1])[-1] = halves
    qj, sj = ja._quantize_vec(to_jax(x, dtype))
    qt, st = ta._quantize_vec(to_torch(x, dtype))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)
    assert qt.reshape(-1, shape[-1])[-1, :3].tolist() == [0, 2, 2]


def _int8_cache(rng, smax):
    k = rand(rng, (2, smax, 1, 8))
    (k8, ks), (v8, vs) = (ja._quantize_vec(jnp.asarray(a)) for a in
                          (k, rand(rng, (2, smax, 1, 8))))
    return [np.asarray(a) for a in (k8, v8, ks, vs)]


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("ring,pos", [(False, (3, 17)), (True, (5, 20)),
                                      (True, (41, 77))])
def test_attention_decode_int8_matches_reference(ring, pos, dtype):
    """An int8 cache with its scales: a plain cache with a window and sink,
    a ring still filling and one that has wrapped; the new vectors
    quantized into their slot, the cache read as bf16; the in-place write
    gives the functional result's bits into the tensors it was handed."""
    jp = perturbed(ja.init_attention(jax.random.PRNGKey(4), 40, 5, 1, 8,
                                     dtype=to_jax(np.zeros(1), dtype).dtype),
                   4)
    m = ta.Attention(40, 5, 1, 8, generator=torch.Generator(),
                     dtype=to_torch(np.zeros(1), dtype).dtype, device="cpu")
    convert.load_tree_(m, convert.flatten_tree(jp))
    rng = np.random.default_rng(sum(pos))
    k8, v8, ks, vs = _int8_cache(rng, 40)
    x = rand(rng, (2, 1, 40), 0.5)
    p = np.asarray(pos, np.int32)
    kw = dict(n_heads=5, n_kv_heads=1, head_dim=8, window=32, sink=8,
              ring=ring)
    yj, kj, vj, (ksj, vsj) = ja.attention_decode(
        jax.tree_util.tree_map(jnp.asarray, jp), to_jax(x, dtype),
        jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(p),
        scales=(jnp.asarray(ks), jnp.asarray(vs)), **kw)
    ct = [torch.from_numpy(a.copy()) for a in (k8, v8, ks, vs)]
    yt, kt, vt, (kst, vst) = ta.attention_decode(
        m, to_torch(x, dtype), ct[0], ct[1], torch.from_numpy(p),
        scales=(ct[2], ct[3]), **kw)
    assert kt.dtype == vt.dtype == torch.int8
    assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
    for got, want in ((kt, kj), (vt, vj)):
        assert int8_diff(got, want) == (0, 0.0)
    for got, want in ((kst, ksj), (vst, vsj)):
        assert_close(got, want, "float32", fp32_tol=BLOCK_TOL)
    yi, ki, vi, (ksi, vsi) = ta.attention_decode(
        m, to_torch(x, dtype), *ct[:2], torch.from_numpy(p),
        scales=tuple(ct[2:]), in_place=True, **kw)
    assert ki is ct[0] and vi is ct[1] and ksi is ct[2] and vsi is ct[3]
    for a, b in ((yi, yt), (ki, kt), (vi, vt), (ksi, kst), (vsi, vst)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("arch,max_len,steps", [
    ("qwen3-1.7b", 24, 20), ("llama4-maverick-400b-a17b", 40, 36)])
def test_int8_layer_decode_matches_reference(arch, max_len, steps, dtype):
    """Every variant's int8 cache stepped token by token (llama4's
    sliding-window layers wrap their 32-slot ring)."""
    check_layer_decode(arch, dtype, max_len, steps, kv_quant=True,
                       int8_flips=INT8_FLIPS)


#: A prefilled int8 cache against one written a token at a time: layer 0
#: reads the same inputs, so its vectors quantize alike (computed over the
#: prompt or token by token, at most ``INT8_LAYER0_FLIPS`` entries round a
#: near-half differently, by one step); a later layer's inputs differ by
#: the quantization error of the caches below it (stepping attends to the
#: int8 cache, prefill to the unrounded K/V), so its values may differ by
#: up to ``INT8_LAYER_STEPS`` steps and its scales by ``INT8_SCALE_TOL``
#: relative, and the logits by ``INT8_LOGITS_TOL`` relative (measured on
#: qwen3-1.7b and internvl2-1b smoke, 12-token prompts: at most 0 flips
#: at layer 0, 5 steps, 1.2e-2 and 1.7e-2).
INT8_LAYER0_FLIPS = 2
INT8_LAYER_STEPS = 8
INT8_SCALE_TOL = 3e-2
INT8_LOGITS_TOL = 3e-2


def assert_int8_prefill_cache(cp: dict, cs: dict, dtype: str):
    """A prefilled int8 cache ``cp`` against a stepped one ``cs`` (the
    port's layout), as ``INT8_*`` above bound it."""
    assert torch.equal(cp["pos"], cs["pos"])
    for i, (a, b) in enumerate(zip(cp["layers"], cs["layers"], strict=True)):
        assert set(a) == {"k", "v", "k_scale", "v_scale"} == set(b)
        for key in ("k", "v"):
            n, worst = int8_diff(a[key], b[key])
            if i == 0:
                assert worst <= 1 and n <= INT8_LAYER0_FLIPS, (key, n)
            else:
                assert worst <= INT8_LAYER_STEPS, (i, key, worst)
        for key in ("k_scale", "v_scale"):
            if i == 0:
                assert_close(a[key], b[key], "float32", fp32_tol=BLOCK_TOL)
            else:
                assert rel_err(a[key], b[key]) <= INT8_SCALE_TOL, (i, key)


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("arch", ("qwen3-1.7b", "internvl2-1b"))
def test_int8_prefill_matches_reference_prefill_by_stepping(arch, dtype):
    """The port's quantized prefill against the reference's oracle, which
    quantizes each vector as it steps (the values and scales as
    ``assert_int8_prefill_cache`` bounds them, the logits within
    ``INT8_LOGITS_TOL``); the port's own stepping equals the reference's
    (fp32 1e-4, bf16 tolerance, int8 values equal).  The reference's own
    ``prefill`` leaves the scales at zero: the documented deviation."""
    jcfg, jp, model = lm(arch, dtype, kv_quant=True)
    tj, tt = lm_tokens(2, 12, 21)
    lj, cj = ref_prefill_by_stepping(jcfg, jp, tj, 24)
    lt, ct = TS.prefill(model, tt, max_len=24)
    ls, cs = TS.prefill_by_stepping(model, tt, max_len=24)
    assert_close(ls, lj, dtype, fp32_tol=BLOCK_TOL)
    assert_caches(cs, cj, dtype, model.cfg, int8_flips=INT8_FLIPS)
    assert ct["layers"][0]["k"].dtype == torch.int8
    assert rel_err(lt, lj) <= INT8_LOGITS_TOL
    assert_int8_prefill_cache(ct, port_cache(cj, model.cfg), dtype)
    _, cj_gap = JS.prefill(jcfg, jp, tj, max_len=24)
    assert not np.any(np.asarray(cj_gap["v0"]["k_scale"]))
    assert bool((ct["layers"][0]["k_scale"][:, :12] > 0).all())


@pytest.mark.parametrize("dtype,s,max_len", [
    ("float32", 5, 16), ("float32", 40, 60), ("bfloat16", 9, 24)])
@pytest.mark.parametrize("arch", ("qwen3-1.7b",
                                  "llama4-maverick-400b-a17b"))
def test_int8_prefill_equals_prefill_by_stepping(arch, dtype, s, max_len):
    """The oracle relation on the port's int8 cache (llama4's 40-token
    prompt wraps its 32-slot rings), then two decode steps from each
    cache within ``INT8_LOGITS_TOL``."""
    model = lm(arch, dtype, kv_quant=True)[2]
    _, tt = lm_tokens(2, s, 31 + s)
    lp, cp = TS.prefill(model, tt, max_len=max_len)
    ls, cs = TS.prefill_by_stepping(model, tt, max_len=max_len)
    assert rel_err(lp, ls) <= INT8_LOGITS_TOL
    assert_int8_prefill_cache(cp, cs, dtype)
    for _ in range(2):
        nxt = sampler.greedy(ls)[:, None]
        lp, cp = TS.decode_step(model, cp, nxt)
        ls, cs = TS.decode_step(model, cs, nxt)
        assert rel_err(lp, ls) <= INT8_LOGITS_TOL


@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_int8_decode_steps_match_reference_from_its_cache(dtype):
    """Decode steps on an int8 cache from the reference's stepping oracle,
    each taken by the port from the reference's cache: logits and cache
    within fp32 1e-4 / bf16 tolerance, the new slot's int8 values equal."""
    jcfg, jp, model = lm("qwen3-1.7b", dtype, kv_quant=True)
    tj, _ = lm_tokens(2, 10, 22)
    lj, cj = ref_prefill_by_stepping(jcfg, jp, tj, 20)
    tok = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
    for _ in range(3):
        lt, ct = TS.decode_step(model, port_cache(cj, model.cfg),
                                torch.from_numpy(np.array(tok)).long())
        lj, cj = JS.decode_step(jcfg, jp, cj, tok)
        assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
        assert_caches(ct, cj, dtype, model.cfg, int8_flips=INT8_FLIPS)
        tok = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)


def test_int8_decode_step_into_matches_decode_step():
    check_decode_step_into("qwen3-1.7b", kv_quant=True, steps=6)


def test_ring_fill_pads_and_rings_scales():
    """_ring_fill on the int8 scales (B, S, H) as on K/V (B, S, H, dh)."""
    s = rand(np.random.default_rng(3), (2, 50, 3))
    got = TS._ring_fill(to_torch(s), 20, 4)
    want = JS._ring_fill(jnp.asarray(s)[..., None], 20, 4, 50)[..., 0]
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))
    assert torch.equal(TS._ring_fill(to_torch(s[:, :7]), 20, 4)[:, 7:],
                       torch.zeros(2, 13, 3))


# ---------------------------------------------------------------------------
# Launches, the entry point, the kernels' operands
# ---------------------------------------------------------------------------


def test_qwen3_full_width_linears_and_variants():
    """qwen3-1.7b: 7 Linears a layer (q 2048->2048, k and v 2048->1024,
    o 2048->2048, gate and up 2048->6144, down 6144->2048): 196 pwconv a
    prefill and a decode step; at a batch-8 512-token prefill bf16 runs
    them on ``tc``, fp32 on ``simt``, a decode step (G = 8) on
    ``stream``."""
    cfg = registry.get_config("qwen3-1.7b")
    model = TT.LMModel(cfg, generator=torch.Generator(), device="meta")
    linears = {n[:-2]: tuple(p.shape) for n, p in
               model.blocks[0].named_parameters() if n.endswith(".w")}
    assert linears == {"attn.w_q": (2048, 2048), "attn.w_k": (2048, 1024),
                       "attn.w_v": (2048, 1024), "attn.w_o": (2048, 2048),
                       "mlp.w_gate": (2048, 6144), "mlp.w_up": (2048, 6144),
                       "mlp.w_down": (6144, 2048)}
    assert len(linears) == tserve.LAYER_LAUNCHES["prefill"]["attn_mlp"][
        "pwconv"]
    for g, dtype, want in ((8 * 512, torch.bfloat16, "tc"),
                           (8 * 512, torch.float32, "simt"),
                           (8, torch.bfloat16, "stream"),
                           (8, torch.float32, "stream")):
        assert {blocking.pw_variant(g, ci, co, dtype)
                for ci, co in linears.values()} == {want}, (g, dtype)


@pytest.mark.parametrize("arch", NEW)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    rc = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "12", "--gen", "3", "--max-len", "40",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "on cpu: prefill 2x12" in out
    assert "'pwconv': 0" in out        # CPU tensors launch no kernel


def test_frontend_stub_and_prefill_capture_default_to_the_card():
    cfg = registry.get_config("internvl2-1b", smoke=True)
    stub = tserve.frontend_stub(cfg, 3, "cpu")
    assert stub.shape == (3, 8, 48) and not stub.any()
    assert tserve.frontend_stub(registry.get_config("qwen3-1.7b"), 3,
                                "cpu") is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "internvl2-1b", "--smoke"])
    model = TT.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        TS.capture_prefill(model, 1, 4, frontend_len=8)
    with pytest.raises(ValueError, match="on the card"):
        TS.capture_decode_step(model, 1, 16)


@pytest.mark.parametrize("arch", NEW)
def test_operands_reach_the_kernels_contiguous(arch, monkeypatch):
    """On the card the ``pwconv`` wrapper refuses strided operands: every
    operand the serving path hands it is contiguous, in prefill (dense and
    blockwise, with the frontend) and in decode, as many launches as
    ``expected_launches`` counts."""
    from repro_torch.core import pwconv as core_pw
    from repro_torch.kernels import ops
    seen, pwconv = [], ops.pwconv

    def checked(x, w, *args, **kwargs):
        assert x.is_contiguous() and w.is_contiguous()
        seen.append(1)
        return pwconv(x, w, *args, **kwargs)
    monkeypatch.setattr(core_pw.ops, "pwconv", checked)
    model = lm(arch, "bfloat16")[2]
    for s, max_len in PROMPTS.items():
        _, tt = lm_tokens(2, s, 0)
        _, ft = lm_frontend(model.cfg, 2, s, "bfloat16")
        logits, cache = TS.prefill(model, tt, max_len=max_len, frontend=ft)
        TS.decode_step(model, cache, sampler.greedy(logits)[:, None])
    per = {ph: tserve.expected_launches(model.cfg, ph)["pwconv"]
           for ph in ("prefill", "decode")}
    assert len(seen) == 2 * (per["prefill"] + per["decode"])


def test_in_place_step_past_max_len_writes_nothing_as_the_functional():
    """A decode step at a position past a plain cache writes no slot: the
    in-place scatter (the captured step's) as the reference's one-hot
    select, bits and caches alike, with the int8 cache too."""
    for kv_quant in (False, True):
        model = lm("qwen3-1.7b", "float32", kv_quant)[2]
        _, tt = lm_tokens(2, 6, 5)
        logits, ref = TS.prefill(model, tt, max_len=8)
        cache = TS.init_cache(model.cfg, 2, 8, "cpu")
        graphs.copy_tree_(cache, ref)
        out = torch.empty_like(logits)
        tok = sampler.greedy(logits)[:, None]
        for _ in range(4):                         # positions 6, 7, 8, 9
            want, ref = TS.decode_step(model, ref, tok)
            got, _ = TS.decode_step_into(model, cache, tok, out)
            assert torch.equal(got, want)
            for a, b in zip(cache["layers"], ref["layers"], strict=True):
                assert all(torch.equal(a[k], b[k]) for k in a)
            tok = sampler.greedy(want)[:, None]
        assert cache["pos"].tolist() == [10, 10]
