"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``):
seeded numpy inputs handed to both the JAX reference and the port."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch
import _torch_threads  # noqa: F401,E402

from repro_torch.mobilenet_inference import ARCHS

#: fp32 tolerance of the reference's own network tests
#: (tests/test_network.py::test_pallas_interpret_matches_xla).
FP32_TOL = 2e-5
#: bf16 kernel-level tolerance, relative to the largest magnitude.
BF16_KERNEL_TOL = 1e-2
#: bf16 network-level tolerance (examples/mobilenet_inference.py:43).
BF16_REL_TOL = 5e-2

#: --arch name -> spec builder name, the same in both packages.
SPECS = {arch: build.__name__ for arch, build in ARCHS.items()}

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(rng: np.random.Generator, shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def to_jax(a, dtype: str = "float32"):
    return None if a is None else jnp.asarray(a, JNP[dtype])


def to_torch(a, dtype: str = "float32"):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(
        TORCH[dtype])


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def rel_err(got, want) -> float:
    g, w = as_f32(got), as_f32(want)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))


#: Gradients: each within 1e-4 of its own largest magnitude (fp32).
GRAD_TOL = 1e-4


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def assert_grads(got: dict, want: dict, tol: float = GRAD_TOL):
    """Each gradient within ``tol`` of its largest magnitude; one whose
    largest magnitude is below 1e-6 of the largest of all (zero in exact
    arithmetic) within 1e-6 of that largest."""
    assert set(got) == set(want)
    top = max(float(np.abs(np32(w)).max()) for w in want.values())
    for name, g in got.items():
        g, w = np32(g), np32(want[name])
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            assert float(np.abs(g - w).max()) <= 1e-6 * top, name
        else:
            assert float(np.abs(g - w).max()) <= tol * scale, (
                name, float(np.abs(g - w).max()) / scale)


def assert_match(got, want, dtype: str, bf16_tol: float = BF16_KERNEL_TOL):
    """fp32: rtol = atol = 2e-5.  bf16: max error relative to the largest
    magnitude within ``bf16_tol``."""
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=FP32_TOL,
                                   atol=FP32_TOL)
    else:
        assert rel_err(got, want) <= bf16_tol, rel_err(got, want)


# ---------------------------------------------------------------------------
# The LM stack's attention-MLP transformers (tests/test_torch_dense.py and
# tests/test_torch_moe.py): the reference on its smoke configs with
# ``scan_layers=False`` (its bf16 model runs op by op: a bf16 dot compiled
# inside a scan fails on this jax's CPU), the port with the same weights.
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro_torch import convert, graphs  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import sampler as tsampler  # noqa: E402
from repro_torch.serve import serve_step as TS  # noqa: E402

LM_DTYPES = ("float32", "bfloat16")
#: fp32 blocks and logits (the reference's own, tests/test_ssm_xlstm.py).
BLOCK_TOL = 1e-4
#: Prompt lengths and the ``max_len`` of each: 20 tokens take the dense
#: attention path, 100 the blockwise one (over ``attn_chunk`` 64, also with
#: a frontend's 8 embeddings in front).  Both caches are plain except
#: llama4's sliding-window layers (window 32), which are 32-slot rings.
PROMPTS = {20: 36, 100: 160}
MAX_LEN = 160


def assert_close(got, want, dtype: str, fp32_tol: float = FP32_TOL):
    """fp32: rtol = atol = ``fp32_tol``; bf16: ``BF16_REL_TOL`` of the
    largest magnitude."""
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


def configs(arch: str, dtype: str, **kw):
    """(reference, port) smoke configs of ``arch`` in ``dtype``."""
    return (dataclasses.replace(jregistry.get_config(arch, smoke=True),
                                dtype=dtype, scan_layers=False, **kw),
            dataclasses.replace(tregistry.get_config(arch, smoke=True),
                                dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def lm(arch: str, dtype: str, kv_quant: bool = False):
    """(reference config, reference params, port model), the port's weights
    carried from the reference's."""
    jcfg, tcfg = configs(arch, dtype, kv_quant=kv_quant)
    jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jtree(jp), convert.lm_params_from_numpy(jp, tcfg,
                                                         device="cpu")


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(jcfg):
    """The reference's ``jax.value_and_grad`` of ``loss_fn`` under
    ``jcfg`` (``(params, batch) -> ((loss, metrics), grads)``), jitted
    once a config and compiled once a batch shape: traced op by op it takes
    several times as long as its compile (fp32 only: the bf16 dots do not
    run under ``jit`` on this CPU)."""
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b),
                                      has_aux=True))


def lm_tokens(b: int, s: int, seed: int, vocab: int = 128):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


def lm_frontend(cfg, b: int, seed: int, dtype: str):
    """Seeded stand-ins for the stubbed modality embeddings (B, F, d) of a
    config with ``fusion_tokens``, for (reference, port); else (None,
    None)."""
    if not cfg.fusion_tokens:
        return None, None
    f = rand(np.random.default_rng(seed), (b, cfg.fusion_tokens,
                                           cfg.d_model), 0.5)
    return to_jax(f, dtype), to_torch(f, dtype)


@functools.lru_cache(maxsize=None)
def ref_prefill(arch: str, dtype: str, s: int, kv_quant: bool = False):
    """The reference's prefill of a seeded batch-2 prompt of ``s`` tokens
    (with the frontend, if any) at ``PROMPTS[s]``, kept for the tests that
    start from it."""
    jcfg, jp, _ = lm(arch, dtype, kv_quant)
    tj, _ = lm_tokens(2, s, s)
    fj, _ = lm_frontend(jcfg, 2, s, dtype)
    return JS.prefill(jcfg, jp, tj, max_len=PROMPTS[s], frontend=fj)


def ref_prefill_by_stepping(jcfg, jp, tj, max_len: int):
    """The reference's oracle.  It scans decode_step over the prompt; in
    bf16 the same steps run in a Python loop (a bf16 dot in a scan fails
    on this jax's CPU), and so do they with an int8 cache: compiled in a
    scan, XLA's CPU drops the bf16 rounding of ``int8 * scale`` that the
    reference's ops (run one by one, as the port runs them) make."""
    if jcfg.dtype == "float32" and not jcfg.kv_quant:
        return JS.prefill_by_stepping(jcfg, jp, tj, max_len=max_len)
    cache = JS.init_cache(jcfg, tj.shape[0], max_len)
    for t in range(tj.shape[1]):
        logits, cache = JS.decode_step(jcfg, jp, cache, tj[:, t:t + 1])
    return logits, cache


def layer_params(jp, cfg, i: int):
    """Layer ``i``'s params from the reference's stacked groups."""
    g, vi = divmod(i, len(JT.layer_pattern(cfg)))
    return jax.tree_util.tree_map(lambda a: a[g], jp[f"blocks_v{vi}"])


def _ref_layer(cj, cfg, i: int) -> dict:
    g, vi = divmod(i, len(JT.layer_pattern(cfg)))
    return jax.tree_util.tree_map(lambda a: a[g], cj[f"v{vi}"])


def port_cache(cj, cfg) -> dict:
    """The reference's stacked cache in the port's per-layer layout."""
    def leaf(a):
        a = np.array(a)
        if a.dtype.name in TORCH:
            return convert.tensor_from_numpy(a, "cpu")
        return torch.from_numpy(a)                      # int8 / int32
    out = {"pos": torch.from_numpy(np.array(cj["pos"])),
           "layers": [jax.tree_util.tree_map(leaf, _ref_layer(cj, cfg, i))
                      for i in range(cfg.n_layers)]}
    for name in ("enc_k", "enc_v"):                     # enc-dec
        if name in cj:
            out[name] = leaf(cj[name])
    return out


def int8_diff(got, want) -> tuple:
    """(entries that differ, largest difference) of two int8 tensors."""
    d = np.abs(as_f32(got) - as_f32(want))
    return int((d > 0).sum()), float(d.max(initial=0.0))


def assert_layer_cache(got: dict, want: dict, dtype: str) -> int:
    """One layer's cache against the reference's, key for key; int8 values
    may differ by one step (a scaled value within rounding of a half).
    Returns how many int8 entries differ."""
    assert set(got) == set(want)
    flips = 0
    for key, val in got.items():
        if val.dtype == torch.int8:
            n, worst = int8_diff(val, want[key])
            assert worst <= 1, (key, worst)
            flips += n
        else:
            assert_close(val, want[key], dtype, fp32_tol=BLOCK_TOL)
    return flips


def assert_caches(ct, cj, dtype: str, cfg, int8_flips: int = 0):
    """The port's per-layer cache against the reference's stacked one; at
    most ``int8_flips`` int8 entries in all may differ (by one step)."""
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    assert len(ct["layers"]) == cfg.n_layers
    flips = sum(assert_layer_cache(layer, _ref_layer(cj, cfg, i), dtype)
                for i, layer in enumerate(ct["layers"]))
    assert flips <= int8_flips, flips
    assert set(ct) - {"pos", "layers"} == set(cj) - {"pos"} - {
        f"v{vi}" for vi in range(len(JT.layer_pattern(cfg)))}
    for name in ("enc_k", "enc_v"):                     # enc-dec
        if name in cj:
            assert ct[name].dtype == TORCH[cfg.dtype]
            assert_close(ct[name], cj[name], dtype, fp32_tol=BLOCK_TOL)


def assert_moe_aux(got: dict, want: dict, dtype: str):
    """``aux_loss`` and ``drop_frac`` against the reference's: fp32 to
    rounding; bf16 within 1e-3 relative (the router reads bf16
    activations)."""
    tol = 1e-6 if dtype == "float32" else 1e-3
    for k in ("aux_loss", "drop_frac"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol,
                                   atol=1e-7)


# --- the checks each attention-MLP arch's smoke config runs ----------------


def check_layer_forward(arch: str, dtype: str, s: int):
    """Every variant of the pattern (layer ``vi`` of group 0) on a seeded
    input: its output, captured K/V and MoE metrics."""
    jcfg, jp, model = lm(arch, dtype)
    pattern = JT.layer_pattern(jcfg)
    assert ([dataclasses.asdict(v) for v in model.pattern]
            == [dataclasses.asdict(v) for v in pattern])
    x = rand(np.random.default_rng(s), (2, s, jcfg.d_model), 0.5)
    pos = np.broadcast_to(np.arange(s), (2, s))
    for vi, variant in enumerate(pattern):
        yj, aj = JT.layer_forward(layer_params(jp, jcfg, vi), to_jax(x, dtype),
                                  jcfg, variant, positions=jnp.asarray(pos),
                                  capture_kv=True)
        yt, at = TT.layer_forward(model.blocks[vi], to_torch(x, dtype),
                                  model.cfg, model.variant(vi),
                                  positions=torch.from_numpy(pos.copy()),
                                  capture_kv=True)
        assert set(at) == set(aj), vi
        assert yt.dtype == TORCH[dtype]
        assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
        for got, want in zip(at["kv"], aj["kv"], strict=True):
            assert_close(got, want, dtype, fp32_tol=BLOCK_TOL)
        if variant.use_moe:
            assert_moe_aux(at, aj, dtype)


def check_layer_decode(arch: str, dtype: str, max_len: int, steps: int,
                       kv_quant: bool = False, int8_flips: int = 0):
    """Every variant of the pattern stepped ``steps`` tokens from a zeroed
    cache of ``max_len`` (a ring where the layer's window is shorter)."""
    jcfg, jp, model = lm(arch, dtype, kv_quant)
    flips = 0
    for vi, variant in enumerate(JT.layer_pattern(jcfg)):
        cj = JT.init_layer_cache(jcfg, variant, 2, max_len)
        ct = TT.init_layer_cache(model.cfg, model.variant(vi), 2, max_len,
                                 device="cpu")
        assert_layer_cache(ct, cj, dtype)
        rng = np.random.default_rng(max_len + vi)
        for t in range(steps):
            x = rand(rng, (2, 1, jcfg.d_model), 0.5)
            pos = np.full((2,), t, np.int32)
            yj, cj = JT.layer_decode(layer_params(jp, jcfg, vi),
                                     to_jax(x, dtype), cj, jnp.asarray(pos),
                                     jcfg, variant)
            yt, ct = TT.layer_decode(model.blocks[vi], to_torch(x, dtype), ct,
                                     torch.from_numpy(pos), model.cfg,
                                     model.variant(vi))
            assert_close(yt, yj, dtype, fp32_tol=BLOCK_TOL)
        flips += assert_layer_cache(ct, cj, dtype)
    assert flips <= int8_flips, flips


def check_prefill(arch: str, dtype: str, s: int):
    """hidden_states with the frontend (the prefix, the MoE metrics) and
    prefill's logits and cache, against the reference's."""
    jcfg, jp, model = lm(arch, dtype)
    tj, tt = lm_tokens(2, s, s)
    fj, ft = lm_frontend(jcfg, 2, s, dtype)
    xj, pj, aj = JT.hidden_states(jcfg, jp, tj, frontend=fj)
    xt, pt, at = TT.hidden_states(model, tt, frontend=ft)
    assert pt == pj == jcfg.fusion_tokens
    assert_close(xt, xj, dtype, fp32_tol=BLOCK_TOL)
    assert_moe_aux(at, aj, dtype)
    lj, cj = ref_prefill(arch, dtype, s)
    lt, ct = TS.prefill(model, tt, max_len=PROMPTS[s], frontend=ft)
    assert lt.dtype == torch.float32 and bool(torch.isfinite(lt).all())
    assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
    assert_caches(ct, cj, dtype, model.cfg)


def check_decode_steps(arch: str, dtype: str):
    """Three decode steps from the reference's prefill cache at prompt 100,
    each taken by the port from the reference's cache."""
    jcfg, jp, model = lm(arch, dtype)
    lj, cj = ref_prefill(arch, dtype, 100)
    tok = jsampler.greedy(lj)[:, None]
    for _ in range(3):
        lt, ct = TS.decode_step(model, port_cache(cj, model.cfg),
                                torch.from_numpy(np.array(tok)).long())
        lj, cj = JS.decode_step(jcfg, jp, cj, tok)
        assert_close(lt, lj, dtype, fp32_tol=BLOCK_TOL)
        assert_caches(ct, cj, dtype, model.cfg)
        tok = jsampler.greedy(lj)[:, None]


def check_prefill_by_stepping_fp32(arch: str):
    """The reference's oracle (a scan of decode steps) against the port's,
    then one decode step from each cache."""
    jcfg, jp, model = lm(arch, "float32")
    tj, tt = lm_tokens(2, 6, 7)
    lj, cj = JS.prefill_by_stepping(jcfg, jp, tj, max_len=MAX_LEN)
    lt, ct = TS.prefill_by_stepping(model, tt, max_len=MAX_LEN)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    assert_caches(ct, cj, "float32", model.cfg)
    nj, nt = lm_tokens(2, 1, 8)
    lj, cj = JS.decode_step(jcfg, jp, cj, nj)
    lt, ct = TS.decode_step(model, ct, nt)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    assert_caches(ct, cj, "float32", model.cfg)


def check_prefill_equals_stepping(arch: str, dtype: str, s: int,
                                  max_len: int):
    """The oracle relation on the port itself, then two decode steps from
    each cache."""
    model = lm(arch, dtype)[2]
    _, tt = lm_tokens(2, s, 11 + s)
    lp, cp = TS.prefill(model, tt, max_len=max_len)
    ls, cs = TS.prefill_by_stepping(model, tt, max_len=max_len)
    assert_close(lp, ls, dtype, fp32_tol=BLOCK_TOL)
    for _ in range(2):
        nxt = tsampler.greedy(lp)[:, None]
        lp, cp = TS.decode_step(model, cp, nxt)
        ls, cs = TS.decode_step(model, cs, nxt)
        assert_close(lp, ls, dtype, fp32_tol=BLOCK_TOL)


def check_generate_fp32(arch: str):
    """Prefill (with the frontend) and six greedy tokens: the same tokens
    as the reference's."""
    jcfg, jp, model = lm(arch, "float32")
    tj, tt = lm_tokens(2, 30, 12)
    fj, ft = lm_frontend(jcfg, 2, 12, "float32")
    lj, cj = JS.prefill(jcfg, jp, tj, max_len=MAX_LEN, frontend=fj)
    lt, ct = TS.prefill(model, tt, max_len=MAX_LEN, frontend=ft)
    assert_close(lt, lj, "float32", fp32_tol=BLOCK_TOL)
    toks_j, _ = jsampler.generate(
        lambda c, t: JS.decode_step(jcfg, jp, c, t), cj,
        jsampler.greedy(lj)[:, None], 6, jax.random.PRNGKey(2))
    toks_t, _ = tsampler.generate(lambda c, t: TS.decode_step(model, c, t),
                                  ct, tsampler.greedy(lt)[:, None], 6)
    assert np.array_equal(toks_t.numpy(), np.asarray(toks_j))


def check_decode_step_into(arch: str, kv_quant: bool = False,
                           steps: int = 14):
    """The body ``capture_decode_step`` captures, on the CPU: the logits
    and cache of the functional step, every tensor of the static cache
    kept at its address."""
    model = lm(arch, "float32", kv_quant)[2]
    _, tt = lm_tokens(2, 30, 3)
    _, ft = lm_frontend(model.cfg, 2, 3, "float32")
    logits, ref = TS.prefill(model, tt, max_len=MAX_LEN, frontend=ft)
    cache = TS.init_cache(model.cfg, 2, MAX_LEN, "cpu")
    graphs.copy_tree_(cache, ref)

    def leaves(c):
        return [c["pos"]] + [layer[k] for layer in c["layers"]
                             for k in sorted(layer)]
    addresses = [t.data_ptr() for t in leaves(cache)]
    out = torch.empty_like(logits)
    tokens = tsampler.greedy(logits)[:, None]
    for _ in range(steps):
        want, ref = TS.decode_step(model, ref, tokens)
        got, same = TS.decode_step_into(model, cache, tokens, out)
        assert got is out and same is cache
        assert torch.equal(got, want)
        for a, b in zip(leaves(cache), leaves(ref), strict=True):
            assert torch.equal(a, b)
        tokens = tsampler.greedy(want)[:, None]
    assert addresses == [t.data_ptr() for t in leaves(cache)]
    prefix = model.cfg.meta_tokens + model.cfg.fusion_tokens
    assert cache["pos"].tolist() == [prefix + 30 + steps] * 2


def check_cache_specs(arch: str, max_len: int, kv_quant: bool):
    """``cache_specs`` (meta tensors) against the reference's
    ``jax.eval_shape`` of its cache, layer by layer, and ``init_cache``
    against the reference's zeros."""
    jcfg, tcfg = configs(arch, "bfloat16", kv_quant=kv_quant)
    sj, st = JS.cache_specs(jcfg, 3, max_len), TS.cache_specs(tcfg, 3,
                                                              max_len)
    assert st["pos"].device.type == "meta"
    assert (tuple(st["pos"].shape), str(st["pos"].dtype)) == (
        sj["pos"].shape, "torch." + str(sj["pos"].dtype))
    assert len(st["layers"]) == tcfg.n_layers
    for i, layer in enumerate(st["layers"]):
        want = jax.tree_util.tree_map(
            lambda a: (a.shape[1:], "torch." + str(a.dtype)),
            sj[f"v{i % len(JT.layer_pattern(jcfg))}"])
        got = {k: (tuple(t.shape), str(t.dtype)) for k, t in layer.items()}
        assert all(t.device.type == "meta" for t in layer.values())
        assert got == {k: tuple(v) for k, v in want.items()}, i
    assert_caches(TS.init_cache(tcfg, 3, max_len, "cpu"),
                  JS.init_cache(jcfg, 3, max_len), "bfloat16", tcfg)


def check_init_params_and_cast(arch: str):
    """The port's own init has the reference's names, shapes and dtypes;
    a bf16 model cast from the fp32 draw equals the bf16 draw."""
    jcfg, tcfg = configs(arch, "bfloat16")
    m16 = TT.init_params(tcfg, seed=3, device="cpu")
    jshapes = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    period = len(m16.pattern)
    want = {}
    for key, sub in jshapes.items():
        if not key.startswith("blocks_v"):
            want.update({k: (a.shape, str(a.dtype)) for k, a in
                         convert.flatten_tree({key: sub}).items()})
            continue
        vi = int(key[len("blocks_v"):])
        for name, a in convert.flatten_tree(sub).items():
            for g in range(a.shape[0]):
                want[f"blocks.{g * period + vi}.{name}"] = (a.shape[1:],
                                                            str(a.dtype))
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in m16.named_parameters()}
    assert got == want
    m32 = TT.init_params(dataclasses.replace(tcfg, dtype="float32"), seed=3,
                         device="cpu")
    cast = TT.cast_params(m32, tcfg)
    for (n1, a), (n2, b) in zip(cast.named_parameters(),
                                m16.named_parameters(), strict=True):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b), n1
        assert not a.requires_grad
