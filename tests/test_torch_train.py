"""Training on one device, the port against the JAX reference: the chunked
cross-entropy, the flash backward, the ``pwconv`` autograd Function,
``loss_fn`` and its gradient for every trainable smoke config, AdamW and
its schedule, the compressors, the train step with microbatches, the data
pipeline, the checkpointer, the fault-tolerant loop and the launcher.

The reference runs with ``impl="xla"`` (its default on this CPU), fp32
(its bf16 dots cannot run under ``jit`` here); the ``pwconv`` Function is
also held in bf16, op by op.  Gradients are held to 1e-4 of each
gradient's largest magnitude; a gradient that is zero in exact arithmetic
(a cross attention's key bias: the softmax ignores a shift common to all
keys) is held to 1e-6 of the largest gradient of the model instead.
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

from _torch_parity import (assert_grads, configs, jtree, lm, lm_frontend,
                           np32, perturbed, rand, rel_err, to_jax, to_torch)
from repro.data import pipeline as jdata
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core.pwconv import PointwiseFn, pointwise
from repro_torch.data import pipeline as tdata
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_step as ttrain
from repro_torch.train import trainer as ttrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Every registry config whose layers train: dense, VLM, MoE, enc-dec.
TRAINABLE = ("smollm-360m", "qwen3-1.7b", "qwen1.5-110b", "command-r-35b",
             "internvl2-1b", "qwen3-moe-235b-a22b",
             "llama4-maverick-400b-a17b", "whisper-small")


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_loss", (0.0, 1e-3))
@pytest.mark.parametrize("s,chunk", ((20, 16), (16, 16), (9, 4)))
def test_chunked_cross_entropy_matches_reference(s, chunk, z_loss):
    """Value, token count and the gradients of x and the table, with the
    sequence padded to whole chunks and ignored (-1) labels."""
    rng = np.random.default_rng(s + chunk)
    x, table = rand(rng, (2, s, 24)), rand(rng, (50, 24), 0.3)
    labels = rng.integers(0, 50, (2, s))
    labels[0, :3] = -1
    labels[1, -2:] = -1

    def jfn(x, t):
        return JL.chunked_cross_entropy(x, t, jnp.asarray(labels, jnp.int32),
                                        chunk=chunk, z_loss=z_loss)
    (nj, cj), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(table))
    gxj, gtj = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    nt, ct = TL.chunked_cross_entropy(xt, tt, torch.from_numpy(labels),
                                      chunk=chunk, z_loss=z_loss)
    nt.backward()
    assert float(ct) == float(cj) == float((labels >= 0).sum())
    np.testing.assert_allclose(float(nt.detach()), float(nj), rtol=1e-5)
    assert_grads({"x": xt.grad, "table": tt.grad}, {"x": gxj, "table": gtj})


# ---------------------------------------------------------------------------
# The flash backward
# ---------------------------------------------------------------------------


FLASH_CASES = {
    "causal": dict(causal=True, s=40, sk=40, chunk=16),
    "window_sink": dict(causal=True, s=48, sk=48, chunk=8, window=12,
                        sink=4),
    "noncausal_padded": dict(causal=False, s=24, sk=24, chunk=16),
    "cross_padded": dict(causal=False, s=10, sk=24, chunk=16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_reference(case):
    """dq, dk, dv of the blockwise attention against the reference's
    ``_flash`` VJP (GQA, 4 query heads over 2 KV heads), fp32."""
    c = dict(FLASH_CASES[case])
    s, sk = c.pop("s"), c.pop("sk")
    rng = np.random.default_rng(len(case))
    q, k, v = (rand(rng, (2, n, h, 8)) for n, h in ((s, 4), (sk, 2),
                                                     (sk, 2)))
    dout = rand(rng, (2, s, 4, 8))
    out_j, vjp = jax.vjp(lambda q, k, v: JA.blockwise_attention(
        q, k, v, **c), *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out_t = TA.blockwise_attention(qt, kt, vt, **c)
    out_t.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(np32(out_t), np32(out_j), rtol=1e-5,
                               atol=1e-5)
    assert_grads({"dq": qt.grad, "dk": kt.grad, "dv": vt.grad},
                 dict(zip(("dq", "dk", "dv"), grads_j)))


def test_flash_backward_keeps_no_score_matrix():
    """The Function's residuals are q, k, v, out and the lse rows: O(S),
    no (S x S) tensor."""
    s = 64
    q, k, v = (torch.randn(1, s, 2, 8, requires_grad=True) for _ in range(3))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TA.blockwise_attention(q, k, v, chunk=16)
    assert out.grad_fn is not None
    assert max(sizes) <= s * 2 * 8 and s * s not in sizes


# ---------------------------------------------------------------------------
# The pwconv Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bias", (False, True))
@pytest.mark.parametrize("act", (None, "silu", "relu6"))
def test_pwconv_function_matches_reference_vjp(act, bias, dtype):
    """dx, dw, db of ``pointwise`` against the reference's ``_mm_bwd``
    composed with the epilogue (``jax.vjp`` of ``pwconv_ref``): values and
    dtypes (dx in x's, dw in w's, db in the bias's)."""
    rng = np.random.default_rng(7)
    x, w = rand(rng, (2, 6, 24)), rand(rng, (24, 16), 0.3)
    b = rand(rng, (16,), 0.5) if bias else None
    g = rand(rng, (2, 6, 16))
    args_j = [to_jax(a, dtype) for a in (x, w)] + (
        [to_jax(b, dtype)] if bias else [])
    _, vjp = jax.vjp(lambda x, w, *b: jref.pwconv_ref(
        x, w, bias=b[0] if b else None, activation=act), *args_j)
    want = vjp(to_jax(g, dtype))
    args_t = [to_torch(a, dtype).requires_grad_(True) for a in (x, w)] + (
        [to_torch(b, dtype).requires_grad_(True)] if bias else [])
    y = pointwise(args_t[0], args_t[1], args_t[2] if bias else None,
                  activation=act)
    assert y.grad_fn is not None and y.grad_fn.name().endswith(
        "PointwiseFnBackward")
    y.backward(to_torch(g, dtype))
    for t, wj in zip(args_t, want, strict=True):
        assert t.grad.dtype == t.dtype
        assert str(t.grad.dtype).replace("torch.", "") == str(wj.dtype)
        if dtype == "float32":
            np.testing.assert_allclose(np32(t.grad), np32(wj), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(
                                           np32(wj)).max()))
        else:
            assert rel_err(t.grad, wj) <= 1e-2, rel_err(t.grad, wj)


def test_pwconv_function_only_under_autograd():
    """Inference (``inference_mode``, ``no_grad``, operands without grad)
    calls the op itself; only grad mode with an operand requiring grad
    goes through the Function."""
    x, w = torch.randn(4, 8), torch.randn(8, 5, requires_grad=True)
    assert pointwise(x, w).grad_fn.name().endswith("PointwiseFnBackward")
    with torch.inference_mode():
        assert pointwise(x, w).grad_fn is None
    with torch.no_grad():
        assert pointwise(x, w).grad_fn is None
    assert pointwise(x, w.detach()).grad_fn is None
    assert issubclass(PointwiseFn, torch.autograd.Function)


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------


def _lm_batch(jcfg, s: int, seed: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (2, s))
    labels = rng.integers(0, jcfg.vocab_size, (2, s))
    labels[0, :3] = -1
    bj = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    bt = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if jcfg.encdec is not None:
        f = rand(rng, (2, jcfg.encdec.enc_seq, jcfg.d_model), 0.5)
        bj["frontend"], bt["frontend"] = to_jax(f), to_torch(f)
    else:
        fj, ft = lm_frontend(jcfg, 2, seed, "float32")
        if fj is not None:
            bj["frontend"], bt["frontend"] = fj, ft
    return bj, bt


def _port_grads(model, batch, **kw):
    TL.trainable_(model)
    loss, metrics = TT.loss_fn(model, batch, **kw)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch", TRAINABLE)
def test_loss_fn_and_gradient_match_reference(arch):
    """``loss_fn``'s loss and metrics and the gradient of every parameter
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` (per-layer
    remat on both sides), 20 tokens with ignored labels, fp32."""
    jcfg, jp, model = lm(arch, "float32")
    bj, bt = _lm_batch(jcfg, 20, 1)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, bj), has_aux=True)(jp)
    lt, mt, gt = _port_grads(model, bt)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]),
                                   rtol=1e-5, atol=1e-7)
    assert_grads(gt, convert.lm_leaves(gj, len(model.pattern)))


@pytest.mark.parametrize("arch,remat", (("smollm-360m", "none"),
                                        ("whisper-small", "block")))
def test_loss_gradient_through_blockwise_attention(arch, remat):
    """At ``attn_chunk`` 16 the decoder's 40 positions (and whisper's 24
    encoder frames and its cross attention) take the blockwise path, whose
    backward is the flash Function; with and without per-layer remat."""
    jcfg, tcfg = configs(arch, "float32", attn_chunk=16, remat=remat)
    jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(1)))
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    jp = jtree(jp)
    bj, bt = _lm_batch(jcfg, 40, 2)
    (lj, _), gj = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, bj), has_aux=True)(jp)
    lt, _, gt = _port_grads(model, bt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert_grads(gt, convert.lm_leaves(gj, len(model.pattern)))


# ---------------------------------------------------------------------------
# AdamW, schedule, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
@pytest.mark.parametrize("pdtype", ("float32", "bfloat16"))
def test_adamw_matches_reference_on_identical_gradients(moments, pdtype):
    """Five steps of ``apply_updates`` on the same numpy gradients (a
    clipped one among them, norm and bias leaves undecayed): parameters,
    moments, step and metrics within 1e-6."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=3.0, moments_dtype=moments)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    shapes = {"blocks.0.attn.w_q.w": (6, 4), "blocks.0.attn.w_q.b": (4,),
              "blocks.0.ln_attn.scale": (6,), "embedding.table": (5, 6)}
    p = {k: rand(rng, s) for k, s in shapes.items()}
    # the reference's tree is nested (its decay mask reads the last key)
    jp = _nest({k: to_jax(v, pdtype) for k, v in p.items()})
    tp = {k: to_torch(v, pdtype) for k, v in p.items()}
    js, ts = jadamw.init_state(jp, jc), tadamw.init_state(tp, tc)
    for step in range(5):
        g = {k: rand(rng, s, 3.0 if step == 2 else 0.1)
             for k, s in shapes.items()}
        jp, js, jm = jadamw.apply_updates(
            jp, _nest({k: jnp.asarray(v) for k, v in g.items()}), js, jc)
        tp, ts, tm = tadamw.apply_updates(tp, {k: torch.from_numpy(v) for
                                               k, v in g.items()}, ts, tc)
        flat = {part: convert.flatten_tree(t) for part, t in
                (("p", jp), ("mu", js["mu"]), ("nu", js["nu"]))}
        for k in shapes:
            assert tp[k].dtype == to_torch(p[k], pdtype).dtype
            assert ts["mu"][k].dtype == (torch.bfloat16 if moments ==
                                         "bfloat16" else torch.float32)
            for got, want in ((tp[k], flat["p"][k]),
                              (ts["mu"][k], flat["mu"][k]),
                              (ts["nu"][k], flat["nu"][k])):
                np.testing.assert_allclose(np32(got), np32(want), rtol=1e-6,
                                           atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert tadamw.decays("blocks.0.attn.w_q.w")
    assert not tadamw.decays("blocks.0.attn.w_q.b")
    assert not tadamw.decays("blocks.0.ln_attn.scale")


def _nest(flat: dict) -> dict:
    """``{"a.b.c": leaf}`` as nested dicts."""
    out = {}
    for key, v in flat.items():
        *path, last = key.split(".")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[last] = v
    return out


def test_schedule_matches_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for s in (0, 1, 5, 10, 11, 60, 109, 110, 500):
        got = float(tadamw.schedule(tc, torch.tensor(s, dtype=torch.int32)))
        want = float(jadamw.schedule(jc, jnp.int32(s)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(tadamw.schedule(tc, torch.tensor(5))) == pytest.approx(0.5)
    assert float(tadamw.schedule(tc, torch.tensor(110))) == pytest.approx(
        0.1)


def test_topk_error_feedback_invariant():
    g = {"w": torch.from_numpy(rand(np.random.default_rng(0), (64,)))}
    e = tcompress.init_error(g)
    cfg = tcompress.CompressionConfig(kind="topk", topk_frac=0.1)
    c, e_new = tcompress.compress(g, e, cfg)
    torch.testing.assert_close(c["w"] + e_new["w"], g["w"], rtol=1e-6,
                               atol=0)
    assert int((c["w"] != 0).sum()) == int(64 * 0.1)
    kept = torch.topk(g["w"].abs(), 6).indices
    assert torch.equal(c["w"][kept], g["w"][kept])


def test_int8_compression_unbiased_with_error_feedback():
    g = {"w": torch.from_numpy(rand(np.random.default_rng(0), (512,)))}
    e = tcompress.init_error(g)
    cfg = tcompress.CompressionConfig(kind="int8")
    gen = torch.Generator().manual_seed(0)
    samples = []
    for _ in range(50):
        c, e_new = tcompress.compress(g, e, cfg, gen)
        torch.testing.assert_close(c["w"] + e_new["w"], g["w"], rtol=0,
                                   atol=1e-6)
        samples.append(c["w"].numpy())
    np.testing.assert_allclose(np.mean(samples, axis=0), g["w"].numpy(),
                               atol=0.02)
    scale = float(g["w"].abs().max()) / 127
    assert np.allclose(np.round(samples[0] / scale), samples[0] / scale,
                       atol=1e-3)
    with pytest.raises(ValueError, match="generator"):
        tcompress.compress(g, e, cfg)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _tiny(microbatches: int = 1, **opt):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=100, weight_decay=0.0)
    cfg.update(opt)
    return ttrain.TrainConfig(optimizer=tadamw.AdamWConfig(**cfg),
                              microbatches=microbatches)


def _jtiny(microbatches: int = 1):
    return jtrain.TrainConfig(
        optimizer=jadamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                     total_steps=100, weight_decay=0.0),
        microbatches=microbatches)


def _dcfg(cfg, bs: int = 4, seq: int = 32):
    return tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=bs, seed=7)


@pytest.mark.parametrize("microbatches", (1, 2))
def test_train_step_matches_reference(microbatches):
    """Step 1's loss and accumulated gradients (fp32 sums over the
    microbatches, as the reference's scan) at 1e-4, its optimizer metrics,
    and the losses of three steps at 1e-3 relative, on the reference's own
    batches; smollm smoke, fp32."""
    jcfg, tcfg = configs("smollm-360m", "float32")
    jcfg = dataclasses.replace(jcfg, scan_layers=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    dc = _dcfg(tcfg)
    batches = [jdata._batch_np(jdata.DataConfig(**dataclasses.asdict(dc)), s)
               for s in range(3)]
    jstate = {"params": jp, "opt": jadamw.init_state(jp)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, _jtiny(microbatches)))
    tstate = ttrain.init_train_state(model, _tiny(microbatches))
    tstep = ttrain.make_train_step(model, _tiny(microbatches))
    # step 1's gradients: the reference's accumulation, written out
    mb = microbatches
    want = None
    for i in range(mb):
        part = {k: jnp.asarray(v[i * 4 // mb:(i + 1) * 4 // mb])
                for k, v in batches[0].items()}
        g = jax.grad(lambda p: JT.loss_fn(jcfg, p, part)[0])(jp)
        want = g if want is None else jax.tree_util.tree_map(jnp.add, want, g)
    want = convert.lm_leaves(jax.tree_util.tree_map(lambda a: a / mb, want),
                             1)
    got = ttrain.accumulate_grads(model, tstate["params"],
                                  {k: torch.from_numpy(v) for k, v in
                                   batches[0].items()}, mb)[2]
    assert_grads(got, want)
    for s, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in
                                    batch.items()})
        tol = 1e-5 if s == 0 else 1e-3
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol)
        if s == 0:
            for k in ("grad_norm", "lr", "param_norm", "nll", "tokens"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-4)
        assert int(tstate["opt"]["step"]) == s + 1


def test_train_step_is_functional():
    """A step returns new tensors and leaves its input state as it was."""
    cfg = registry.get_config("smollm-360m", smoke=True)
    model = TT.init_params(cfg, device="cpu")
    state = ttrain.init_train_state(model, _tiny())
    before = {k: v.clone() for k, v in state["params"].items()}
    step = ttrain.make_train_step(model, _tiny())
    batch = tdata.DataIterator(_dcfg(cfg), prefetch=0).__next__()
    new, m = step(state, batch)
    assert all(torch.equal(state["params"][k], before[k]) for k in before)
    assert not all(torch.equal(new["params"][k], before[k]) for k in before)
    assert int(state["opt"]["step"]) == 0 and int(new["opt"]["step"]) == 1
    assert set(m) >= {"loss", "nll", "tokens", "grad_norm", "lr",
                      "param_norm"}


def test_whisper_trains_with_frames():
    """An encoder-decoder's step takes the frames as the batch's
    ``frontend`` (the encoder's parameters get gradients) and its loss
    falls over a few steps on one batch."""
    cfg = registry.get_config("whisper-small", smoke=True)
    model = TT.init_params(cfg, device="cpu")
    state = ttrain.init_train_state(model, _tiny())
    step = ttrain.make_train_step(model, _tiny())
    batch = tdata.DataIterator(_dcfg(cfg, bs=2, seq=12), prefetch=0).__next__()
    batch["frontend"] = torch.randn(2, cfg.encdec.enc_seq, cfg.d_model,
                                    generator=torch.Generator().manual_seed(0))
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    _, _, grads = ttrain.accumulate_grads(model, state["params"], batch, 1)
    assert float(grads["enc_pos"].abs().max()) > 0
    assert float(grads["enc_blocks.0.attn.w_q.w"].abs().max()) > 0


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,shard,n_shards", ((0, 0, 1), (5, 0, 1),
                                                 (3, 1, 4), (9, 3, 4)))
def test_batch_np_bit_equal_to_reference(step, shard, n_shards):
    cfg = dict(vocab_size=128, seq_len=33, global_batch=8, seed=7)
    got = tdata._batch_np(tdata.DataConfig(**cfg), step, shard, n_shards)
    want = jdata._batch_np(jdata.DataConfig(**cfg), step, shard, n_shards)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k])


def test_data_iterator_resumable_and_prefetch_equal():
    cfg = tdata.DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=7)
    it = tdata.DataIterator(cfg, prefetch=0)
    for _ in range(3):
        next(it)
    st = it.state()
    b1 = next(it)
    it2 = tdata.DataIterator.restore(cfg, st, prefetch=0)
    assert torch.equal(next(it2)["tokens"], b1["tokens"])
    pre = tdata.DataIterator(cfg, start_step=3, prefetch=2)
    b3 = next(pre)
    pre.close()
    assert b3["tokens"].dtype == torch.int32
    assert torch.equal(b3["tokens"], b1["tokens"])
    assert torch.equal(b3["labels"], b1["labels"])


def test_data_shards_are_disjoint_and_partition_the_batch():
    cfg = tdata.DataConfig(vocab_size=128, seq_len=32, global_batch=8, seed=7)
    parts = [tdata._batch_np(cfg, 3, i, 4) for i in range(4)]
    assert all(p["tokens"].shape == (2, 32) for p in parts)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(parts[i]["tokens"], parts[j]["tokens"])


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _state(dtype=torch.float32):
    cfg = dataclasses.replace(registry.get_config("smollm-360m", smoke=True),
                              dtype="bfloat16" if dtype == torch.bfloat16
                              else "float32")
    model = TT.init_params(cfg, device="cpu")
    return ttrain.init_train_state(model, _tiny(moments_dtype="bfloat16"))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_checkpoint_roundtrip_exact(tmp_path, dtype):
    state = _state(dtype)
    state["opt"]["step"] += 3
    ck = tckpt.Checkpointer(str(tmp_path), keep=2)
    ck.save(3, state, extra={"data": {"step": 3}}, blocking=False)
    ck.wait()
    restored, step, extra = ck.restore(state)
    assert step == 3 and extra["data"]["step"] == 3
    got, want = dict(_leaves(restored)), dict(_leaves(state))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        assert got[k] is not v


def test_checkpoint_gc_and_latest(tmp_path):
    state = _state()
    ck = tckpt.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.committed_steps() == [3, 4]
    assert ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == [
        "latest", "step_000000003", "step_000000003.COMMITTED",
        "step_000000004", "step_000000004.COMMITTED"]


def test_checkpoint_corruption_falls_back(tmp_path):
    state = _state()
    ck = tckpt.Checkpointer(str(tmp_path), keep=3)
    ck.save(1, state)
    state2 = {**state, "opt": {**state["opt"],
                               "step": state["opt"]["step"] + 2}}
    ck.save(2, state2)
    with open(os.path.join(str(tmp_path), "step_000000002", "arrays.npz"),
              "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    restored, step, _ = ck.restore(state)
    assert step == 1 and int(restored["opt"]["step"]) == 0
    with pytest.raises(FileNotFoundError):
        tckpt.Checkpointer(str(tmp_path / "empty")).restore(state)


# ---------------------------------------------------------------------------
# The fault-tolerant loop
# ---------------------------------------------------------------------------


def _run_loop(path, fail_at=None, steps=12, wrap=None):
    cfg = registry.get_config("smollm-360m", smoke=True)
    model = TT.init_params(cfg, device="cpu")
    state = ttrain.init_train_state(model, _tiny())
    step = ttrain.make_train_step(model, _tiny())
    if wrap is not None:
        step = wrap(step)
    inj = ttrainer.FaultInjector(fail_at) if fail_at else None
    return ttrainer.train_loop(
        step, state, _dcfg(cfg),
        ttrainer.LoopConfig(total_steps=steps, ckpt_every=4, log_every=100),
        str(path), fault_injector=inj, log=lambda s: None)


def test_fault_recovery_bitexact(tmp_path):
    clean, _ = _run_loop(tmp_path / "clean")
    faulty, info = _run_loop(tmp_path / "faulty",
                             fail_at={6: "sim-preemption",
                                      9: "sim-device-loss"})
    assert info["failures"] == 2
    for k, v in clean["params"].items():
        assert torch.equal(v, faulty["params"][k]), k
    for k, v in clean["opt"]["mu"].items():
        assert torch.equal(v, faulty["opt"]["mu"][k]), k


def test_resume_from_checkpoint_continues(tmp_path):
    _run_loop(tmp_path, steps=8)
    _, info = _run_loop(tmp_path, steps=12)
    assert info["history"][0]["step"] == 9
    assert [h["step"] for h in info["history"]] == [9, 10, 11, 12]


def test_nan_guard_restores_and_skips_a_poisoned_batch(tmp_path):
    """A non-finite loss is a failure: restored from the last checkpoint
    (step 4) and retried once; at the second NaN on data step 5's batch
    that batch is skipped, and the loop goes on from data step 6 with the
    restored state."""
    cfg = registry.get_config("smollm-360m", smoke=True)
    poison = tdata._batch_np(_dcfg(cfg), 5)["tokens"]
    calls = {"poisoned": 0}

    def wrap(step):
        def fn(state, batch):
            new, m = step(state, batch)
            if np.array_equal(batch["tokens"].numpy(), poison):
                calls["poisoned"] += 1
                m = dict(m, loss=torch.tensor(float("nan")))
            return new, m
        return fn

    state, info = _run_loop(tmp_path, steps=8, wrap=wrap)
    assert calls["poisoned"] == 2 and info["failures"] == 2
    assert [h["step"] for h in info["history"]] == [1, 2, 3, 4, 5, 5, 7, 8]
    assert all(np.isfinite(h["loss"]) for h in info["history"])
    assert int(state["opt"]["step"]) == 6


def test_loss_decreases_on_structured_data():
    """The reference's ``test_loss_decreases_on_structured_data`` on the
    port: 40 steps of smollm smoke on the synthetic pipeline."""
    cfg = registry.get_config("smollm-360m", smoke=True)
    model = TT.init_params(cfg, device="cpu")
    state = ttrain.init_train_state(model, _tiny())
    step = ttrain.make_train_step(model, _tiny())
    it = tdata.DataIterator(_dcfg(cfg), prefetch=0)
    losses = []
    for _ in range(40):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)


def test_training_with_topk_compression_converges():
    cfg = registry.get_config("smollm-360m", smoke=True)
    model = TT.init_params(cfg, device="cpu")
    tcfg = dataclasses.replace(_tiny(), compression=tcompress.
                               CompressionConfig(kind="topk", topk_frac=0.3))
    state = ttrain.init_train_state(model, tcfg)
    step = ttrain.make_train_step(model, tcfg)
    it = tdata.DataIterator(_dcfg(cfg), prefetch=0)
    losses = []
    for _ in range(40):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    assert "err" in state
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _launch(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


@pytest.mark.parametrize("arch", ("smollm-360m", "whisper-small"))
def test_launcher_trains_on_the_cpu(arch, tmp_path):
    out = _launch("--arch", arch, "--smoke", "--device", "cpu", "--steps",
                  "6", "--seq-len", "16", "--global-batch", "4",
                  "--microbatches", "2", "--ckpt-every", "3", "--compress",
                  "int8", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "[train] done: 6 steps" in out.stdout
    assert "ms/step" in out.stdout
    assert tckpt.Checkpointer(str(tmp_path)).latest_step() == 6


def test_launcher_mesh_flags_raise(tmp_path):
    """``--model-parallel`` above 1 needs the ranks of a ``torchrun``
    launch (sharded training runs under it: ``tests/test_torch_tp_train.py``);
    the production meshes still raise, naming A 4.3."""
    for flags in (("--model-parallel", "2"), ("--production-mesh",),
                  ("--multi-pod",)):
        out = _launch("--arch", "smollm-360m", "--smoke", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), *flags)
        assert out.returncode != 0
        if flags[0] == "--model-parallel":
            assert "needs a world of ranks" in out.stderr
            assert "torch.distributed.run" in out.stderr
        else:
            assert "ROADMAP.md queue A, item 4.3" in out.stderr


@pytest.mark.parametrize("arch,remat", (("smollm-360m", "block"),
                                        ("smollm-360m", "none"),
                                        ("qwen3-moe-235b-a22b", "block"),
                                        ("llama4-maverick-400b-a17b",
                                         "block"),
                                        ("whisper-small", "block")))
def test_expected_train_launches_count_the_pwconv_calls(arch, remat,
                                                        monkeypatch):
    """The ``pwconv`` calls of one loss and backward, counted on the CPU
    where each would be a launch on the card: every Linear of the forward,
    again in the remat's recomputed forward, and each gate's recomputed
    pre-activation."""
    from repro_torch.core import pwconv as core_pw
    from repro_torch.launch import train as ltrain
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              remat=remat)
    model = TL.trainable_(TT.init_params(cfg, device="cpu"))
    jcfg = dataclasses.replace(configs(arch, "float32")[0], remat=remat)
    _, bt = _lm_batch(jcfg, 12, 3)
    calls = []
    real = core_pw._op
    monkeypatch.setattr(core_pw, "_op", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    loss, _ = TT.loss_fn(model, bt)
    loss.backward()
    assert ltrain.expected_train_launches(cfg) == {
        "dwconv1d": 0, "dwconv1d_bwd": 0, "pwconv": len(calls)}
