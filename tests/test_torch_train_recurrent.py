"""Training the recurrent families on one device, the port against the JAX
reference: ``dwconv1d``'s backward (the plain formulas against
``jax.vjp`` of the reference's oracle, and the autograd Function), the
selective scan's gradients, the mLSTM and sLSTM cells' gradients (both
branches of the sLSTM's chunk checkpoint), ``loss_fn`` and every gradient
of the xLSTM and hymba smoke configs, two train steps, the launcher, the
decay mask name by name, the launches a step makes, and the separable
backbone wrappers.

The reference runs with ``impl="xla"`` (its default on this CPU), fp32
(its bf16 dots cannot run under ``jit`` here; the ``dwconv1d`` backward is
also held in bf16, op by op).  Gradients are held to 1e-4 of each
gradient's largest magnitude, and one that is zero in exact arithmetic to
1e-6 of the model's largest (``_torch_parity.assert_grads``).
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

from _torch_parity import (SPECS, assert_grads, configs, jtree, lm, np32,
                           perturbed, rand, rel_err, to_jax, to_torch)
from repro.core import network as jnet
from repro.kernels import ref as jref
from repro.kernels.policy import KernelPolicy as JKernelPolicy
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
from repro_torch import convert
from repro_torch.core import network
from repro_torch.core import pwconv as core_pw
from repro_torch.kernels import dwconv1d as K
from repro_torch.kernels import ops
from repro_torch.launch import train as ltrain
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECURRENT = ("xlstm-125m", "hymba-1.5b")


# ---------------------------------------------------------------------------
# dwconv1d's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("length", (2, 13))
@pytest.mark.parametrize("k", (1, 3, 4, 5))
def test_dwconv1d_bwd_plain_matches_reference_vjp(k, length, dtype):
    """``dwconv1d_causal_bwd_plain``'s dx and df against ``jax.vjp`` of the
    reference's ``dwconv1d_causal_ref`` (L = 2 < K - 1 for K = 4, 5): fp32
    within 1e-5 and bf16 within 1e-2 of each one's largest magnitude, in
    x's and f's dtypes."""
    rng = np.random.default_rng(10 * k + length)
    x, f = rand(rng, (2, length, 12)), rand(rng, (k, 12), k ** -0.5)
    dy = rand(rng, (2, length, 12))
    _, vjp = jax.vjp(jref.dwconv1d_causal_ref, to_jax(x, dtype),
                     to_jax(f, dtype))
    want = vjp(to_jax(dy, dtype))
    got = K.dwconv1d_causal_bwd_plain(to_torch(x, dtype), to_torch(f, dtype),
                                      to_torch(dy, dtype))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, w in zip(got, want, strict=True):
        assert str(g.dtype) == f"torch.{dtype}" and str(w.dtype) == dtype
        assert rel_err(g, w) <= tol, rel_err(g, w)


@pytest.mark.parametrize("k,length", ((1, 6), (4, 2), (4, 9), (5, 7)))
def test_dwconv1d_function_gradcheck(k, length):
    """:class:`DwConv1dFn` (its plain forward and backward on the CPU)
    under ``torch.autograd.gradcheck`` in float64."""
    g = torch.Generator().manual_seed(k + length)
    x = torch.randn(2, length, 5, dtype=torch.float64, generator=g)
    f = torch.randn(k, 5, dtype=torch.float64, generator=g)
    assert torch.autograd.gradcheck(
        lambda x, f: K.DwConv1dFn.apply(x, f, "auto"),
        (x.requires_grad_(True), f.requires_grad_(True)))


def test_dwconv1d_op_is_the_function_only_under_autograd():
    """``ops.dwconv1d_causal`` is the Function: it records its backward
    under autograd and nothing in inference or with no operand needing a
    gradient, with the same bits; ``impl="cuda"`` on a CPU tensor raises."""
    x = torch.randn(2, 9, 8)
    f = torch.randn(4, 8, requires_grad=True)
    y = ops.dwconv1d_causal(x, f)
    assert y.grad_fn.name().endswith("DwConv1dFnBackward")
    with torch.inference_mode():
        y0 = ops.dwconv1d_causal(x, f)
    assert y0.grad_fn is None and torch.equal(y.detach(), y0)
    assert ops.dwconv1d_causal(x, f.detach()).grad_fn is None
    with pytest.raises(ValueError, match="CUDA"):
        ops.dwconv1d_causal(x, f, impl="cuda")


# ---------------------------------------------------------------------------
# The selective scan
# ---------------------------------------------------------------------------


def _scan_inputs(rng, length, di=6, n=4):
    u = rand(rng, (2, length, di))
    dt = np.log1p(np.exp(rand(rng, (2, length, di)))).astype(np.float32)
    a = -np.exp(rand(rng, (di, n), 0.5))
    b, c = rand(rng, (2, length, n)), rand(rng, (2, length, n))
    d_skip = rand(rng, (di,))
    return [u, dt, a, b, c, d_skip]


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("length,chunk", ((20, 8), (16, 8), (5, 8)))
def test_selective_scan_gradients_match_reference(length, chunk, with_h0):
    """Every input's gradient (u, dt, a, b, c, d_skip and h0) of a random
    cotangent on y and h_last against ``jax.grad`` of the reference's
    ``selective_scan``; L a multiple of the chunk, not one, and below it."""
    rng = np.random.default_rng(length + chunk + with_h0)
    args = _scan_inputs(rng, length)
    if with_h0:
        args.append(rand(rng, (2, 6, 4)))
    gy, gh = rand(rng, (2, length, 6)), rand(rng, (2, 6, 4))

    def jloss(*a):
        y, h = JS.selective_scan(*a[:6], chunk=chunk,
                                 h0=a[6] if with_h0 else None)
        return jnp.sum(y * gy) + jnp.sum(h * gh)
    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = TS.selective_scan(*ts[:6], chunk=chunk,
                             h0=ts[6] if with_h0 else None)
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    got = torch.autograd.grad(loss, ts)
    names = ["u", "dt", "a", "b", "c", "d_skip", "h0"][:len(args)]
    assert_grads(dict(zip(names, got)), dict(zip(names, want)))


def test_selective_scan_values_are_the_serving_bits():
    """Under autograd (``ChunkScanFn``) the scan gives the in-place
    serving scan's bits, and it keeps one state tensor a chunk."""
    args = [torch.from_numpy(a) for a in
            _scan_inputs(np.random.default_rng(3), 20)]
    h0 = torch.randn(2, 6, 4)
    with torch.inference_mode():
        want = TS.selective_scan(*args, chunk=8, h0=h0)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        got = TS.selective_scan(*[a.clone().requires_grad_(True)
                                  for a in args], chunk=8, h0=h0)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.detach(), w)
    # per chunk: da (exp's output, the Function's) and the states (the
    # Function's, the einsum's), where autograd through the three doubling
    # steps would keep two more a step
    big = [s for s in saved if s.numel() >= 2 * 8 * 6 * 4]
    assert len(big) <= 4 * 3, saved


# ---------------------------------------------------------------------------
# The xLSTM cells
# ---------------------------------------------------------------------------


def _cell_args(rng, length, gates):
    q, k, v = (rand(rng, (2, length, 2, 4)) for _ in range(3))
    if gates == "mlstm":
        return [q, k, v, rand(rng, (2, length, 2)),
                np.log(1 / (1 + np.exp(-rand(rng, (2, length, 2))))).astype(
                    np.float32)]
    return [rand(rng, (2, length, 2, 4)) for _ in range(4)] + [
        rand(rng, (2, 4, 16), 0.5)]


def _grads_of(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, state = fn(*ts)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip((out, *state), cot))
    return torch.autograd.grad(loss, ts)


def _jgrads_of(fn, args, cot):
    def jloss(*a):
        out, state = fn(*a)
        return sum(jnp.sum(o * c) for o, c in zip((out, *state), cot))
    return jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))


@pytest.mark.parametrize("length,chunk", ((16, 4), (10, 4), (3, 8)))
def test_mlstm_chunkwise_gradients_match_reference(length, chunk):
    """q, k, v and both gates' gradients of a random cotangent on h and
    the final (c, n, m) against the reference's ``mlstm_chunkwise``: whole
    chunks, a padded last chunk (the ``NEG_INF`` input gate) and one chunk
    shorter than asked."""
    rng = np.random.default_rng(length + chunk)
    args = _cell_args(rng, length, "mlstm")
    cot = [rand(rng, s) for s in ((2, length, 2, 4), (2, 2, 4, 4),
                                  (2, 2, 4), (2, 2))]
    got = _grads_of(lambda *a: TX.mlstm_chunkwise(*a, chunk=chunk), args, cot)
    want = _jgrads_of(lambda *a: JX.mlstm_chunkwise(*a, chunk=chunk), args,
                      cot)
    names = ["q", "k", "v", "igate", "logf"]
    assert_grads(dict(zip(names, got)), dict(zip(names, want)))


@pytest.mark.parametrize("length,chunk", ((16, 4), (10, 4), (4, 4)))
def test_slstm_scan_gradients_match_reference(length, chunk, monkeypatch):
    """The four gates' and the recurrent weights' gradients against the
    reference's ``slstm_scan``: L = 16 takes the chunk checkpoint (L %
    chunk == 0 and L > chunk, one checkpoint a chunk), L = 10 and L =
    chunk the plain loop; the values are the plain loop's bits either
    way."""
    rng = np.random.default_rng(length + 3 * chunk)
    args = _cell_args(rng, length, "slstm")
    cot = [rand(rng, s) for s in ((2, length, 2, 4),) + ((2, 2, 4),) * 4]
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    got = _grads_of(lambda *a: TX.slstm_scan(*a, chunk=chunk), args, cot)
    checkpointed = length % chunk == 0 and length > chunk
    assert len(calls) == (length // chunk if checkpointed else 0)
    want = _jgrads_of(lambda *a: JX.slstm_scan(*a, chunk=chunk), args, cot)
    names = ["zg", "ig", "fg", "og", "r"]
    assert_grads(dict(zip(names, got)), dict(zip(names, want)))
    ts = [torch.from_numpy(a) for a in args]
    with torch.inference_mode():
        plain = TX.slstm_scan(*ts, chunk=chunk)
    grad = TX.slstm_scan(*[t.clone().requires_grad_(True) for t in ts],
                         chunk=chunk)
    assert torch.equal(grad[0].detach(), plain[0])


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------


def _lm_batch(jcfg, s: int, seed: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (2, s))
    labels = rng.integers(0, jcfg.vocab_size, (2, s))
    labels[0, :3] = -1
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _port_grads(model, batch):
    TL.trainable_(model)
    loss, metrics = TT.loss_fn(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch,s,kw", (
    ("xlstm-125m", 20, {}), ("xlstm-125m", 32, {}),
    ("xlstm-125m", 24, {"remat": "none"}), ("hymba-1.5b", 20, {}),
    ("hymba-1.5b", 40, {"attn_chunk": 16})))
def test_loss_fn_and_gradient_match_reference(arch, s, kw):
    """``loss_fn``'s loss and metrics (rtol 1e-5) and the gradient of every
    parameter (hymba's meta tokens included) against ``jax.value_and_grad``
    of the reference's ``loss_fn``, fp32.  xLSTM at 20 tokens pads the
    mLSTM chunk of 8 and runs the sLSTM loop plain; at 32 the sLSTM loop
    is chunk-checkpointed; at 24 without per-layer remat.  hymba at 20
    tokens (28 positions with the meta tokens: dense attention, a padded
    scan chunk) and at 40 with ``attn_chunk`` 16 (the flash backward with
    window and sink)."""
    if kw:
        jcfg, tcfg = configs(arch, "float32", **kw)
        jp = perturbed(JT.init_params(jcfg, jax.random.PRNGKey(0)))
        model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
        jp = jtree(jp)
    else:
        jcfg, jp, model = lm(arch, "float32")
        model = convert.lm_params_from_numpy(jp, model.cfg, device="cpu")
    bj, bt = _lm_batch(jcfg, s, s)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, bj), has_aux=True)(jp)
    lt, mt, gt = _port_grads(model, bt)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]),
                                   rtol=1e-5, atol=1e-7)
    want = convert.lm_leaves(gj, len(model.pattern))
    assert_grads(gt, want)
    if arch == "hymba-1.5b":
        assert float(gt["meta"].abs().max()) > 0


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _opt(microbatches):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=100, weight_decay=0.1)
    return (ttrain.TrainConfig(optimizer=tadamw.AdamWConfig(**cfg),
                               microbatches=microbatches),
            jtrain.TrainConfig(optimizer=jadamw.AdamWConfig(**cfg),
                               microbatches=microbatches))


@pytest.mark.parametrize("microbatches", (1, 2))
@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_reference(arch, microbatches):
    """Two steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` on the same 4 x 16 batches, fp32: step 1's loss
    (rtol 1e-5), optimizer metrics (1e-4) and accumulated gradients (1e-4
    of each one's largest), step 2's loss (1e-3); held on losses and
    gradients, never on parameters after a step (AdamW amplifies a
    last-bit difference)."""
    jcfg, tcfg = configs(arch, "float32")
    jcfg = dataclasses.replace(jcfg, scan_layers=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, 128, (4, 16)).astype(np.int32),
                "labels": rng.integers(0, 128, (4, 16)).astype(np.int32)}
               for _ in range(2)]
    topt, jopt = _opt(microbatches)
    jstate = {"params": jp, "opt": jadamw.init_state(jp)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt))
    tstate = ttrain.init_train_state(model, topt)
    tstep = ttrain.make_train_step(model, topt)
    mb, want = microbatches, None
    for i in range(mb):
        part = {k: jnp.asarray(v[i * 4 // mb:(i + 1) * 4 // mb])
                for k, v in batches[0].items()}
        g = jax.grad(lambda p: JT.loss_fn(jcfg, p, part)[0])(jp)
        want = g if want is None else jax.tree_util.tree_map(jnp.add, want, g)
    want = convert.lm_leaves(jax.tree_util.tree_map(lambda a: a / mb, want),
                             len(model.pattern))
    got = ttrain.accumulate_grads(model, tstate["params"],
                                  {k: torch.from_numpy(v) for k, v in
                                   batches[0].items()}, mb)[2]
    assert_grads(got, want)
    for s, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in
                                    batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if s == 0 else 1e-3)
        if s == 0:
            for k in ("grad_norm", "lr", "nll", "tokens"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-4)
        assert int(tstate["opt"]["step"]) == s + 1


@pytest.mark.parametrize("arch", RECURRENT)
def test_decay_mask_matches_reference_name_by_name(arch):
    """Every parameter's weight-decay decision (``a_log``, ``dt_bias``,
    ``d_skip``, the norms, the recurrent weights ``r``, ``conv``, the meta
    tokens, the Linears' ``w`` and ``b``) against the reference's
    ``_decay_mask`` of the same leaf."""
    jcfg, jp, model = lm(arch, "float32")
    decisions = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(np.shape(a), jadamw._decay_mask(path)), jp)
    want = convert.lm_leaves(decisions, len(model.pattern))
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    for n in names:
        assert tadamw.decays(n) == bool(np.asarray(want[n]).flat[0]), n
    assert not any(tadamw.decays(n) for n in names
                   if n.rsplit(".", 1)[-1] in ("dt_bias", "d_skip"))


# ---------------------------------------------------------------------------
# Launches a step, and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ("block", "none"))
@pytest.mark.parametrize("arch", RECURRENT)
def test_expected_train_launches_count_the_kernel_calls(arch, remat,
                                                        monkeypatch):
    """The kernel calls of one loss and backward, counted on the CPU where
    each would be a launch on the card: ``pwconv`` (every Linear, again in
    the remat, each gate's recomputed pre-activation), ``dwconv1d``'s
    forward (again in the remat) and its backward (one kernel)."""
    cfg = dataclasses.replace(configs(arch, "float32")[1], remat=remat)
    model = TL.trainable_(TT.init_params(cfg, device="cpu"))
    _, bt = _lm_batch(cfg, 12, 3)
    calls = {"pwconv": 0, "dwconv1d": 0, "dwconv1d_bwd": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(core_pw, "_op", counting("pwconv", core_pw._op))
    monkeypatch.setattr(K, "dwconv1d_causal_plain",
                        counting("dwconv1d", K.dwconv1d_causal_plain))
    monkeypatch.setattr(K, "dwconv1d_causal_bwd_plain",
                        counting("dwconv1d_bwd", K.dwconv1d_causal_bwd_plain))
    loss, _ = TT.loss_fn(model, bt)
    loss.backward()
    assert ltrain.expected_train_launches(cfg) == calls
    assert calls["dwconv1d"] == (2 if remat == "block" else 1) * cfg.n_layers


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_trains_on_the_cpu(arch, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "4", "--seq-len", "16",
         "--global-batch", "2", "--ckpt-every", "2", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "[train] done: 4 steps" in out.stdout
    assert "ms/step" in out.stdout


# ---------------------------------------------------------------------------
# The separable backbone wrappers
# ---------------------------------------------------------------------------


def test_backbone_matches_reference():
    """``init_backbone`` gives ``init_network``'s parameters, and
    ``backbone`` on ``mobilenet_v2_spec(0.25)`` with the reference's
    weights converted matches the reference's ``backbone`` under
    ``impl="xla"`` at fp32 2e-5."""
    jspec = getattr(jnet, SPECS["v2"])(0.25)
    spec = getattr(network, SPECS["v2"])(0.25)
    rng = np.random.default_rng(0)
    jp = JL.init_backbone(jax.random.PRNGKey(0), jspec)
    np_blocks = [[{k: rand(rng, v.shape, v.shape[0] ** -0.5 if k == "w"
                           else 1 / 3 if k == "f" else 0.1)
                   for k, v in st.items()} for st in b]
                 for b in jp["blocks"]]
    x = rand(np.random.default_rng(1), (2, 32, 32, spec.c_in))
    want = JL.backbone({"blocks": [[{k: to_jax(v) for k, v in st.items()}
                                    for st in b] for b in np_blocks]},
                       to_jax(x), net=jspec,
                       policy=JKernelPolicy(impl="xla", on_failure="raise"))
    got = TL.backbone({"blocks": convert.params_from_numpy(np_blocks, "cpu")},
                      to_torch(x), net=spec)
    assert rel_err(got, want) <= 2e-5
    mine = TL.init_backbone(spec, seed=3, device="cpu")
    same = network.init_network(spec, seed=3, device="cpu")
    assert all(torch.equal(mine["blocks"][i][j][k], v)
               for i, b in enumerate(same) for j, st in enumerate(b)
               for k, v in st.items())
    assert np32(got).shape == tuple(want.shape)
