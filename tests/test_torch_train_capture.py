"""The captured train step's body on the CPU: ``train_step_into`` (the step
on static buffers that ``capture_train_step`` captures as one CUDA graph
on the card) against the functional step it must equal bit for bit, and
against the reference's jitted, donated step; the in-place AdamW and
error feedback against their functional forms; the donation (the state
returned is the buffers, a restored state is copied in); the loop's
recovery through it; and ``train_e2e``, the port's ``examples/
train_e2e.py``.

On the CPU no graph can be captured: :class:`EagerReplay` stands in for
the graph in a :class:`~repro_torch.train.train_step.CapturedTrainStep`,
running the step's body where the card would replay it, so the host side
of the captured step (copy-in, the host's step counter, the metrics'
copies) runs here as it does there.
The card's own checks (graph against eager per family, the ``dwconv1d``
backward replayed, a failing capture) are in ``tests/test_torch_cuda.py``.

The reference runs fp32 with ``impl="xla"`` (its default on this CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, rand, to_torch
from repro.data import pipeline as jdata
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import pipeline as tdata
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_step as ttrain
from repro_torch.train import trainer as ttrainer

#: One smoke config of each family that trains.
FAMILIES = ("smollm-360m", "qwen3-moe-235b-a22b", "whisper-small",
            "xlstm-125m", "hymba-1.5b")
SEED = 3


def _tcfg(microbatches=1, kind="none", **opt):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=100, weight_decay=0.1)
    cfg.update(opt)
    return ttrain.TrainConfig(
        optimizer=tadamw.AdamWConfig(**cfg), microbatches=microbatches,
        compression=tcompress.CompressionConfig(kind=kind, topk_frac=0.1))


def _batches(cfg, n, bs=4, seq=16):
    it = tdata.DataIterator(tdata.DataConfig(cfg.vocab_size, seq, bs,
                                             seed=1), prefetch=0)
    out = []
    for _ in range(n):
        b = next(it)
        if cfg.encdec is not None:
            b["frontend"] = torch.randn(
                bs, cfg.encdec.enc_seq, cfg.d_model,
                generator=torch.Generator().manual_seed(len(out)))
        out.append(b)
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_equal(got: dict, want: dict):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


class EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the call
    (``graphs.Captured.replay``'s one method)."""

    def __init__(self, fn):
        self.fn, self.launches, self.capture_s = fn, {}, 0.0

    def replay(self):
        return self.fn()


def _stand_in(model, tcfg, batch_like: dict, seed: int = SEED):
    """A ``CapturedTrainStep`` whose graph is :class:`EagerReplay` of
    ``train_step_into`` on static buffers, built as ``capture_train_step``
    builds them (the state a copy of the model's weights)."""
    ttrain.trainable_(model)
    weights = {n: p.detach() for n, p in model.named_parameters()}
    state = ttrain._state_of({n: w.clone() for n, w in weights.items()},
                             tcfg)
    bufs = {k: torch.zeros_like(v) for k, v in batch_like.items()}
    metrics = {}
    replay = EagerReplay(lambda: ttrain.train_step_into(
        model, state, bufs, tcfg, metrics, seed=seed))
    return ttrain.CapturedTrainStep(replay, state, bufs, metrics)


# ---------------------------------------------------------------------------
# The step on static buffers against the functional step
# ---------------------------------------------------------------------------


#: (microbatches, compression) for every family: each value of each once.
STEP_OPTIONS = ((1, "none"), (2, "topk"), (1, "int8"))


@pytest.mark.parametrize("microbatches,kind", STEP_OPTIONS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_into_bit_equal_to_functional_step(arch, microbatches,
                                                      kind):
    """Three steps of ``train_step_into`` on static buffers and of
    ``make_train_step``'s step from the same state on the same batches:
    after each, the parameters, moments, step, compression error and
    every metric bit for bit; the state returned is the buffers passed
    in, and int8's noise is the functional step's (keyed by the same seed
    and step)."""
    cfg = registry.get_config(arch, smoke=True)
    model = TT.init_params(cfg, seed=0, device="cpu")
    tcfg = _tcfg(microbatches, kind)
    eager_state = ttrain.init_train_state(model, tcfg)
    state = ttrain._state_of({k: v.clone() for k, v in
                              eager_state["params"].items()}, tcfg)
    ptrs = {k: v.data_ptr() for k, v in _leaves(state)}
    eager = ttrain.make_train_step(model, tcfg, seed=SEED)
    metrics = {}
    for i, batch in enumerate(_batches(cfg, 3)):
        eager_state, eager_m = eager(eager_state, batch)
        out, m = ttrain.train_step_into(model, state, batch, tcfg, metrics,
                                        seed=SEED)
        assert out is state and m is metrics
        assert {k: v.data_ptr() for k, v in _leaves(out)} == ptrs
        _assert_equal(out, eager_state)
        assert set(m) == set(eager_m)
        for k in m:
            assert torch.equal(m[k], eager_m[k]), k
    assert int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("arch", ("smollm-360m", "xlstm-125m"))
def test_train_step_into_matches_reference_jitted_donated_step(arch):
    """``train_step_into``'s losses against the reference's ``jax.jit
    (make_train_step(...), donate_argnums=(0,))`` on the reference's own
    batches (``_batch_np``), fp32: step 1 at 1e-5 and its optimizer
    metrics at 1e-4, steps 2-3 at 1e-3 (AdamW amplifies a last-bit
    difference in the gradients)."""
    jcfg, tcfg_model = configs(arch, "float32")
    jcfg = dataclasses.replace(jcfg, scan_layers=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = ttrain.trainable_(convert.lm_params_from_numpy(jp, tcfg_model,
                                                           device="cpu"))
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=100, weight_decay=0.0)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainConfig(
        optimizer=jadamw.AdamWConfig(**opt))), donate_argnums=(0,))
    jstate = {"params": jp, "opt": jadamw.init_state(jp)}
    tcfg = _tcfg(**opt)
    state = ttrain.init_train_state(model, tcfg)
    dc = jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                          global_batch=4, seed=7)
    metrics = {}
    for s in range(3):
        batch = jdata._batch_np(dc, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        state, tm = ttrain.train_step_into(
            model, state, {k: torch.from_numpy(v) for k, v in batch.items()},
            tcfg, metrics)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if s == 0 else 1e-3)
        if s == 0:
            for k in ("grad_norm", "lr", "nll", "tokens"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-4)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == s + 1


# ---------------------------------------------------------------------------
# In-place AdamW and error feedback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
@pytest.mark.parametrize("pdtype", ("float32", "bfloat16"))
def test_apply_updates_in_place_bit_equal(pdtype, moments):
    """Four steps of ``apply_updates_`` and ``apply_updates`` on the same
    gradients (a clipped one among them; decayed and undecayed names):
    every parameter, moment, the step and the metrics bit for bit, each
    written into the tensor it was given."""
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                             clip_norm=3.0, moments_dtype=moments)
    rng = np.random.default_rng(0)
    shapes = {"blocks.0.attn.w_q.w": (6, 4), "blocks.0.attn.w_q.b": (4,),
              "blocks.0.ln_attn.scale": (6,), "embedding.table": (5, 6)}
    p = {k: to_torch(rand(rng, s), pdtype) for k, s in shapes.items()}
    state = tadamw.init_state(p, cfg)
    bufs = {"p": {k: v.clone() for k, v in p.items()},
            "opt": tadamw.init_state(p, cfg)}
    ptrs = {k: v.data_ptr() for k, v in _leaves(bufs)}
    for step in range(4):
        g = {k: torch.from_numpy(rand(rng, s, 3.0 if step == 2 else 0.1))
             for k, s in shapes.items()}
        p, state, m = tadamw.apply_updates(p, g, state, cfg)
        m_ = tadamw.apply_updates_(bufs["p"], g, bufs["opt"], cfg)
        _assert_equal(bufs, {"p": p, "opt": state})
        assert {k: v.data_ptr() for k, v in _leaves(bufs)} == ptrs
        assert set(m_) == set(m) and all(torch.equal(m_[k], m[k]) for k in m)
    assert int(bufs["opt"]["step"]) == 4


@pytest.mark.parametrize("kind", ("topk", "int8"))
def test_compress_in_place_bit_equal(kind):
    """``compress_`` against ``compress``: the same compressed gradients
    and new error bit for bit (int8 from one key), the error written into
    its own tensors."""
    rng = np.random.default_rng(1)
    g = {n: torch.from_numpy(rand(rng, s)) for n, s in
         (("a", (64,)), ("b", (8, 12)))}
    err = {n: torch.from_numpy(rand(rng, t.shape, 0.01)) for n, t in
           g.items()}
    err_ = {n: t.clone() for n, t in err.items()}
    ptrs = {n: t.data_ptr() for n, t in err_.items()}
    cfg = tcompress.CompressionConfig(kind=kind, topk_frac=0.1)
    key = 5 if kind == "int8" else None
    comp, new_err = tcompress.compress(g, err, cfg, key=key)
    comp_ = tcompress.compress_(g, err_, cfg, key=key)
    _assert_equal(comp_, comp)
    _assert_equal(err_, new_err)
    assert {n: t.data_ptr() for n, t in err_.items()} == ptrs
    if kind == "int8":
        with pytest.raises(ValueError, match="key"):
            tcompress.compress_(g, err_, cfg)


# ---------------------------------------------------------------------------
# The donation: the host side of the captured step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("none", "int8"))
def test_captured_step_returns_its_buffers_and_copies_a_restored_state_in(
        kind, tmp_path):
    """Through a ``CapturedTrainStep`` (its graph stood in for): the state
    returned is its own buffers at their addresses, and handed back it is
    not copied; a state ``Checkpointer.restore`` made is copied into the
    buffers (their addresses kept) and the host's step is taken from it;
    every step equals the functional step's bits, int8's noise too."""
    cfg = registry.get_config("smollm-360m", smoke=True)
    model = TT.init_params(cfg, seed=0, device="cpu")
    tcfg = _tcfg(kind=kind)
    eager_state = ttrain.init_train_state(model, tcfg)
    eager = ttrain.make_train_step(model, tcfg, seed=SEED)
    batches = _batches(cfg, 4)
    step = _stand_in(model, tcfg, batches[0])
    ptrs = {k: v.data_ptr() for k, v in _leaves(step.state)}
    state = ttrain.init_train_state(model, tcfg)
    ck = tckpt.Checkpointer(str(tmp_path))
    for i, batch in enumerate(batches):
        if i == 2:                       # a restored state: new tensors
            ck.save(2, state)
            state, _, _ = ck.restore(state)
            assert state is not step.state
            _assert_equal(state, step.state)
            step.step = -1               # the copy-in must reset it
        eager_state, em = eager(eager_state, batch)
        state, m = step(state, batch)
        assert state is step.state and step.step == i + 1
        assert {k: v.data_ptr() for k, v in _leaves(state)} == ptrs
        _assert_equal(state, eager_state)
        assert all(torch.equal(m[k], em[k]) for k in em)
        assert all(m[k] is not v for k, v in step.metrics.items())
    with pytest.raises(ValueError, match="shape"):
        step(state, {k: v[:2] for k, v in batches[0].items()})


def _loop(path, step, state, cfg, fail_at=None, wrap=None):
    if wrap is not None:
        step = wrap(step)
    return ttrainer.train_loop(
        step, state, tdata.DataConfig(cfg.vocab_size, 16, 4, seed=7),
        ttrainer.LoopConfig(total_steps=12, ckpt_every=4, log_every=100),
        str(path), fault_injector=ttrainer.FaultInjector(fail_at)
        if fail_at else None, log=lambda s: None)


def test_loop_over_the_step_into_recovers_bit_exactly(tmp_path):
    """``train_loop`` over the static-buffer step, with faults injected at
    steps 6 and 9, ends with the clean run's state bit for bit, and with
    the functional step's clean run's."""
    cfg = registry.get_config("smollm-360m", smoke=True)
    tcfg = _tcfg(weight_decay=0.0)
    like = _batches(cfg, 1)[0]
    runs = {}
    for name, fail_at in (("clean", None), ("faulty", {6: "sim-preemption",
                                                       9: "sim-device-loss"})):
        model = TT.init_params(cfg, seed=0, device="cpu")
        step = _stand_in(model, tcfg, like)
        runs[name] = _loop(tmp_path / name, step, step.state, cfg, fail_at)
    model = TT.init_params(cfg, seed=0, device="cpu")
    eager, _ = _loop(tmp_path / "eager", ttrain.make_train_step(model, tcfg),
                     ttrain.init_train_state(model, tcfg), cfg)
    (clean, _), (faulty, info) = runs["clean"], runs["faulty"]
    assert info["failures"] == 2
    _assert_equal(faulty, clean)
    _assert_equal(clean, eager)


def _nan_run(tmp_path, nan_at: int):
    """The loop over the stand-in step, clean and with the loss of data
    step ``nan_at`` made NaN once after the step wrote its update; returns
    both final states and the faulty run's info."""
    cfg = registry.get_config("smollm-360m", smoke=True)
    tcfg = _tcfg(weight_decay=0.0)
    like = _batches(cfg, 1)[0]
    seen = {"nan": 0}

    def wrap(step):
        def fn(state, batch):
            before = step.state["opt"]["step"].clone()
            new, m = step(state, batch)
            if int(before) == nan_at and not seen["nan"]:
                seen["nan"] += 1
                assert int(new["opt"]["step"]) == nan_at + 1  # written
                m = dict(m, loss=torch.tensor(float("nan")))
            return new, m
        return fn

    finals = []
    for name, w in (("clean", None), ("nan", wrap)):
        model = TT.init_params(cfg, seed=0, device="cpu")
        step = _stand_in(model, tcfg, like)
        finals.append(_loop(tmp_path / name, step, step.state, cfg, wrap=w))
    (clean, _), (after, info) = finals
    assert seen["nan"] == 1 and info["failures"] == 1
    return clean, after


def test_nan_step_overwrites_the_donated_state_and_the_loop_restores(
        tmp_path):
    """A step whose loss is not finite has already written its update
    into the buffers (the donation); the loop restores the checkpoint of
    step 4, the step copies it in, and the retried batch goes through:
    the run ends with the clean run's state bit for bit."""
    clean, after = _nan_run(tmp_path, 5)
    _assert_equal(after, clean)


def test_nan_step_before_the_first_checkpoint_restores_the_start(tmp_path):
    """The same at step 2, before any checkpoint: the loop's host copy of
    the starting state is the restore point, the step copies it in (its
    host step back to 0), and the run ends with the clean run's bits."""
    clean, after = _nan_run(tmp_path, 2)
    _assert_equal(after, clean)


def test_capture_train_step_raises_on_a_cpu_model():
    cfg = registry.get_config("smollm-360m", smoke=True)
    model = TT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        ttrain.capture_train_step(model, _tcfg(), 2, 8)


# ---------------------------------------------------------------------------
# train_e2e, the port's examples/train_e2e.py
# ---------------------------------------------------------------------------


def test_train_e2e_runs_on_the_cpu(tmp_path, capsys):
    """``train_e2e`` at the reference's config (repro-103m) takes 2 steps
    at 2 x 8 tokens on the CPU (the eager step), writes its history and
    prints the reference's last line; its config is the reference's."""
    import json

    from repro_torch import train_e2e
    cfg = train_e2e.CONFIG_100M
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings, cfg.dtype,
            cfg.loss_chunk, cfg.attn_chunk) == (12, 768, 12, 4, 2048, 32768,
                                                True, "float32", 128, 256)
    out = tmp_path / "h.json"
    assert train_e2e.main(["--device", "cpu", "--steps", "2", "--seq-len",
                           "8", "--global-batch", "2", "--ckpt-dir",
                           str(tmp_path / "ck"), "--out", str(out)]) == 0
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    text = capsys.readouterr().out
    assert "[e2e] loss: first10=" in text and "last10=" in text
    assert tckpt.Checkpointer(str(tmp_path / "ck")).latest_step() == 2
