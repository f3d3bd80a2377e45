"""The training step: loss -> grads -> (compress) -> AdamW.  Counterpart
of ``repro/train/train_step.py``, on one device.

The state is ``{"params": {name: tensor}, "opt": {"mu", "nu", "step"}[,
"err"]}``, the names the model's own (``LMModel.named_parameters``).  Two
forms of one step, the same bits:

* :func:`make_train_step`'s step is functional: it binds the state's
  parameters to the model (each ``nn.Parameter``'s data set to the
  state's tensor, no copy), runs ``loss_fn`` and its backward, and returns
  a new state of new tensors, never writing into the old one, so a failed
  step leaves its input state as it was.  It runs on the CPU, and it is
  the oracle of the captured step.
* :func:`capture_train_step` is the reference's ``jax.jit(make_train_step
  (...), donate_argnums=(0,))`` on the card: :func:`train_step_into`
  (the step on static buffers, updating the parameters, moments, step and
  compression error in place) captured as one CUDA graph of the whole
  step, forward, backward, compression and AdamW.  The state it returns is
  its own buffers, which the next call updates in place (the donation); a
  call handed any other state (one ``Checkpointer.restore`` made) copies
  it in first.

Microbatch gradients accumulate in fp32 (reference :42-71).

Under a mesh (the rules in force when the step is made, which it keeps
and sets around every call): every rank takes the whole global batch and
the same microbatches of it (the reference's ``reshape(mb, b // mb)``),
``loss_fn`` keeps the rank's rows, and the loss is the global mean.  The
backward reduce-scatters the FSDP leaves' gradients over "data" as it
goes (``layers.fsdp_gather``); after it (after the microbatches' fp32
sums) the gradients of the leaves whole over "data" are summed over it,
in one ``all_reduce`` a dtype.  AdamW then takes the global norm and
updates its ZeRO-1 blocks (``optim/adamw.py`` with the state's
``sharding.rules.StateLayout``).

Compression (``optim/compress.py``) runs on the reduced gradient, the
rank's blocks under a mesh: ``topk`` keeps the whole tensor's top
``topk_frac`` and ``int8`` scales by the whole tensor's max, as the
reference's compressors of its global gradient do, a tensor being the
reference's stack of a layer variant's leaf (``transformer.
param_stacks``); ``int8``'s noise is a counter-based draw keyed by
:func:`noise_key` (the seed and the state's step, read on the device, so
inside a captured step too), the same on every mesh and on every replica
of a block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import graphs
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import transformer as T
from repro_torch.models.layers import trainable_
from repro_torch.optim import adamw
from repro_torch.optim.compress import (CompressionConfig, compress,
                                        compress_, init_error)
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import (StateLayout, current_rules,
                                        train_layout, use_rules)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    compression: CompressionConfig = CompressionConfig()


def bind_params_(model: T.LMModel, params: dict) -> T.LMModel:
    """Point each parameter of ``model`` at the tensor of the same name in
    ``params`` (no copy): how a step, and a caller serving the trained
    weights, gives the model a state's parameters.  Returns ``model``."""
    for name, p in model.named_parameters():
        t = params[name]
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} for a "
                             f"parameter of {tuple(p.shape)} {p.dtype}")
        p.data = t
    return model


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}


def state_layout(model: T.LMModel, rules=None) -> Optional[StateLayout]:
    """How ``model``'s train state lies over the mesh of ``rules``
    (default: the context's): its parameters' and ZeRO-1 moments' specs
    from the unsharded shapes, and the leaves cut part by part
    (``transformer.param_parts``); None without a mesh of more than one
    rank."""
    r = rules if rules is not None else current_rules()
    if r is None:
        return None
    return train_layout(T.whole_shapes(model.cfg), r, T.param_parts(model))


def reduce_replicated_grads(grads: dict, layout: Optional[StateLayout]):
    """Each gradient of a leaf whole over a batch axis summed over that
    axis (each rank's rows gave a part of it), in place of the old tensor
    in ``grads``: the leaves of one dtype travel in one ``all_reduce``."""
    if layout is None:
        return grads
    r = current_rules()
    for axis in r.batch_axes:
        if layout.mesh.shape[axis] == 1:
            continue
        names = [n for n in grads if axis not in layout.axes(n)]
        for dtype in sorted({grads[n].dtype for n in names}, key=str):
            part = [n for n in names if grads[n].dtype == dtype]
            flat = collectives.all_reduce(
                torch.cat([grads[n].reshape(-1) for n in part]),
                layout.mesh.group(axis))
            at = 0
            for n in part:
                size = grads[n].numel()
                grads[n] = flat[at:at + size].view(grads[n].shape)
                at += size
    return grads


def accumulate_grads(model: T.LMModel, params: dict, batch: dict,
                     microbatches: int = 1,
                     policy: KernelPolicy = DEFAULT_POLICY,
                     layout: Optional[StateLayout] = None):
    """(loss, metrics, grads) of ``loss_fn`` at ``params`` (bound to
    ``model``, whose parameters must require grad) over ``batch`` (moved
    to the model's device): with one microbatch the gradients in the
    parameters' dtypes; with more, each microbatch's added in fp32 and the
    sums (and the loss) divided by their number, the metrics the last
    microbatch's (the reference's scan).  Under ``layout`` (a mesh in
    force) ``batch`` is the global one and the gradients are the rank's
    blocks, those of leaves whole over "data" summed over it
    (:func:`reduce_replicated_grads`)."""
    dev = model.embedding["table"].device
    batch = _to_device(batch, dev)
    names = [n for n, _ in model.named_parameters()]

    def grad_of(part):
        bind_params_(model, params)
        loss, metrics = T.loss_fn(model, part, policy=policy)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    if microbatches <= 1:
        loss, metrics, grads = grad_of(batch)
        return loss, metrics, reduce_replicated_grads(grads, layout)
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"a batch of {b} does not split into "
                         f"{microbatches} microbatches")
    size = b // microbatches
    loss_sum = torch.zeros((), device=dev)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for n, p in params.items()}
    for i in range(microbatches):
        loss, metrics, g = grad_of({k: v[i * size:(i + 1) * size]
                                    for k, v in batch.items()})
        loss_sum = loss_sum + loss
        for n in grads:
            grads[n] = grads[n] + g[n].float()
    grads = reduce_replicated_grads(grads, layout)
    return (loss_sum / microbatches, metrics,
            {n: g / microbatches for n, g in grads.items()})


def noise_key(seed: int, step: torch.Tensor) -> torch.Tensor:
    """The int8 compressor's key at the state's ``step`` tensor (before
    the update), on its device (int64, a new tensor), which a captured
    step reads inside its graph."""
    return step.to(torch.int64) + seed * 1_000_003


def _compress_kwargs(model: T.LMModel, tcfg: TrainConfig, layout,
                     seed: int, step: torch.Tensor) -> dict:
    """The compressor's layout (None on one device), the reference's
    stacks of the layers (``transformer.param_stacks``) and, for int8,
    its key."""
    key = (noise_key(seed, step) if tcfg.compression.kind == "int8"
           else None)
    return dict(layout=layout, key=key, stacks=T.param_stacks(model))


def make_train_step(model: T.LMModel, tcfg: TrainConfig,
                    policy: KernelPolicy = DEFAULT_POLICY, *, seed: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for
    ``model`` (its parameters made trainable), ``batch`` ``{tokens,
    labels [, frontend]}`` on any device (moved to the model's).  The
    int8 compressor's noise is keyed by ``seed`` and the state's step
    (:func:`noise_key`), so a replayed step draws the same noise.  Every
    family trains: the attention-MLP transformers, whisper's
    encoder-decoder, xLSTM and hymba, on one device or under a mesh (the
    rules in force here, set again around every call; see the module's
    docstring)."""
    trainable_(model)
    rules = current_rules()
    layout = state_layout(model, rules)

    def train_step(state: dict, batch: dict):
        params, opt = state["params"], state["opt"]
        with use_rules(rules):
            loss, metrics, grads = accumulate_grads(
                model, params, batch, tcfg.microbatches, policy, layout)
            if tcfg.compression.kind != "none":
                grads, err = compress(
                    grads, state["err"], tcfg.compression,
                    **_compress_kwargs(model, tcfg, layout, seed,
                                       opt["step"]))
            params, opt, opt_metrics = adamw.apply_updates(
                params, grads, opt, tcfg.optimizer, layout)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        new_state = {"params": params, "opt": opt}
        if tcfg.compression.kind != "none":
            new_state["err"] = err
        return new_state, metrics

    return train_step


def init_train_state(model: T.LMModel, tcfg: TrainConfig) -> dict:
    """The state of a model's current weights: its parameters (the same
    tensors, which neither form of the step writes: the captured step
    copies them in), zeroed moments and step, and the compressor's zeroed
    error when one is configured.  Under a mesh the rank's blocks, the
    moments ZeRO-1's (:func:`state_layout`)."""
    return _state_of({n: p.detach() for n, p in model.named_parameters()},
                     tcfg, state_layout(model))


def _state_of(params: dict, tcfg: TrainConfig,
              layout: Optional[StateLayout] = None) -> dict:
    state = {"params": params,
             "opt": adamw.init_state(params, tcfg.optimizer, layout)}
    if tcfg.compression.kind != "none":
        state["err"] = init_error(params)
    return state


def train_step_into(model: T.LMModel, state: dict, batch: dict,
                    tcfg: TrainConfig, metrics: dict, *,
                    policy: KernelPolicy = DEFAULT_POLICY,
                    layout: Optional[StateLayout] = None, seed: int = 0):
    """:func:`make_train_step`'s step on static buffers, the same bits
    (``model``'s parameters made trainable, ``trainable_``): the
    gradients of ``state``'s parameters (bound once more with
    :func:`bind_params_`; microbatches unrolled, fp32 sums) from
    ``torch.autograd.grad``; the compression error and AdamW's
    parameters, moments and step written into ``state``'s own tensors;
    each metric copied into the 0-d tensor of its name in ``metrics`` (a
    name it lacks gets a new one).  ``int8`` compression draws from
    :func:`noise_key` of ``seed`` and the state's step.  It reads and
    writes the same addresses at every call, what a CUDA graph of it
    needs.  Under ``layout`` (the rules in force) the sharded step,
    collectives included.  Returns ``(state, metrics)``."""
    params = state["params"]
    loss, m, grads = accumulate_grads(model, params, batch,
                                      tcfg.microbatches, policy, layout)
    if tcfg.compression.kind != "none":
        grads = compress_(grads, state["err"], tcfg.compression,
                          **_compress_kwargs(model, tcfg, layout, seed,
                                             state["opt"]["step"]))
    m = dict(m, **adamw.apply_updates_(params, grads, state["opt"],
                                       tcfg.optimizer, layout), loss=loss)
    for k, v in m.items():
        if k not in metrics:
            metrics[k] = torch.empty_like(v)
        metrics[k].copy_(v)
    return state, metrics


@dataclasses.dataclass
class CapturedTrainStep:
    """A train step captured as a CUDA graph, called as
    :func:`make_train_step`'s step: ``(state, batch) -> (state,
    metrics)``.  The state it returns is its own static :attr:`state`,
    which the next call updates in place; handed that state, a call only
    copies the batch in and replays, handed any other, it first copies
    that state in.  ``batch`` is ``{tokens, labels [, frontend]}`` of the
    captured shapes on any device.  The metrics are copies of the graph's
    scalars.  :attr:`step` is the host's copy of the state's step (read
    from the card only at a copy-in).  ``captured`` has the capture time
    and the launches the capture recorded."""
    captured: graphs.Captured
    state: dict
    batch: dict
    metrics: dict
    step: int = 0

    def __call__(self, state: dict, batch: dict):
        if set(batch) != set(self.batch):
            raise ValueError(f"a batch of {sorted(batch)} for a step "
                             f"captured with {sorted(self.batch)}")
        for k, buf in self.batch.items():
            if tuple(batch[k].shape) != tuple(buf.shape):
                raise ValueError(f"train step captured for {k} of shape "
                                 f"{tuple(buf.shape)}, got "
                                 f"{tuple(batch[k].shape)}")
        if state is not self.state:
            graphs.copy_tree_(self.state, state)
            self.step = int(state["opt"]["step"])
        for k, buf in self.batch.items():
            buf.copy_(batch[k])
        self.captured.replay()
        self.step += 1
        return self.state, {k: v.clone() for k, v in self.metrics.items()}


def capture_train_step(model: T.LMModel, tcfg: TrainConfig, batch: int,
                       seq_len: int, *, policy: KernelPolicy = DEFAULT_POLICY,
                       seed: int = 0) -> CapturedTrainStep:
    """Capture :func:`train_step_into` for batches of ``batch`` x
    ``seq_len`` tokens (and an encoder-decoder's frames, (batch, enc_seq,
    d) in the model's dtype, from a static buffer as the prefill's) on the
    model's device, which must be the card; raises on the CPU.  The step's
    static state starts as :func:`init_train_state` of the model's weights
    at the call, copied (the model's parameters are bound to it from then
    on), and the int8 compressor draws from :func:`noise_key` of
    ``seed`` and the static state's step, read inside the graph, as
    :func:`make_train_step`'s does.
    Bit-exact replays need deterministic algorithms on, as
    ``launch.train`` sets them.  Under a mesh (the rules in force, NCCL)
    the graph holds the sharded step, its collectives included (the
    compressors' too): the capture's warm-up runs each once before the
    recording, and ``batch`` is the global batch, of which each rank
    keeps its rows."""
    dev = model.embedding["table"].device
    if dev.type != "cuda":
        raise ValueError(f"a train step is captured on the card, not on "
                         f"{dev}")
    trainable_(model)
    cfg = model.cfg
    rules = current_rules()
    layout = state_layout(model, rules)
    weights = {n: p.detach() for n, p in model.named_parameters()}
    state = _state_of({n: w.clone() for n, w in weights.items()}, tcfg,
                      layout)
    bufs = {k: torch.zeros((batch, seq_len), dtype=torch.int32, device=dev)
            for k in ("tokens", "labels")}
    if cfg.encdec is not None:
        bufs["frontend"] = torch.zeros(
            (batch, cfg.encdec.enc_seq, cfg.d_model), dtype=cfg.torch_dtype,
            device=dev)
    metrics = {}

    def step():
        with torch.enable_grad(), use_rules(rules):
            return train_step_into(model, state, bufs, tcfg, metrics,
                                   policy=policy, layout=layout, seed=seed)
    captured = graphs.capture(step, dev)
    # the warm-up and the first replay stepped the static state: back to
    # init_train_state's, in place (a second state may not fit the card)
    graphs.copy_tree_(state["params"], weights)
    _zero_tree_({k: v for k, v in state.items() if k != "params"})
    return CapturedTrainStep(captured, state, bufs, metrics)


def _zero_tree_(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            _zero_tree_(v)
        else:
            v.zero_()


def step_for_device(model: T.LMModel, tcfg: TrainConfig, batch: int,
                    seq_len: int, *, seed: int = 0,
                    capture: Optional[bool] = None):
    """``(step, state)`` a launcher trains with: on the card the captured
    step (:func:`capture_train_step`) and its own static state, elsewhere
    (or with ``capture=False``: gloo's ranks on cards) :func:`make_train_
    step`'s step and :func:`init_train_state`."""
    if capture is None:
        capture = model.embedding["table"].device.type == "cuda"
    if capture:
        step = capture_train_step(model, tcfg, batch, seq_len, seed=seed)
        return step, step.state
    return (make_train_step(model, tcfg, seed=seed),
            init_train_state(model, tcfg))
