"""The training step: loss -> grads -> (compress) -> AdamW.  Counterpart
of ``repro/train/train_step.py``, eager on one device (the captured step
is queued in ROADMAP.md).

The state is ``{"params": {name: tensor}, "opt": {"mu", "nu", "step"}[,
"err"]}``, the names the model's own (``LMModel.named_parameters``).  A
step is functional: it binds the state's parameters to the model (each
``nn.Parameter``'s data set to the state's tensor, no copy), runs
``loss_fn`` and its backward, and returns a new state of new tensors,
never writing into the old one, so a failed step leaves its input state
as it was.  Microbatch gradients accumulate in fp32 (reference :42-71).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import transformer as T
from repro_torch.models.layers import trainable_
from repro_torch.optim import adamw
from repro_torch.optim.compress import CompressionConfig, compress, init_error


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


def accumulate_grads(model: T.LMModel, params: dict, batch: dict,
                     microbatches: int = 1,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """(loss, metrics, grads) of ``loss_fn`` at ``params`` (bound to
    ``model``, whose parameters must require grad) over ``batch`` (moved
    to the model's device): with one microbatch the gradients in the
    parameters' dtypes; with more, each microbatch's added in fp32 and the
    sums (and the loss) divided by their number, the metrics the last
    microbatch's (the reference's scan)."""
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
        return grad_of(batch)
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
    return (loss_sum / microbatches, metrics,
            {n: g / microbatches for n, g in grads.items()})


def make_train_step(model: T.LMModel, tcfg: TrainConfig,
                    policy: KernelPolicy = DEFAULT_POLICY, *, seed: int = 0):
    """Returns ``train_step(state, batch[, generator]) -> (state,
    metrics)`` for ``model`` (its parameters made trainable), ``batch``
    ``{tokens, labels [, frontend]}`` on any device (moved to the model's).
    The int8 compressor draws its noise from ``generator``, by default one
    on the model's device seeded from ``seed`` and the state's step, so a
    replayed step draws the same noise.  Every family trains: the
    attention-MLP transformers, whisper's encoder-decoder, xLSTM and
    hymba."""
    trainable_(model)
    dev = model.embedding["table"].device

    def train_step(state: dict, batch: dict,
                   generator: Optional[torch.Generator] = None):
        params, opt = state["params"], state["opt"]
        loss, metrics, grads = accumulate_grads(
            model, params, batch, tcfg.microbatches, policy)
        if tcfg.compression.kind != "none":
            if tcfg.compression.kind == "int8" and generator is None:
                generator = torch.Generator(dev).manual_seed(
                    seed * 1_000_003 + int(opt["step"]))
            grads, err = compress(grads, state["err"], tcfg.compression,
                                  generator)
        params, opt, opt_metrics = adamw.apply_updates(params, grads, opt,
                                                       tcfg.optimizer)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        new_state = {"params": params, "opt": opt}
        if tcfg.compression.kind != "none":
            new_state["err"] = err
        return new_state, metrics

    return train_step


def init_train_state(model: T.LMModel, tcfg: TrainConfig) -> dict:
    """The state of a model's current weights: its parameters (the same
    tensors, which a step never writes), zeroed moments and step, and the
    compressor's zeroed error when one is configured."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    state = {"params": params,
             "opt": adamw.init_state(params, tcfg.optimizer)}
    if tcfg.compression.kind != "none":
        state["err"] = init_error(params)
    return state
