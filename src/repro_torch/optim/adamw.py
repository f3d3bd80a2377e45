"""AdamW from scratch, number for number the reference's
(``repro/optim/adamw.py``); ``torch.optim.AdamW`` orders its update
differently, so it is not used.

* fp32 moments whatever the parameters' dtype (or bf16, ``moments_dtype``).
* Decoupled weight decay with a name-based mask (no decay on norms and
  biases): a parameter's name is its path in the model joined with dots,
  whose last part is the reference's last key.
* Global-norm clipping, linear warmup and a cosine decay.

Parameters, gradients and moments are ``{name: tensor}`` dicts of the same
keys.  :func:`apply_updates` is functional: it returns new tensors and
leaves its inputs as they were; :func:`apply_updates_` writes the same
bits into the state's own tensors (the captured train step's donation).
The step counter and the learning rate stay on the parameters' device, so
a step needs no host sync.

Under a mesh (``layout``, a ``sharding.rules.StateLayout``) each tensor is
the rank's block of its parameter: :func:`global_norm` sums each block's
squares over the axes it is split on (a block held alike by several
ranks counted once), and the moments are ZeRO-1's: where their spec cuts
a parameter further over "data" (``zero1_specs``: a norm's scale), each
rank updates its block of the parameter with its block of the gradient
and the updated blocks are gathered over "data".  The update is
elementwise, so it gives the unsharded step's bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sharding import collectives


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment storage dtype: float32, or bfloat16 to halve the optimizer's
    # memory (a coarse 8-bit-Adam-style state compression)
    moments_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), fp32: linear
    warmup over ``warmup_steps``, then a cosine from ``lr`` down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


#: Last name parts that take no weight decay.
NO_DECAY = ("scale", "bias", "b", "dt_bias", "d_skip", "m")


def decays(name: str) -> bool:
    """Whether the parameter ``name`` (dotted path) takes weight decay."""
    return name.rsplit(".", 1)[-1] not in NO_DECAY


def _moments_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if cfg is not None
            and cfg.moments_dtype == "bfloat16" else torch.float32)


def init_state(params: dict, cfg: "AdamWConfig | None" = None,
               layout=None) -> dict:
    """Zeroed moments of every parameter and a step counter of 0 (int32),
    on the parameters' device; under ``layout`` each moment is the rank's
    ZeRO-1 block."""
    dt = _moments_dtype(cfg)
    dev = next(iter(params.values())).device

    def shape(k, p):
        return (p if layout is None else layout.zero1_block(k, p)).shape
    return {"mu": {k: torch.zeros(shape(k, p), dtype=dt, device=p.device)
                   for k, p in params.items()},
            "nu": {k: torch.zeros(shape(k, p), dtype=dt, device=p.device)
                   for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict, layout=None) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares, in fp32.  Under
    ``layout`` the tensors are the rank's blocks: the squares of the
    blocks split over the same axes are summed, each sum reduced over
    those axes (one ``all_reduce`` an axis), and the sums added."""
    if layout is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.values()))
    sums = {}
    for name, g in tree.items():
        sq = torch.sum(torch.square(g.float()))
        key = layout.axes(name)
        sums[key] = sq if key not in sums else sums[key] + sq
    keys = sorted(sums, key=sorted)
    vals = [sums[k] for k in keys]
    mesh = layout.mesh
    for axis in mesh.axis_names:
        idx = [i for i, k in enumerate(keys) if axis in k]
        if not idx or mesh.shape[axis] == 1:
            continue
        red = collectives.all_reduce(torch.stack([vals[i] for i in idx]),
                                     mesh.group(axis))
        for j, i in enumerate(idx):
            vals[i] = red[j]
    return torch.sqrt(sum(vals))


def _prologue(grads: dict, step: torch.Tensor, cfg: AdamWConfig, layout):
    """The step's scalars: (lr, grad norm, clip scale, bias corrections)."""
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    return (lr, gnorm, scale, 1 - cfg.b1 ** step.float(),
            1 - cfg.b2 ** step.float())


def _update(name: str, p, g, mu, nu, scalars, cfg: AdamWConfig):
    """One parameter's (new p, mu, nu), all fp32."""
    lr, _, scale, bc1, bc2 = scalars
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    mu = b1 * mu.float() + (1 - b1) * g
    nu = b2 * nu.float() + (1 - b2) * torch.square(g)
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    if cfg.weight_decay and decays(name):
        upd = upd + cfg.weight_decay * p.float()
    return p.float() - lr * upd, mu, nu


def _blocks(name: str, p, g, layout):
    """(parameter, gradient) as this rank updates them: the ZeRO-1 blocks
    under ``layout``, else whole."""
    if layout is None:
        return p, g
    return layout.zero1_block(name, p), layout.zero1_block(name, g)


def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig, layout=None):
    """Returns (new params, new state, metrics {grad_norm, lr,
    param_norm}); each new parameter in its own dtype, each moment in
    ``moments_dtype``; under ``layout`` the rank's blocks, the moments
    ZeRO-1's."""
    step = state["step"] + 1
    scalars = _prologue(grads, step, cfg, layout)
    new_p, new_mu, new_nu = {}, {}, {}
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        pb, gb = _blocks(name, p, grads[name], layout)
        new_p[name], new_mu[name], new_nu[name] = (
            t.to(dt) for t, dt in zip(
                _update(name, pb, gb, mu, nu, scalars, cfg),
                (p.dtype, mu.dtype, nu.dtype)))
        if layout is not None:
            new_p[name] = layout.zero1_gather(name, new_p[name])
    metrics = {"grad_norm": scalars[1], "lr": scalars[0],
               "param_norm": global_norm(new_p, layout)}
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, metrics


def apply_updates_(params: dict, grads: dict, state: dict,
                   cfg: AdamWConfig, layout=None) -> dict:
    """:func:`apply_updates` in place, the same bits: the new parameters,
    moments and step are written into ``params``' and ``state``'s own
    tensors (the same expressions, each result copied into its buffer, so
    no product is fused into another rounding).  Returns the metrics."""
    step = state["step"]
    step.add_(1)
    scalars = _prologue(grads, step, cfg, layout)
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        pb, gb = _blocks(name, p, grads[name], layout)
        new_p, new_mu, new_nu = _update(name, pb, gb, mu, nu, scalars, cfg)
        if layout is not None and pb is not p:
            new_p = layout.zero1_gather(name, new_p.to(p.dtype))
        for buf, t in zip((p, mu, nu), (new_p, new_mu, new_nu)):
            buf.copy_(t)
        # the fp32 temporaries go before the next parameter's are made
        del new_p, new_mu, new_nu
    return {"grad_norm": scalars[1], "lr": scalars[0],
            "param_norm": global_norm(params, layout)}
