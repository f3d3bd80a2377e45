"""Gradient compression with error feedback (counterpart of
``repro/optim/compress.py``), for the cross-node data parallelism that a
later slice shards: the residual of the compression is added back into
the next step's gradient, so convergence is kept (Karimireddy et al.
2019).

* top-k sparsification: the k largest-|g| entries of each tensor; the
  error-feedback invariant ``compressed + new error == g + old error``
  holds exactly.
* int8 stochastic rounding: a per-tensor scale, unbiased.  Its noise comes
  from an explicit ``torch.Generator``, so its bits are not JAX's
  threefry's; what holds is its unbiasedness and the invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"            # none | topk | int8
    topk_frac: float = 0.01       # fraction of entries kept (topk)


def init_error(params: dict) -> dict:
    """A zeroed fp32 error of every parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _topk_tensor(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.topk(flat.abs(), k).indices
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    return (flat * mask).reshape(g.shape)


def _int8_tensor(g: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    noise = torch.rand(g.shape, generator=generator,
                       device=generator.device).to(g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


def _check(cfg: CompressionConfig, generator) -> None:
    if cfg.kind == "int8" and generator is None:
        raise ValueError("int8 compression draws its noise from a "
                         "generator; pass one")
    if cfg.kind not in ("topk", "int8"):
        raise ValueError(cfg.kind)


def _compressed(g: torch.Tensor, cfg: CompressionConfig,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if cfg.kind == "topk":
        return _topk_tensor(g, cfg.topk_frac)
    return _int8_tensor(g, generator)


def compress(grads: dict, error: dict, cfg: CompressionConfig,
             generator: Optional[torch.Generator] = None):
    """Returns (compressed grads, new error), both fp32.  ``int8`` draws its
    rounding noise from ``generator`` (required), tensor by tensor in the
    grads' order."""
    if cfg.kind == "none":
        return grads, error
    _check(cfg, generator)
    comp, new_err = {}, {}
    for name, g in grads.items():
        g = g.float() + error[name]
        comp[name] = c = _compressed(g, cfg, generator)
        new_err[name] = g - c
    return comp, new_err


def compress_(grads: dict, error: dict, cfg: CompressionConfig,
              generator: Optional[torch.Generator] = None) -> dict:
    """:func:`compress` with the new error written into ``error``'s own
    tensors (the same bits, the same draws); returns the compressed
    grads."""
    if cfg.kind == "none":
        return grads
    _check(cfg, generator)
    comp = {}
    for name, g in grads.items():
        g = g.float() + error[name]
        comp[name] = c = _compressed(g, cfg, generator)
        torch.sub(g, c, out=error[name])
    return comp
