"""Bias + activation epilogue shared by the plain versions and the lowering.

Counterpart of ``repro/kernels/epilogue.py``.  The CUDA kernels apply the
same activations in their own epilogues (``csrc/common.cuh``); the order of
:data:`ACTIVATIONS` is the integer code they take.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: Activations every op accepts.  All map 0 -> 0, which the fused kernel's
#: zero SAME padding relies on (a bias-free expansion of a zero pixel stays
#: zero through every one of them).
ACTIVATIONS = ("relu", "relu6", "gelu", "silu")


def activation_code(activation: Optional[str]) -> int:
    """0 for none, else 1 + the index in :data:`ACTIVATIONS` (the kernels'
    ``act`` argument)."""
    if activation is None:
        return 0
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    return 1 + ACTIVATIONS.index(activation)


def apply_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None) -> torch.Tensor:
    """``y + bias`` then ``activation(y)``; bias broadcast in ``y.dtype``.

    ``"gelu"`` is the tanh approximation, as ``jax.nn.gelu`` defaults to.
    """
    if bias is not None:
        y = y + bias.to(y.dtype)
    if activation is None:
        return y
    if activation == "relu":
        return torch.clamp_min(y, 0.0)
    if activation == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return F.silu(y)
    raise ValueError(f"unknown activation {activation!r}")
