"""Dense SwiGLU MLP — three PWConv (paper-op) projections.  Counterpart of
``repro/models/mlp.py``.  The gate's SiLU is the ``pwconv`` kernel's
epilogue, so a call is three ``pwconv`` launches and one multiply.  Under
a mesh ``w_gate`` and ``w_up`` are column-parallel (each rank's block of
``d_ff`` columns, their shared input entering the split region once:
``layers.enter_model_axis``) and ``w_down`` row-parallel (the same
block of rows, its partial sums summed over the model axis: one
all_reduce in a forward, one for the input's sum in a backward); under FSDP
each weight's dimension split over "data" is gathered at its use
(``layers.fsdp_gather``).  Under sequence parallelism its input is the
normed residual gathered whole (``layers.gather_seq``, already in the
split region, which ``enter_model_axis`` knows) and ``w_down``'s partial sums are reduce-scattered to the
rank's block of the sequence (``layers.row_linear``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models.layers import (enter_model_axis, init_linear,
                                       linear, row_linear)


class MLP(nn.Module):
    """``{"w_gate", "w_up", "w_down"}``, each a Linear ``{"w"}``."""

    def __init__(self, d_model: int, d_ff: int, *,
                 generator: torch.Generator, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.d_ff = d_ff
        lin = dict(dtype=dtype, device=device)
        self.w_gate = init_linear(generator, d_model, d_ff, **lin)
        self.w_up = init_linear(generator, d_model, d_ff, **lin)
        self.w_down = init_linear(generator, d_ff, d_model, **lin)

    def forward(self, x: torch.Tensor, *,
                policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
        xs = enter_model_axis(
            x, split=self.w_gate["w"].shape[1] != self.d_ff)
        g = linear(self.w_gate, xs, activation="silu", policy=policy)
        u = linear(self.w_up, xs, policy=policy)
        return row_linear(self.w_down, g * u, self.d_ff, d_out=x.shape[-1],
                          policy=policy)
