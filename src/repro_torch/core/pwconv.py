"""PWConv as a framework op: every dense projection of the LM stack
(``models/layers.py::linear``) routes through :func:`pointwise`, so the
paper's output-stationary GEMM kernel (``csrc/pwconv.cu``) runs every
Linear on the card.  Counterpart of ``repro/core/pwconv.py``.

Training differentiates through :class:`PointwiseFn`: its forward is the
same op (the kernel on a CUDA tensor), its backward the reference's
``_mm_bwd`` (``repro/kernels/ref.py:115-138``) composed with the
epilogue's.  ``dx = g @ w.T`` and ``dw = x.T @ g`` are plain products
accumulated in fp32 and cast to x's and w's dtypes, ``db = sum(g)`` in
fp32 cast to the bias's; as in the reference they run outside any kernel.
With an activation the backward needs the pre-activation ``z = x @ w +
b``: it is recomputed by a second launch of the kernel (no activation, an
fp32 store), not kept from the forward, as the reference's remat
recomputes it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.policy import (  # noqa: F401  (re-export)
    DEFAULT_POLICY,
    KernelPolicy,
    resolve_impl,
)


def _op(x, w, bias, activation, policy, out_dtype=None):
    return ops.pwconv(x, w, bias, activation=activation, impl=policy.impl,
                      block_g=policy.block_g, block_co=policy.block_co,
                      block_ci=policy.block_ci, out_dtype=out_dtype)


class PointwiseFn(torch.autograd.Function):
    """:func:`pointwise` with the reference's gradients; ``x`` (..., Ci),
    ``w`` (Ci, Co), ``bias`` (Co,) or None."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, policy, out_dtype=None):
        ctx.activation, ctx.policy = activation, policy
        ctx.save_for_backward(x, w, bias)
        return _op(x, w, bias, activation, policy, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gz = g.float()
        if ctx.activation is not None:
            # the pre-activation, recomputed on the kernel; the epilogue's
            # derivative is autograd's of the plain epilogue at it
            z = _op(x, w, bias, None, ctx.policy, out_dtype=torch.float32)
            with torch.enable_grad():
                z = z.detach().requires_grad_(True)
                y = apply_epilogue(z, None, ctx.activation)
                gz, = torch.autograd.grad(y, z, gz)
        x2 = x.reshape(-1, x.shape[-1])
        g2 = gz.reshape(-1, gz.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gz, w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2.float().T, g2).to(w.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            db = g2.sum(dim=0).to(bias.dtype)
        return dx, dw, db, None, None, None


def pointwise(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None,
              policy: KernelPolicy = DEFAULT_POLICY,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Pointwise conv (1x1) / GEMM over the trailing axis, fp32 accumulate,
    stored in ``out_dtype`` (default x's; a row-parallel Linear's partial
    sums are stored in fp32).  x (..., Ci) must be contiguous on the card.
    Under autograd (grad mode on and an operand requiring grad) it is
    :class:`PointwiseFn`; else the op itself, which serving
    (``inference_mode``) launches exactly once."""
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (bias is not None and bias.requires_grad)):
        return PointwiseFn.apply(x, w, bias, activation, policy, out_dtype)
    return _op(x, w, bias, activation, policy, out_dtype=out_dtype)
