"""Public op wrappers with SAME padding and backend resolution.

Counterpart of ``repro/kernels/ops.py``.  Each op has two paths:

* ``impl="torch"`` — the plain version (``ref.py``), on any device;
* ``impl="cuda"``  — the hand-written kernel; CUDA tensors only.

``impl="auto"`` follows the tensor: CUDA tensors take the kernels, CPU
tensors the plain versions.  A kernel that fails raises; nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import blocking, ref
from repro_torch.kernels.dwconv1d import DwConv1dFn
from repro_torch.kernels.dwconv2d import dwconv2d as dwconv2d_kernel
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.policy import resolve_impl
from repro_torch.kernels.pwconv import pwconv as pwconv_kernel
from repro_torch.kernels.separable_fused import (
    separable_fused as separable_fused_kernel)

#: Explicit SAME padding, odd row/column at the bottom/right.
pad_same = ref.pad_same


def dwconv2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
             padding: str = "same", impl: str = "auto",
             block_c: Optional[int] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Depthwise 2-D conv, NHWC. x (B,Hi,Wi,C), f (Hf,Wf,C).  ``block_c``
    runs the kernel at a planned channel group (the kernel pads as it
    reads); ``out_dtype`` is the store type (``None``: ``x.dtype``)."""
    if resolve_impl(impl, x.device) == "torch":
        return ref.dwconv2d_ref(x, f, stride=stride,
                                padding=padding).to(out_dtype or x.dtype)
    pad = ref.pads(x.shape[1], x.shape[2], f.shape[0], f.shape[1], stride,
                   padding)
    return dwconv2d_kernel(x, f, stride=stride, pad=pad, block_c=block_c,
                           out_dtype=out_dtype)


def dwconv1d_causal(x: torch.Tensor, f: torch.Tensor, *,
                    impl: str = "auto") -> torch.Tensor:
    """Causal depthwise 1-D conv. x (B, L, D), f (K, D) in x's dtype:
    ``kernels/dwconv1d.py::DwConv1dFn``, the kernel (one launch) and,
    under autograd, the backward's kernels on the card."""
    return DwConv1dFn.apply(x, f, impl)


def pwconv(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: Optional[str] = None, impl: str = "auto",
           block_g: Optional[int] = None, block_co: Optional[int] = None,
           block_ci: Optional[int] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Pointwise conv / GEMM over the last axis. x (..., Ci), w (Ci, Co)."""
    if resolve_impl(impl, x.device) == "torch":
        return ref.pwconv_ref(x, w, bias=bias, activation=activation).to(
            out_dtype or x.dtype)
    lead = x.shape[:-1]
    y = pwconv_kernel(x.reshape(-1, x.shape[-1]), w, bias,
                      activation=activation, block_g=block_g,
                      block_co=block_co, block_ci=block_ci,
                      out_dtype=out_dtype)
    return y.reshape(*lead, w.shape[1])


def separable_fused(
    x: torch.Tensor,
    dw_f: torch.Tensor,
    pw_w: torch.Tensor,
    dw_bias: Optional[torch.Tensor] = None,
    pw_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    expand_w: Optional[torch.Tensor] = None,
    expand_activation: Optional[str] = "relu6",
    stride: int = 1,
    padding: str = "same",
    dw_activation: Optional[str] = "relu6",
    activation: Optional[str] = None,
    impl: str = "auto",
    smem_budget: int = blocking.DEFAULT_SMEM_BUDGET,
) -> torch.Tensor:
    """Fused [PW-expand ->] DW -> act -> PW block in one kernel pass.

    When no tile fits ``smem_budget`` the op degrades as the chain planner
    does (``repro/kernels/ops.py:159-202``): 3-stage -> standalone expand
    GEMM + 2-stage -> unfused composition.  The degraded paths round the
    intermediates to the activation dtype between kernels (the fused paths
    keep them fp32).
    """
    if resolve_impl(impl, x.device) == "torch":
        return ref.separable_fused_ref(
            x, dw_f, pw_w, dw_bias, pw_bias, residual,
            expand_w=expand_w, expand_activation=expand_activation,
            stride=stride, padding=padding,
            dw_activation=dw_activation, activation=activation)
    hf, wf = dw_f.shape[0], dw_f.shape[1]
    b, hi, wi = x.shape[:3]
    pad = (ref.same_pads(hi, wi, hf, wf, stride)
           if padding.lower() == "same" else (0, 0, 0, 0))
    ho = (hi + pad[0] + pad[2] - hf) // stride + 1
    wo = (wi + pad[1] + pad[3] - wf) // stride + 1
    co = pw_w.shape[-1]

    def blocks(p):
        return dict(slab_h=p.slab_h, block_c=p.block_c, block_co=p.block_co,
                    cluster=p.cluster)
    if expand_w is not None:
        plan3 = blocking.plan_separable3(
            ho, wo, expand_w.shape[0], expand_w.shape[1], co, stride=stride,
            hf=hf, wf=wf, dtype=x.dtype, smem_budget=smem_budget, batch=b,
            hi=hi, wi=wi)
        if plan3 is not None:
            return separable_fused_kernel(
                x, dw_f, pw_w, dw_bias, pw_bias, residual,
                expand_w=expand_w, expand_activation=expand_activation,
                stride=stride, dw_activation=dw_activation,
                activation=activation, pad=pad, **blocks(plan3))
        x = pwconv(x, expand_w, activation=expand_activation, impl="cuda")
    plan = blocking.plan_separable(
        ho, wo, x.shape[-1], co, stride=stride, hf=hf, wf=wf, dtype=x.dtype,
        smem_budget=smem_budget, batch=b, hi=hi, wi=wi)
    if plan is None:
        y = dwconv2d_kernel(x, dw_f, stride=stride, pad=pad)
        y = apply_epilogue(y, dw_bias, dw_activation).to(x.dtype)
        out = pwconv(y, pw_w, pw_bias, activation=activation, impl="cuda")
        return out if residual is None else out + residual
    return separable_fused_kernel(
        x, dw_f, pw_w, dw_bias, pw_bias, residual,
        stride=stride, dw_activation=dw_activation, activation=activation,
        pad=pad, **blocks(plan))
