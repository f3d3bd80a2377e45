"""Fused depthwise-separable block ([PW-expand ->] DW -> PW): the CUDA
kernel's wrapper, its plain version and its launch counters.

Replaces ``repro/kernels/separable_fused.py::separable_fused_pallas`` (def
:254, body ``_fused_kernel`` :167) in both its modes: ``fused2`` (DW -> PW)
and ``fused3`` (bias-free PW-expand computed on the fly -> DW -> PW).  The
kernel is ``csrc/separable_fused.cuh``, compiled once per stream dtype by
``csrc/separable_fused{,_bf16,_f16}.cu``.

Bound on the H100: operations.  The block moves only its input, weights
and output, and does C*Co (+ Ci*C per input pixel with expand, + C*k*k)
multiply-adds per output pixel.  The design computes each of them once: a
CTA owns ``slab_h`` full-width output rows of one image (the whole image
at the 14x14 and 7x7 stages) and a slice of the DW channels; a
thread-block cluster of up to 8 CTAs splits C, each CTA projecting its
slice for all of Co, and the cluster sums the partial output tiles through
distributed shared memory in rank order.  ``blocking.plan_separable_fused``
sizes the cluster and the slabs so a batch-8 launch puts at least 64 CTAs
on the card.  fp32 and fp16 multiply on the CUDA cores in exact fp32
(register-tiled); bf16 runs both products on the tensor cores, the project
with the fp32 DW tile split into a bf16 hi and lo pair (two MMAs), so the
output still rounds once.  Neither the expanded tensor nor the DW output
reaches device memory.

Geometry: VALID on ``x`` zero-padded by ``pad`` (default none); the kernel
pads as it reads and never expands the padding, which is sound because
the expand is bias-free and every activation maps 0 to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.spans import marks_span
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process, per mode.
launches = {"fused2": 0, "fused3": 0}

#: The kernel's library for each stream dtype (``csrc/separable_fused*.cu``:
#: one source per stream type, built in parallel).
LIBRARIES = {torch.float32: "separable_fused",
             torch.bfloat16: "separable_fused_bf16",
             torch.float16: "separable_fused_f16"}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 23
             + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 14


def separable_fused_plain(
    x, dw_f, pw_w, dw_bias=None, pw_bias=None, residual=None, *,
    expand_w=None, expand_activation="relu6", stride=1,
    dw_activation="relu6", activation=None, out_dtype=None, pad=None,
) -> torch.Tensor:
    """The plain version: ``ref.separable_fused_ref`` on VALID geometry
    (after the zero ``pad``, if given), fp32 intermediates, one store at
    ``out_dtype``."""
    y = ref.separable_fused_ref(
        ref.zero_pad(x, pad).float(), dw_f, pw_w, dw_bias, pw_bias, residual,
        expand_w=expand_w, expand_activation=expand_activation,
        stride=stride, padding="valid", dw_activation=dw_activation,
        activation=activation)
    return y.to(out_dtype or x.dtype)


def smem_bytes(ci: int, c_slice: int, cb: int, panel: int, cluster: int,
               slab_h: int, wo: int, hi: int, wi: int, hf: int, wf: int,
               stride: int, expand: bool, dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory one CTA needs (the
    planner's ``blocking.separable_smem_bytes`` must agree with it)."""
    lib = _build.library("separable_fused")
    fn = lib.separable_fused_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(ci, c_slice, cb, panel, cluster, slab_h, wo, hi, wi, hf,
                  wf, stride, int(expand), _build.DTYPE_CODES[dtype]))


@marks_span("separable_fused")
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
    dw_activation: Optional[str] = "relu6",
    activation: Optional[str] = None,
    pad: Optional[tuple] = None,
    slab_h: Optional[int] = None,
    block_c: Optional[int] = None,
    block_co: Optional[int] = None,
    cluster: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, Hi, Wi, C) [or (B, Hi, Wi, Ci) with ``expand_w`` (Ci, C)];
    dw_f (Hf, Wf, C); pw_w (C, Co); dw_bias (C,); pw_bias (Co,); residual
    (B, Ho, Wo, Co) -> (B, Ho, Wo, Co), VALID geometry of x zero-padded by
    ``pad`` = (top, left, bottom, right) (default none; the kernel pads as
    it reads, and never expands the padding).

    A CUDA tensor launches the kernel at the given blocks (``slab_h``
    output rows a CTA, a cluster of ``cluster`` CTAs splitting C, chunks of
    ``block_c`` channels, Co panels of ``block_co``; missing entries come
    from ``blocking.plan_separable``/``plan_separable3``); a CPU tensor
    takes :func:`separable_fused_plain`.
    """
    b, hi, wi, c_in = x.shape
    hf, wf, c = dw_f.shape
    cw, co = pw_w.shape
    if expand_w is not None:
        if expand_w.shape != (c_in, c):
            raise ValueError(f"expand_w {tuple(expand_w.shape)} for input "
                             f"{tuple(x.shape)} and filter {tuple(dw_f.shape)}")
    elif c_in != c:
        raise ValueError(f"x {tuple(x.shape)} vs dw_f {tuple(dw_f.shape)}")
    if cw != c:
        raise ValueError(f"pw_w {tuple(pw_w.shape)} vs C={c}")
    top, left, bottom, right = pad or (0, 0, 0, 0)
    if min(top, left, bottom, right) < 0:
        raise ValueError(f"negative pad {pad}")
    ho = (hi + top + bottom - hf) // stride + 1
    wo = (wi + left + right - wf) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError("input smaller than filter")
    if residual is not None and residual.shape != (b, ho, wo, co):
        raise ValueError(f"residual {tuple(residual.shape)} vs output "
                         f"{(b, ho, wo, co)}")
    odt = out_dtype or x.dtype
    if x.device.type == "cpu":
        return separable_fused_plain(
            x, dw_f, pw_w, dw_bias, pw_bias, residual, expand_w=expand_w,
            expand_activation=expand_activation, stride=stride,
            dw_activation=dw_activation, activation=activation,
            out_dtype=odt, pad=pad)
    operands = (x, expand_w, dw_f, dw_bias, pw_w, pw_bias, residual)
    dev = _build.require_cuda("separable_fused", *operands)
    for t in operands:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"separable_fused: x is {x.dtype} but got a "
                             f"{t.dtype} operand")
    if None in (slab_h, block_c, block_co, cluster):
        ci = c_in if expand_w is not None else 0
        plan = blocking.plan_separable_fused(
            ho, wo, ci, c, co, stride=stride, hf=hf, wf=wf, dtype=x.dtype,
            batch=b, hi=hi, wi=wi)
        if plan is None:
            raise ValueError(f"no fused plan fits one CTA for "
                             f"{(hi, wi, c_in, c, co)}")
        slab_h = slab_h or plan.slab_h
        block_c = block_c or plan.block_c
        block_co = block_co or plan.block_co
        cluster = cluster or plan.cluster
    cs = blocking.separable_slice(c, cluster)
    cluster = -(-c // cs)
    slab_h, block_c = min(slab_h, ho), min(block_c, cs)
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, co), dtype=odt, device=dev)
    mode = "fused3" if expand_w is not None else "fused2"
    name = LIBRARIES[x.dtype]
    lib = _build.library(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, name, fn(
        *(_build.ptr(t) for t in operands), _build.ptr(out),
        b, hi, wi, top, left, c_in if expand_w is not None else 0, c, co,
        ho, wo, hf, wf, stride, slab_h, block_c, cs, block_co, cluster,
        activation_code(expand_activation), activation_code(dw_activation),
        activation_code(activation), cin, cout, _build.stream(dev)))
    launches[mode] += 1
    return out
