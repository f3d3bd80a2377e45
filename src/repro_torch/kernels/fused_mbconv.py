"""Fused-MBConv block (dense Hf x Wf conv -> act -> PW-project): the CUDA
kernel's wrapper, its plain version and its launch counter.

Replaces ``repro/kernels/fused_mbconv.py::fused_mbconv_pallas`` (def :193,
body ``_fused_mb_kernel``, call :314).  The kernel is
``csrc/fused_mbconv.cu``.

Bound on the H100: operations.  The dense conv does ``2 * Hf*Wf*Ci * C``
operations per output pixel and the projection ``2 * C * Co`` more,
against a few bytes of input and output per pixel.  The kernel has
``separable_fused``'s shape with the conv as an implicit GEMM: a CTA owns
``slab_h`` output rows (full width wherever its window fits) of one image
and a slice of the conv channels, stages its padded input window once, computes the slice's conv
output chunk by chunk into shared memory (the next chunk's filter copy in
flight) and projects it; a thread-block cluster of up to 8 CTAs splits C
and sums the partial projections in rank order
(``blocking.plan_fused_mb``).  fp32 and fp16 multiply in exact fp32 on the
CUDA cores (register tiles); bf16 runs both products on the tensor cores,
the project with the fp32 conv output split into a bf16 hi and lo pair, so
the output still rounds once.  The conv output never reaches device
memory.

Geometry: VALID on ``x`` zero-padded by ``pad`` (default none); the kernel
pads as it reads.  Zero padding is exact for a dense conv whatever its
bias, which is added after the sum.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.spans import marks_span
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process.
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 23
             + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 10


def fused_mbconv_plain(
    x, mb_f, pw_w, mb_bias=None, pw_bias=None, residual=None, *,
    stride=1, mb_activation="relu6", activation=None, out_dtype=None,
    pad=None,
) -> torch.Tensor:
    """The plain version: ``ref.fused_mbconv_ref`` on VALID geometry (after
    the zero ``pad``, if given), the conv output fp32 into the projection,
    one store at ``out_dtype``."""
    y = ref.fused_mbconv_ref(
        ref.zero_pad(x, pad).float(), mb_f, pw_w, mb_bias, pw_bias, residual,
        stride=stride, padding="valid", mb_activation=mb_activation,
        activation=activation)
    return y.to(out_dtype or x.dtype)


def smem_bytes(ci: int, c_slice: int, cb: int, panel: int, slab_h: int,
               tile_w: int, hf: int, wf: int, stride: int,
               dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory one CTA needs (the
    planner's ``blocking.fused_mb_smem_bytes`` must agree with it)."""
    lib = _build.library("fused_mbconv")
    fn = lib.fused_mbconv_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(ci, c_slice, cb, panel, slab_h, tile_w, hf, wf, stride,
                  _build.DTYPE_CODES[dtype]))


@marks_span("fused_mbconv")
def fused_mbconv(
    x: torch.Tensor,
    mb_f: torch.Tensor,
    pw_w: torch.Tensor,
    mb_bias: Optional[torch.Tensor] = None,
    pw_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    mb_activation: Optional[str] = "relu6",
    activation: Optional[str] = None,
    pad: Optional[tuple] = None,
    slab_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    block_c: Optional[int] = None,
    block_co: Optional[int] = None,
    cluster: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, Hi, Wi, Ci); mb_f (Hf, Wf, Ci, C); pw_w (C, Co); mb_bias (C,);
    pw_bias (Co,); residual (B, Ho, Wo, Co) -> (B, Ho, Wo, Co), VALID
    geometry of x zero-padded by ``pad`` = (top, left, bottom, right)
    (default none; the kernel pads as it reads).

    A CUDA tensor launches the kernel at the given blocks (``slab_h``
    output rows by ``tile_w`` columns a CTA, a cluster of ``cluster`` CTAs splitting C, chunks of
    ``block_c`` channels, Co panels of ``block_co``; missing entries come
    from ``blocking.plan_fused_mb``); a CPU tensor takes
    :func:`fused_mbconv_plain`.
    """
    global launches
    b, hi, wi, ci = x.shape
    hf, wf, ci_f, c = mb_f.shape
    cw, co = pw_w.shape
    if ci_f != ci or cw != c:
        raise ValueError(f"fused_mbconv shapes x {tuple(x.shape)}, mb_f "
                         f"{tuple(mb_f.shape)}, pw_w {tuple(pw_w.shape)}")
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
        return fused_mbconv_plain(
            x, mb_f, pw_w, mb_bias, pw_bias, residual, stride=stride,
            mb_activation=mb_activation, activation=activation,
            out_dtype=odt, pad=pad)
    operands = (x, mb_f, mb_bias, pw_w, pw_bias, residual)
    dev = _build.require_cuda("fused_mbconv", *operands)
    for t in operands:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"fused_mbconv: x is {x.dtype} but got a "
                             f"{t.dtype} operand")
    if None in (slab_h, tile_w, block_c, block_co, cluster):
        plan = blocking.plan_fused_mb(ho, wo, ci, c, co, stride=stride,
                                      hf=hf, wf=wf, dtype=x.dtype, batch=b)
        if plan is None:
            raise ValueError(f"no fused-MBConv plan fits one CTA for "
                             f"{(hi, wi, ci, c, co)}")
        slab_h = slab_h or plan.slab_h
        tile_w = tile_w or plan.tile_w
        block_c = block_c or plan.block_c
        block_co = block_co or plan.block_co
        cluster = cluster or plan.cluster
    cs = blocking.separable_slice(c, cluster)
    cluster = -(-c // cs)
    slab_h, tile_w = min(slab_h, ho), min(tile_w, wo)
    block_c = min(block_c, cs)
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, co), dtype=odt, device=dev)
    lib = _build.library("fused_mbconv")
    fn = lib.fused_mbconv_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "fused_mbconv", fn(
        *(_build.ptr(t) for t in operands), _build.ptr(out),
        b, hi, wi, top, left, ci, c, co, ho, wo, hf, wf, stride, slab_h,
        tile_w, block_c, cs, block_co, cluster, activation_code(mb_activation),
        activation_code(activation), cin, cout, _build.stream(dev)))
    launches += 1
    return out
