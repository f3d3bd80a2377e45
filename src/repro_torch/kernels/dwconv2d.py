"""Depthwise 2-D convolution: the CUDA kernel's wrapper, its plain version
and its launch counter.

Replaces ``repro/kernels/dwconv2d.py::dwconv2d_pallas`` (def :87, body
``_dw2d_kernel`` :64).  The kernel is ``csrc/dwconv2d.cu``.

Bound on the H100: bytes.  A 3x3 depthwise conv does 9 multiply-adds per
input element, 2-4.5 operations per byte in fp32 against the card's ~20
fp32 operations per byte of device memory.  The kernel therefore moves each
input and output once through device memory in 16-byte copies: a CTA
stages its padded input tile (``blocking.plan_dwconv2d``) in shared memory,
and each thread slides a register window along a run of four outputs of a
row for one 16-byte channel vector, the row's taps in registers (compiled
for 3x3, 5x5 and 7x7 at strides 1 and 2; any other filter reads its taps
from shared memory), accumulating in fp32 and storing once at
``out_dtype``.

Geometry: VALID on ``x`` zero-padded by ``pad`` (default none); the kernel
pads as it reads, so the lowering makes no padded copy.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.spans import marks_span

#: Kernel launches so far in this process (``chip_smoke.py`` zeroes it
#: before it drives the main path and reads it after).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 17
             + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 7


def dwconv2d_plain(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
                   out_dtype: Optional[torch.dtype] = None,
                   pad: Optional[tuple] = None) -> torch.Tensor:
    """The plain version: fp32 ``F.conv2d(groups=C)`` on VALID geometry
    (after the zero ``pad``, if given)."""
    y = ref.dwconv2d_ref(ref.zero_pad(x, pad).float(), f, stride=stride,
                         padding="valid")
    return y.to(out_dtype or x.dtype)


def smem_bytes(tile_h: int, tile_w: int, cg: int, hf: int, wf: int,
               stride: int, dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory one CTA needs (the
    planner's ``blocking.dwconv2d_smem_bytes`` must agree with it)."""
    lib = _build.library("dwconv2d")
    fn = lib.dwconv2d_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(tile_h, tile_w, cg, hf, wf, stride,
                  _build.DTYPE_CODES[dtype]))


@marks_span("dwconv2d")
def dwconv2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
             pad: Optional[tuple] = None,
             block_c: Optional[int] = None, slab_h: Optional[int] = None,
             tile_w: Optional[int] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (B, Hi, Wi, C), f (Hf, Wf, C) -> (B, Ho, Wo, C), VALID geometry of
    x zero-padded by ``pad`` = (top, left, bottom, right) (default none).

    A CUDA tensor launches the kernel at the given tile (``slab_h`` x
    ``tile_w`` outputs by ``block_c`` channels; missing entries come from
    ``blocking.plan_dwconv2d``); a CPU tensor takes
    :func:`dwconv2d_plain`.  Any filter size runs.  ``out_dtype`` is the
    store type (``None``: ``x.dtype``).
    """
    global launches
    if x.ndim != 4 or f.ndim != 3 or x.shape[-1] != f.shape[-1]:
        raise ValueError(f"dwconv2d shapes {tuple(x.shape)} {tuple(f.shape)}")
    b, hi, wi, c = x.shape
    hf, wf, _ = f.shape
    top, left, bottom, right = pad or (0, 0, 0, 0)
    if min(top, left, bottom, right) < 0:
        raise ValueError(f"negative pad {pad}")
    ho = (hi + top + bottom - hf) // stride + 1
    wo = (wi + left + right - wf) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError("input smaller than filter")
    odt = out_dtype or x.dtype
    if x.device.type == "cpu":
        return dwconv2d_plain(x, f, stride=stride, out_dtype=odt, pad=pad)
    dev = _build.require_cuda("dwconv2d", x, f)
    if f.dtype != x.dtype:
        raise ValueError(f"dwconv2d: x is {x.dtype} but f is {f.dtype}")
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, c), dtype=odt, device=dev)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, f, out))
    plan = blocking.plan_dwconv2d(hi, wi, ho, wo, c, hf, wf, stride=stride,
                                  dtype=x.dtype, aligned=aligned)
    vec = plan.block_g
    block_c = block_c or plan.block_c
    slab_h = min(slab_h or plan.slab_h, ho)
    tile_w = tile_w or plan.tile_w
    if block_c % vec or tile_w % blocking.DW_RUN or blocking.dw_threads(
            slab_h, tile_w, block_c, vec) > blocking.DW_THREADS:
        raise ValueError(f"dwconv2d: tile {slab_h}x{tile_w}x{block_c} is not "
                         f"whole runs of {blocking.DW_RUN} columns and "
                         f"vectors of {vec} in at most "
                         f"{blocking.DW_THREADS} threads")
    lib = _build.library("dwconv2d")
    fn = lib.dwconv2d_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "dwconv2d", fn(
        _build.ptr(x), _build.ptr(f), _build.ptr(out), b, hi, wi, c, ho, wo,
        hf, wf, stride, top, left, slab_h, tile_w, block_c, vec, cin, cout,
        _build.stream(dev)))
    launches += 1
    return out
