"""Depthwise 2-D convolution: the CUDA kernel's wrapper, its plain version
and its launch counter.

Replaces ``repro/kernels/dwconv2d.py::dwconv2d_pallas`` (def :87, body
``_dw2d_kernel`` :64).  The kernel is ``csrc/dwconv2d.cu``.

Bound on the H100: bytes.  A 3x3 depthwise conv does 9 multiply-adds per
input element, 2-4.5 operations per byte in fp32 against the card's ~20
fp32 operations per byte of device memory.  The kernel therefore reads
each input once in coalesced 16-byte vectors along C (one thread per output
pixel and 4-channel group), keeps the taps in registers and stores each
output once at ``out_dtype``, accumulating in fp32.

VALID geometry: callers pad SAME first (``ref.pad_same``), as the
reference's wrapper does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref

#: Kernel launches so far in this process (``chip_smoke.py`` zeroes it
#: before it drives the main path and reads it after).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


def dwconv2d_plain(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: fp32 ``F.conv2d(groups=C)`` on VALID geometry."""
    y = ref.dwconv2d_ref(x.float(), f, stride=stride, padding="valid")
    return y.to(out_dtype or x.dtype)


def dwconv2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
             block_c: Optional[int] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (B, Hi, Wi, C), f (Hf, Wf, C) -> (B, Ho, Wo, C), VALID geometry.

    A CUDA tensor launches the kernel (``block_c`` channels per thread, 1
    or 4; ``None`` plans it); a CPU tensor takes :func:`dwconv2d_plain`.
    ``out_dtype`` is the store type (``None``: ``x.dtype``).
    """
    global launches
    if x.ndim != 4 or f.ndim != 3 or x.shape[-1] != f.shape[-1]:
        raise ValueError(f"dwconv2d shapes {tuple(x.shape)} {tuple(f.shape)}")
    b, hi, wi, c = x.shape
    hf, wf, _ = f.shape
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError("input smaller than filter")
    odt = out_dtype or x.dtype
    if x.device.type == "cpu":
        return dwconv2d_plain(x, f, stride=stride, out_dtype=odt)
    dev = _build.require_cuda("dwconv2d", x, f)
    if f.dtype != x.dtype:
        raise ValueError(f"dwconv2d: x is {x.dtype} but f is {f.dtype}")
    if max(hf, wf) > blocking.DW_MAX_TAPS:
        raise NotImplementedError(
            f"dwconv2d kernel holds at most {blocking.DW_MAX_TAPS}x"
            f"{blocking.DW_MAX_TAPS} taps, got {hf}x{wf}")
    vec = block_c or blocking.plan_dwconv2d(hi, wi, ho, wo, c, hf, wf,
                                            dtype=x.dtype).block_c
    if vec not in (1, blocking.DW_VEC) or c % vec:
        raise ValueError(f"dwconv2d: block_c {vec} does not divide C={c}")
    if vec > 1 and (x.data_ptr() % (vec * x.element_size())
                    or f.data_ptr() % (vec * f.element_size())):
        raise ValueError("dwconv2d: operands are not vector-aligned")
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, c), dtype=odt, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("dwconv2d")
    fn = lib.dwconv2d_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "dwconv2d", fn(
        _build.ptr(x), _build.ptr(f), _build.ptr(out), b, hi, wi, c, ho, wo,
        hf, wf, stride, vec, cin, cout, _build.stream(dev)))
    launches += 1
    return out
