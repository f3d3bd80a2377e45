"""Fused depthwise-separable block ([PW-expand ->] DW -> PW): the CUDA
kernel's wrapper, its plain version and its launch counters.

Replaces ``repro/kernels/separable_fused.py::separable_fused_pallas`` (def
:254, body ``_fused_kernel`` :167) in both its modes: ``fused2`` (DW -> PW)
and ``fused3`` (bias-free PW-expand computed on the fly -> DW -> PW).  The
kernel is ``csrc/separable_fused.cu``.

Bound on the H100: operations.  The block moves only its input, weights
and output, and does 2*C*Co (+ 2*Ci*C with expand) operations per output
pixel on the CUDA cores in fp32.  What the design buys is traffic: one CTA
per (image, slab_h x tile_w output tile, Co panel) loops over the DW
channels in chunks, keeps the expanded window and the DW tile in shared
memory and the output tile in registers, so neither the expanded tensor
nor the DW output reaches device memory.  The expand of the tile's halo is
recomputed per tile, not stored.

VALID geometry: callers pad SAME first.  Zero padding commutes with the
bias-free expand because every activation maps 0 to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process, per mode.
launches = {"fused2": 0, "fused3": 0}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 20
             + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 11


def separable_fused_plain(
    x, dw_f, pw_w, dw_bias=None, pw_bias=None, residual=None, *,
    expand_w=None, expand_activation="relu6", stride=1,
    dw_activation="relu6", activation=None, out_dtype=None,
) -> torch.Tensor:
    """The plain version: ``ref.separable_fused_ref`` on VALID geometry,
    fp32 intermediates, one store at ``out_dtype``."""
    y = ref.separable_fused_ref(
        x.float(), dw_f, pw_w, dw_bias, pw_bias, residual,
        expand_w=expand_w, expand_activation=expand_activation,
        stride=stride, padding="valid", dw_activation=dw_activation,
        activation=activation)
    return y.to(out_dtype or x.dtype)


def smem_bytes(ci: int, c: int, hf: int, wf: int, stride: int,
               slab_h: int, tile_w: int, cb: int, cob: int, expand: bool,
               dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory one CTA needs (the
    planner's ``blocking.fused_smem_bytes`` must agree with it)."""
    lib = _build.library("separable_fused")
    fn = lib.separable_fused_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(ci, c, hf, wf, stride, slab_h, tile_w, cb, cob,
                  int(expand), _build.DTYPE_CODES[dtype]))


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
    block_c: Optional[int] = None,
    block_co: Optional[int] = None,
    slab_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, Hi, Wi, C) [or (B, Hi, Wi, Ci) with ``expand_w`` (Ci, C)];
    dw_f (Hf, Wf, C); pw_w (C, Co); dw_bias (C,); pw_bias (Co,); residual
    (B, Ho, Wo, Co) -> (B, Ho, Wo, Co), VALID geometry.

    A CUDA tensor launches the kernel at the given tile (missing entries
    come from ``blocking.plan_separable``/``plan_separable3``); a CPU tensor
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
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
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
            out_dtype=odt)
    operands = (x, expand_w, dw_f, dw_bias, pw_w, pw_bias, residual)
    dev = _build.require_cuda("separable_fused", *operands)
    for t in operands:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"separable_fused: x is {x.dtype} but got a "
                             f"{t.dtype} operand")
    if None in (block_c, block_co, slab_h, tile_w):
        if expand_w is not None:
            plan = blocking.plan_separable3(ho, wo, c_in, c, co,
                                            stride=stride, hf=hf, wf=wf,
                                            dtype=x.dtype)
        else:
            plan = blocking.plan_separable(ho, wo, c, co, stride=stride,
                                           hf=hf, wf=wf, dtype=x.dtype)
        if plan is None:
            raise ValueError(f"no fused tile fits one CTA for "
                             f"{(hi, wi, c_in, c, co)}")
        block_c = block_c or plan.block_c
        block_co = block_co or plan.block_co
        slab_h = slab_h or plan.slab_h
        tile_w = tile_w or plan.tile_w
    slab_h, tile_w = min(slab_h, ho), min(tile_w, wo)
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, co), dtype=odt, device=dev)
    mode = "fused3" if expand_w is not None else "fused2"
    lib = _build.library("separable_fused")
    fn = lib.separable_fused_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "separable_fused", fn(
        *(_build.ptr(t) for t in operands), _build.ptr(out),
        b, hi, wi, c_in, c, co, ho, wo, hf, wf, stride, slab_h, tile_w,
        block_c, block_co, activation_code(expand_activation),
        activation_code(dw_activation), activation_code(activation),
        cin, cout, _build.stream(dev)))
    launches[mode] += 1
    return out
