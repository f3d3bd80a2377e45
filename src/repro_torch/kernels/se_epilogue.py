"""DW + squeeze-excite: the CUDA kernel's wrapper, its plain version and
its launch counter.

Replaces ``repro/kernels/se_epilogue.py::dw_se_pallas`` (def :143, body
``_dw_se_kernel``, call :214).  The kernel is ``csrc/dw_se.cu``.

The gate of an image is computed from the pooled mean of EVERY channel of
its DW output, over the whole image; a partial pool is a wrong answer.  On
the TPU one grid step holds an image's whole fp32 DW output in VMEM.  On
the H100 a reduction across CTAs needs a second pass, so one call runs
two passes over ``dwconv2d``'s tiles (``csrc/dw_tile.cuh``, planned by
``blocking.plan_dw_se_tile``), many CTAs an image:

1. the pooling pass computes DW + bias + act for its tile in fp32, sums
   each channel over the tile's in-image outputs and writes its share of
   the reduce FC (the sums times its channels' rows of w1) to an fp32
   workspace;
2. the scaling pass sums the image's shares in CTA order into the hidden
   vector, computes its channels' gates from it and w2, computes the DW
   again, by the same code in the same tap order, multiplies it by the
   gate and stores it once.

No float atomics, and every sum in an order fixed by the shapes: every
call gives the same bits, and a CUDA graph replays it.

Bound on the H100: bytes.  Hf*Wf multiply-adds per output against one
input read and one output write; the gate's two FCs are tiny.  The two
passes read the input twice (the second time mostly from L2) and do the
DW's multiply-adds twice; in exchange every SM has work at batch 1 and no
DW output goes through device memory.

Geometry: VALID on ``x`` zero-padded by ``pad`` (default none); the kernel
pads as it reads, so the lowering makes no padded copy.  The gate scales
only real outputs, so zero padding never meets the sigmoid.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.spans import marks_span
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process, one per call (``chip_smoke.py``
#: zeroes it before it drives the main path and reads it after).
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 20
             + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 9


def dw_se_plain(x, dw_f, w1, b1, w2, b2, dw_bias=None, *, stride=1,
                pad=None, dw_activation="relu6", se_activation="relu",
                out_dtype=None) -> torch.Tensor:
    """The plain version: ``ref.dw_se_ref`` on VALID geometry of ``x``
    zero-padded by ``pad``, the DW output fp32 through the pool, both FCs
    and the scale."""
    y = ref.dw_se_ref(ref.zero_pad(x, pad).float(), dw_f, w1, b1, w2, b2,
                      dw_bias, stride=stride, padding="valid",
                      dw_activation=dw_activation,
                      se_activation=se_activation)
    return y.to(out_dtype or x.dtype)


def smem_bytes(pass_: int, tile_h: int, tile_w: int, cg: int, hf: int,
               wf: int, stride: int, c_se: int, dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory one CTA of pass
    ``pass_`` needs (1 pooling, 2 scaling, 3 the hidden vector's launch;
    the planner's ``blocking.dw_se_smem_bytes`` must agree with
    it)."""
    lib = _build.library("dw_se")
    fn = lib.dw_se_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(pass_, tile_h, tile_w, cg, hf, wf, stride, c_se,
                  _build.DTYPE_CODES[dtype]))


@marks_span("dw_se")
def dw_se(
    x: torch.Tensor,
    dw_f: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dw_bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    pad: Optional[tuple] = None,
    dw_activation: Optional[str] = "relu6",
    se_activation: str = "relu",
    slab_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    block_c: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, Hi, Wi, C); dw_f (Hf, Wf, C); w1 (C, Cse); b1 (Cse,);
    w2 (Cse, C); b2 (C,); dw_bias (C,) -> (B, Ho, Wo, C): the DW output
    scaled by its squeeze-excite gate, VALID geometry of x zero-padded by
    ``pad`` = (top, left, bottom, right) (default none).

    A CUDA tensor launches the kernel's two passes at the given tile
    (``slab_h`` x ``tile_w`` outputs by ``block_c`` channels; missing
    entries come from ``blocking.plan_dw_se_tile``); a CPU tensor takes
    :func:`dw_se_plain`.  A launch the kernel refuses raises.
    """
    global launches
    b, hi, wi, c = x.shape
    hf, wf, cf = dw_f.shape
    c1, c_se = w1.shape
    if not (c == cf == c1 and w2.shape == (c_se, c)
            and b1.shape == (c_se,) and b2.shape == (c,)):
        raise ValueError(f"dw_se shapes x {tuple(x.shape)}, dw_f "
                         f"{tuple(dw_f.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    top, left, bottom, right = pad or (0, 0, 0, 0)
    if min(top, left, bottom, right) < 0:
        raise ValueError(f"negative pad {pad}")
    ho = (hi + top + bottom - hf) // stride + 1
    wo = (wi + left + right - wf) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError("input smaller than filter")
    odt = out_dtype or x.dtype
    if x.device.type == "cpu":
        return dw_se_plain(x, dw_f, w1, b1, w2, b2, dw_bias, stride=stride,
                           pad=pad, dw_activation=dw_activation,
                           se_activation=se_activation, out_dtype=odt)
    operands = (x, dw_f, dw_bias, w1, b1, w2, b2)
    dev = _build.require_cuda("dw_se", *operands)
    for t in operands:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"dw_se: x is {x.dtype} but got a {t.dtype} "
                             "operand")
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, c), dtype=odt, device=dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dw_f, out))
    plan = blocking.plan_dw_se_tile(ho, wo, c, c_se, hf, wf, stride=stride,
                                    dtype=x.dtype, batch=b, aligned=aligned)
    if plan is None:
        raise ValueError(f"dw_se: no tile of a {hf}x{wf} filter and {c} "
                         "channels fits a CTA")
    vec = plan.block_g
    block_c = block_c or plan.block_c
    slab_h = min(slab_h or plan.slab_h, ho)
    tile_w = tile_w or plan.tile_w
    if block_c % vec or tile_w % blocking.DW_RUN or blocking.dw_threads(
            slab_h, tile_w, block_c, vec) > blocking.DW_THREADS:
        raise ValueError(f"dw_se: tile {slab_h}x{tile_w}x{block_c} is not "
                         f"whole runs of {blocking.DW_RUN} columns and "
                         f"vectors of {vec} in at most "
                         f"{blocking.DW_THREADS} threads")
    ctas = -(-ho // slab_h) * -(-wo // tile_w) * -(-c // block_c)
    hpart = torch.empty((b, ctas, c_se), dtype=torch.float32, device=dev)
    lib = _build.library("dw_se")
    fn = lib.dw_se_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "dw_se", fn(
        *(_build.ptr(t) for t in operands), _build.ptr(out),
        _build.ptr(hpart), b, hi, wi, c, ho, wo, hf, wf,
        stride, top, left, slab_h, tile_w, block_c, vec, c_se,
        activation_code(dw_activation), activation_code(se_activation),
        cin, cout, _build.stream(dev)))
    launches += 1
    return out
