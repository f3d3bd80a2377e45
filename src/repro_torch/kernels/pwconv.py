"""Pointwise convolution / GEMM: the CUDA kernel's wrapper, its plain
version and its launch counter.

Replaces ``repro/kernels/pwconv.py::pwconv_pallas`` (def :122, body
``_rtrd_kernel`` :76), the paper's output-stationary (RTRD) PWConv.  The
kernel is ``csrc/pwconv.cu``.

Bound on the H100: a (G, Ci) x (Ci, Co) product does 2*Ci*Co/(Ci+Co)
operations per element moved, so at the main-path shapes the narrow early
layers are bound by bytes and the wide late layers by fp32 operations on
the CUDA cores.  The kernel is a shared-memory tiled GEMM: a 64x64 (or
128-wide) output tile per CTA held in 4x4 register micro-tiles across the
whole reduction, stored once with bias and activation applied, ragged edges
masked rather than padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process.
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def pwconv_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: an fp32 matmul, bias and activation in fp32."""
    y = ref.pwconv_ref(x.float(), w, bias=bias, activation=activation)
    return y.to(out_dtype or x.dtype)


def pwconv(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: Optional[str] = None,
           block_g: Optional[int] = None, block_co: Optional[int] = None,
           block_ci: Optional[int] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (G, Ci) @ w (Ci, Co) [+ bias (Co,)] -> act -> (G, Co).

    A CUDA tensor launches the kernel at the given tile (``None`` entries
    come from ``blocking.plan_pwconv``); a CPU tensor takes
    :func:`pwconv_plain`.  ``out_dtype`` is the store type.
    """
    global launches
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"pwconv shapes {tuple(x.shape)} {tuple(w.shape)}")
    if bias is not None and bias.shape != (w.shape[1],):
        raise ValueError(f"pwconv bias shape {tuple(bias.shape)}")
    odt = out_dtype or x.dtype
    if x.device.type == "cpu":
        return pwconv_plain(x, w, bias, activation=activation, out_dtype=odt)
    dev = _build.require_cuda("pwconv", x, w, bias)
    for t in (w, bias):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"pwconv: x is {x.dtype} but got a {t.dtype} "
                             "operand")
    g, ci = x.shape
    co = w.shape[1]
    plan = blocking.plan_pwconv(g, ci, co, dtype=x.dtype)
    bg = block_g or plan.block_g
    bco = block_co or plan.block_co
    bci = block_ci or plan.block_c
    if (bg, bco) not in blocking.PW_TILES_GC or bci not in blocking.PW_BLOCK_CI:
        raise ValueError(f"pwconv: no compiled tile ({bg}, {bco}, {bci}); "
                         f"(block_g, block_co) in {blocking.PW_TILES_GC}, "
                         f"block_ci in {blocking.PW_BLOCK_CI}")
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((g, co), dtype=odt, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("pwconv")
    fn = lib.pwconv_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "pwconv", fn(
        _build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(out),
        g, ci, co, bg, bco, bci, activation_code(activation), cin, cout,
        _build.stream(dev)))
    launches += 1
    return out
