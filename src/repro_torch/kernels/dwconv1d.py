"""Causal depthwise 1-D convolution: the CUDA kernel's wrapper, its plain
version and its launch counter.

Replaces ``repro/kernels/dwconv1d.py::dwconv1d_causal_pallas`` (def :51,
body ``_dw1d_kernel`` :28), the conv pre-activation of the xLSTM blocks
and the Mamba heads.  The kernel is ``csrc/dwconv1d.cu``.

Bound on the H100: bytes.  K = 3..5 multiply-adds per element is under
one fp32 operation per byte moved; at B=8, L=512, D=1536 in bf16 the call
moves about 25 MB, about 0.0075 ms at 3.35 TB/s.  The TPU kernel carries
a (K-1)-row halo across sequential L blocks in VMEM; on the card no carry
is needed: each thread reads its K-1 halo rows from global memory and
slides a register window along a run of :data:`ROWS` rows, reading each
input row once in a 16-byte vector of channels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.spans import marks_span

#: Kernel launches so far in this process.
launches = 0

#: Sequence rows one thread computes (its K-1 halo rows are re-read once
#: per run, from L1/L2).
ROWS = 8

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def dwconv1d_causal_plain(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The plain version: a left zero pad and K shifted multiply-adds in
    fp32, cast to ``x.dtype`` once (``ref.dwconv1d_causal_ref``)."""
    return ref.dwconv1d_causal_ref(x, f)


def vector_width(x: torch.Tensor, f: torch.Tensor) -> int:
    """Channels per thread: one 16-byte vector when D divides into them and
    both operands are 16-byte aligned, else 1."""
    vec = 16 // x.element_size()
    d = x.shape[-1]
    if d % vec or x.data_ptr() % 16 or f.data_ptr() % 16:
        return 1
    return vec


@marks_span("dwconv1d")
def dwconv1d_causal(x: torch.Tensor, f: torch.Tensor, *,
                    rows: int = ROWS) -> torch.Tensor:
    """x (B, L, D), f (K, D) in x's dtype -> (B, L, D) in x's dtype.

    A CUDA tensor launches the kernel (``rows`` sequence rows per thread);
    a CPU tensor takes :func:`dwconv1d_causal_plain`.
    """
    global launches
    if x.ndim != 3 or f.ndim != 2 or x.shape[-1] != f.shape[-1]:
        raise ValueError(f"dwconv1d shapes {tuple(x.shape)} {tuple(f.shape)}")
    if f.shape[0] < 1 or rows < 1:
        raise ValueError(f"dwconv1d needs a tap and a row per thread, got "
                         f"K={f.shape[0]}, rows={rows}")
    if x.device.type == "cpu":
        return dwconv1d_causal_plain(x, f)
    dev = _build.require_cuda("dwconv1d", x, f)
    if f.dtype != x.dtype:
        raise ValueError(f"dwconv1d: x is {x.dtype} but f is {f.dtype}")
    b, length, d = x.shape
    cin, cout = _build.dtype_codes(x.dtype, x.dtype)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library("dwconv1d")
    fn = lib.dwconv1d_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "dwconv1d", fn(
        _build.ptr(x), _build.ptr(f), _build.ptr(out), b, length, d,
        f.shape[0], vector_width(x, f), rows, cin, cout,
        _build.stream(dev)))
    launches += 1
    return out
