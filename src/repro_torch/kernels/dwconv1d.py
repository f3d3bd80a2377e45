"""Causal depthwise 1-D convolution: the CUDA kernels' wrappers, their plain
versions, their launch counters and the autograd Function around them.

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

The backward (training) replaces no TPU kernel: the reference
differentiates its XLA oracle ``ref.dwconv1d_causal_ref``
(``repro/kernels/ref.py:76-89``).  On the card the forward is a kernel, so
its gradient is one too, in two launches of the same library:

* ``dw1d_bwd_kernel`` (:func:`bwd_partials`): dx, the anti-causal conv
  ``dx[m] = sum_i f[i] dy[m + (K-1) - i]``, and df's partial sums
  ``x[l - (K-1) + i] dy[l]`` over each CTA's rows, one fp32 slot per CTA
  in a workspace, in one pass over x and dy;
* ``dw1d_df_reduce_kernel`` (:func:`reduce_partials`): df, the slots
  summed in order in fp32 and rounded once to f's type.

No atomics, so df has the same bits at every call (training's bit-exact
recovery).  Bound: bytes again, x and dy read and dx written once (about
19 MB at xLSTM's 8 x 256 x 1536 in bf16, 0.006 ms); the workspace is
K x D fp32 a CTA along the rows (0.8 MB there).

:class:`DwConv1dFn` differentiates the op (``ops.dwconv1d_causal`` under
autograd): its forward is the kernel on a CUDA tensor, its backward the
two kernels; ``impl="torch"`` or a CPU tensor takes
:func:`dwconv1d_causal_plain` and :func:`dwconv1d_causal_bwd_plain`.
Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.kernels.policy import resolve_impl
from repro_torch.kernels.spans import marks_span

#: Kernel launches so far in this process: the forward, the backward's
#: first pass (dx and df's partials) and its second (df).
launches = 0
bwd_launches = 0
reduce_launches = 0

#: Sequence rows one thread computes (its K-1 halo rows are re-read once
#: per run, from L1/L2).
ROWS = 8

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_REDUCE_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def dwconv1d_causal_plain(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The plain version: a left zero pad and K shifted multiply-adds in
    fp32, cast to ``x.dtype`` once (``ref.dwconv1d_causal_ref``)."""
    return ref.dwconv1d_causal_ref(x, f)


def dwconv1d_causal_bwd_plain(x: torch.Tensor, f: torch.Tensor,
                              dy: torch.Tensor) -> tuple:
    """The plain version of the backward: ``(dx, df)`` from dy (B, L, D),
    x (B, L, D) and f (K, D), in fp32 (fp64 for fp64 operands), dx cast
    once to x's dtype and df to f's (the reference's autodiff of
    ``dwconv1d_causal_ref``: fp32 math, then the transpose of ``f[i]``'s
    upcast)."""
    k, length = f.shape[0], x.shape[1]
    acc = ref.acc_dtype(x.dtype)
    g, xf, ff = dy.to(acc), x.to(acc), f.to(acc)
    gp = F.pad(g, (0, 0, 0, k - 1))
    xp = F.pad(xf, (0, 0, k - 1, 0))
    dx = torch.zeros(x.shape, dtype=acc, device=x.device)
    for i in range(k):
        dx = dx + gp[:, k - 1 - i:k - 1 - i + length] * ff[i]
    df = torch.stack([(xp[:, i:i + length] * g).sum(dim=(0, 1))
                      for i in range(k)])
    return dx.to(x.dtype), df.to(f.dtype)


def vector_width(x: torch.Tensor, *operands: torch.Tensor) -> int:
    """Channels per thread: one 16-byte vector when D divides into them and
    every operand is 16-byte aligned, else 1."""
    vec = 16 // x.element_size()
    if x.shape[-1] % vec or any(t.data_ptr() % 16 for t in (x, *operands)):
        return 1
    return vec


def _check(x: torch.Tensor, f: torch.Tensor, rows: int) -> None:
    if x.ndim != 3 or f.ndim != 2 or x.shape[-1] != f.shape[-1]:
        raise ValueError(f"dwconv1d shapes {tuple(x.shape)} {tuple(f.shape)}")
    if f.shape[0] < 1 or rows < 1:
        raise ValueError(f"dwconv1d needs a tap and a row per thread, got "
                         f"K={f.shape[0]}, rows={rows}")


@marks_span("dwconv1d")
def dwconv1d_causal(x: torch.Tensor, f: torch.Tensor, *,
                    rows: int = ROWS) -> torch.Tensor:
    """x (B, L, D), f (K, D) in x's dtype -> (B, L, D) in x's dtype.

    A CUDA tensor launches the kernel (``rows`` sequence rows per thread);
    a CPU tensor takes :func:`dwconv1d_causal_plain`.
    """
    global launches
    _check(x, f, rows)
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


def bwd_splits(b: int, length: int, rows: int = ROWS) -> int:
    """Workspace slots of :func:`bwd_partials`: its CTAs along the rows
    (8 runs of ``rows`` rows of one batch row each)."""
    lib = _build.library("dwconv1d")
    fn = lib.dwconv1d_bwd_splits
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(b, length, rows))


def bwd_partials(x: torch.Tensor, f: torch.Tensor, dy: torch.Tensor, *,
                 rows: int = ROWS) -> tuple:
    """The backward's first launch, CUDA tensors only: ``(dx, ws)``, dx
    (B, L, D) in x's dtype and ws (splits, K, D) fp32, df's partial sums."""
    global bwd_launches
    _check(x, f, rows)
    dev = _build.require_cuda("dwconv1d", x, f, dy)
    if f.dtype != x.dtype or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dwconv1d backward: x {x.dtype} {tuple(x.shape)}, "
                         f"f {f.dtype}, dy {dy.dtype} {tuple(dy.shape)}")
    b, length, d = x.shape
    k = f.shape[0]
    code, _ = _build.dtype_codes(x.dtype, x.dtype)
    dx = torch.empty_like(x)
    ws = torch.empty((bwd_splits(b, length, rows), k, d),
                     dtype=torch.float32, device=dev)
    lib = _build.library("dwconv1d")
    fn = lib.dwconv1d_bwd_launch
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    _build.check(lib, "dwconv1d", fn(
        _build.ptr(x), _build.ptr(f), _build.ptr(dy), _build.ptr(dx),
        _build.ptr(ws), b, length, d, k, vector_width(x, f, dy, dx), rows,
        code, _build.stream(dev)))
    bwd_launches += 1
    return dx, ws


def reduce_partials(ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The backward's second launch: df (K, D) in ``dtype``, ws's slots
    summed in order in fp32 and rounded once."""
    global reduce_launches
    dev = _build.require_cuda("dwconv1d", ws)
    splits, k, d = ws.shape
    code, _ = _build.dtype_codes(dtype, dtype)
    df = torch.empty((k, d), dtype=dtype, device=dev)
    lib = _build.library("dwconv1d")
    fn = lib.dwconv1d_bwd_reduce_launch
    fn.argtypes, fn.restype = _REDUCE_ARGTYPES, ctypes.c_int
    _build.check(lib, "dwconv1d", fn(_build.ptr(ws), _build.ptr(df), splits,
                                     k, d, code, _build.stream(dev)))
    reduce_launches += 1
    return df


@marks_span("dwconv1d")
def dwconv1d_causal_bwd(x: torch.Tensor, f: torch.Tensor, dy: torch.Tensor,
                        *, rows: int = ROWS) -> tuple:
    """``(dx, df)`` of :func:`dwconv1d_causal` for the output gradient dy
    (B, L, D), dx in x's dtype and df in f's.  CUDA tensors launch
    :func:`bwd_partials` and :func:`reduce_partials`; CPU tensors take
    :func:`dwconv1d_causal_bwd_plain`."""
    _check(x, f, rows)
    if x.device.type == "cpu":
        return dwconv1d_causal_bwd_plain(x, f, dy)
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(f)
    dx, ws = bwd_partials(x, f, dy, rows=rows)
    return dx, reduce_partials(ws, f.dtype)


class DwConv1dFn(torch.autograd.Function):
    """:func:`dwconv1d_causal` with its gradient; ``impl`` as the ops'
    (``"torch"``, or a CPU tensor under ``"auto"``, takes the plain
    versions)."""

    @staticmethod
    def forward(ctx, x, f, impl):
        ctx.kernel = resolve_impl(impl, x.device) != "torch"
        ctx.save_for_backward(x, f)
        return (dwconv1d_causal(x, f) if ctx.kernel
                else dwconv1d_causal_plain(x, f))

    @staticmethod
    def backward(ctx, dy):
        x, f = ctx.saved_tensors
        dy = dy.contiguous()
        dx, df = (dwconv1d_causal_bwd(x, f, dy) if ctx.kernel
                  else dwconv1d_causal_bwd_plain(x, f, dy))
        return (dx if ctx.needs_input_grad[0] else None,
                df if ctx.needs_input_grad[1] else None, None)

