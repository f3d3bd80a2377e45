"""DW + squeeze-excite in one pass: the CUDA kernel's wrapper, its plain
version and its launch counter.

Replaces ``repro/kernels/se_epilogue.py::dw_se_pallas`` (def :143, body
``_dw_se_kernel``, call :214).  The kernel is ``csrc/dw_se.cu``.

The gate of an image is computed from the pooled mean of EVERY channel of
its DW output, over the whole image; a partial pool is a wrong answer.  On
the TPU one grid step holds an image's whole fp32 DW output in VMEM.  On
the H100 that does not fit one CTA's 227 KB for most MnasNet SE blocks, so
the kernel runs one thread-block cluster of ``cluster`` CTAs per image
(``blocking.plan_dw_se`` picks the smallest of 1, 2, 4, 8 that fits).  Each
CTA keeps the fp32 DW output of its channel slice resident, pools it and
forms its partial hidden vector; the partials are summed across the
cluster through distributed shared memory behind a cluster barrier, so
every CTA computes its gates from the whole pooled vector.  Each CTA then
scales its resident slice and stores it once.  Where not even 8 CTAs hold
the slice, the ``recompute`` mode keeps only the pooled sums and computes
the DW again, in the same tap order, for the scaled store (bit-identical
values for twice the DW's multiply-adds and a second read of the input).

Bound on the H100: bytes.  Hf*Wf multiply-adds per output against one
input read and one output write; the gate's two FCs are tiny.  At batch 1
the launch is at most 8 CTAs, so it is far from that bound.

VALID geometry: callers pad SAME first.  The gate scales only real
channels, so zero padding never meets the sigmoid.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process, in all and by mode.
launches = 0
launches_by_variant = dict.fromkeys(blocking.DW_SE_VARIANTS, 0)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 16
             + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 6


def reset_launches() -> None:
    """Zero the launch counters."""
    global launches
    launches = 0
    for k in launches_by_variant:
        launches_by_variant[k] = 0


def dw_se_plain(x, dw_f, w1, b1, w2, b2, dw_bias=None, *, stride=1,
                dw_activation="relu6", se_activation="relu",
                out_dtype=None) -> torch.Tensor:
    """The plain version: ``ref.dw_se_ref`` on VALID geometry, the DW
    output fp32 through the pool, both FCs and the scale."""
    y = ref.dw_se_ref(x.float(), dw_f, w1, b1, w2, b2, dw_bias,
                      stride=stride, padding="valid",
                      dw_activation=dw_activation,
                      se_activation=se_activation)
    return y.to(out_dtype or x.dtype)


def smem_bytes(ho: int, wo: int, c: int, c_se: int, cluster: int,
               variant: str = "resident") -> int:
    """The kernel's own count of the shared memory one CTA needs (the
    planner's ``blocking.dw_se_smem_bytes`` must agree with it)."""
    lib = _build.library("dw_se")
    fn = lib.dw_se_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(ho, wo, c, c_se, cluster, int(variant == "resident")))


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
    dw_activation: Optional[str] = "relu6",
    se_activation: str = "relu",
    cluster: Optional[int] = None,
    variant: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, Hi, Wi, C); dw_f (Hf, Wf, C); w1 (C, Cse); b1 (Cse,);
    w2 (Cse, C); b2 (C,); dw_bias (C,) -> (B, Ho, Wo, C): the DW output
    scaled by its squeeze-excite gate, VALID geometry.

    A CUDA tensor launches the kernel with ``cluster`` CTAs per image in
    mode ``variant`` ("resident" or "recompute"; ``None`` entries come
    from ``blocking.plan_dw_se``); a CPU tensor takes :func:`dw_se_plain`.
    A launch that cannot place its cluster, or whose resident slice does
    not fit a CTA, raises.
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
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError("input smaller than filter")
    odt = out_dtype or x.dtype
    if x.device.type == "cpu":
        return dw_se_plain(x, dw_f, w1, b1, w2, b2, dw_bias, stride=stride,
                           dw_activation=dw_activation,
                           se_activation=se_activation, out_dtype=odt)
    operands = (x, dw_f, dw_bias, w1, b1, w2, b2)
    dev = _build.require_cuda("dw_se", *operands)
    for t in operands:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"dw_se: x is {x.dtype} but got a {t.dtype} "
                             "operand")
    if cluster is None or variant is None:
        plan = blocking.plan_dw_se((ho - 1) * stride + hf,
                                   (wo - 1) * stride + wf, ho, wo, c, c_se,
                                   hf, wf, dtype=x.dtype)
        if plan is None:
            raise ValueError(f"dw_se: no plan for the DW output of "
                             f"{(ho, wo, c)}")
        cluster = cluster or plan.cluster
        variant = variant or plan.variant
    if cluster not in blocking.DW_SE_CLUSTERS:
        raise ValueError(f"dw_se: cluster {cluster} not in "
                         f"{blocking.DW_SE_CLUSTERS}")
    if variant not in blocking.DW_SE_VARIANTS:
        raise ValueError(f"dw_se: mode {variant!r} not in "
                         f"{blocking.DW_SE_VARIANTS}")
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((b, ho, wo, c), dtype=odt, device=dev)
    lib = _build.library("dw_se")
    fn = lib.dw_se_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(lib, "dw_se", fn(
        *(_build.ptr(t) for t in operands), _build.ptr(out),
        b, hi, wi, c, ho, wo, hf, wf, stride, c_se, cluster,
        int(variant == "resident"), activation_code(dw_activation),
        activation_code(se_activation), cin, cout, _build.stream(dev)))
    launches += 1
    launches_by_variant[variant] += 1
    return out
