"""Pointwise convolution / GEMM: the CUDA kernel's wrapper, its plain
version and its launch counters.

Replaces ``repro/kernels/pwconv.py::pwconv_pallas`` (def :122, body
``_rtrd_kernel`` :76), the paper's output-stationary (RTRD) PWConv.  The
kernel is ``csrc/pwconv.cu``; it has three variants, which
``blocking.plan_pwconv`` picks from the shape:

* ``stream`` (G <= 16: decode, the SE gate FCs) is bound by the bytes of
  w: CTAs own Co slices, read w rows as 16-byte vectors, and split Ci over a
  thread-block cluster whose partial tiles meet in distributed shared memory;
* ``tc`` (bf16 / fp16, Ci and Co multiples of 8, 16-byte aligned bases) runs
  the tensor cores: TMA loads into a 4-stage ring, wgmma with fp32
  accumulators in registers;
* ``simt`` (fp32, and 16-bit shapes TMA cannot describe) keeps exact fp32
  FMAs on the CUDA cores in 8 x 8 register micro-tiles.

Every variant holds its output tile in registers across the whole
reduction and stores it once with bias and activation applied, ragged edges
masked rather than padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, blocking, ref
from repro_torch.kernels.spans import marks_span
from repro_torch.kernels.epilogue import activation_code

#: Kernel launches so far in this process, and by variant
#: (``repro_torch.graphs`` snapshots, restores and resets them).
launches = 0
launches_by_variant = dict.fromkeys(blocking.PW_VARIANTS, 0)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 5


_launch_fn = None


def _launcher():
    """``pwconv_launch`` of the built library, its argument types set once
    (a decode step launches the kernel 60 times)."""
    global _launch_fn
    if _launch_fn is None:
        lib = _build.library("pwconv")
        fn = lib.pwconv_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _launch_fn = (lib, fn)
    return _launch_fn


def smem_bytes(variant: str, bg: int, bco: int, bci: int, ci: int) -> int:
    """Shared memory the kernel itself reserves for one CTA of this variant
    and tile over a reduction of ``ci`` (its own layout code,
    ``pwconv_smem_bytes``)."""
    lib = _build.library("pwconv")
    fn = lib.pwconv_smem_bytes
    fn.argtypes, fn.restype = _SMEM_ARGTYPES, ctypes.c_longlong
    return int(fn(blocking.PW_VARIANTS.index(variant), bg, bco, bci, ci))


def pwconv_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: an fp32 matmul, bias and activation in fp32."""
    y = ref.pwconv_ref(x.float(), w, bias=bias, activation=activation)
    return y.to(out_dtype or x.dtype)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@marks_span("pwconv")
def pwconv(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: Optional[str] = None,
           variant: Optional[str] = None,
           block_g: Optional[int] = None, block_co: Optional[int] = None,
           block_ci: Optional[int] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (G, Ci) @ w (Ci, Co) [+ bias (Co,)] -> act -> (G, Co).

    A CUDA tensor launches the kernel: ``variant`` and the ``None`` tile
    entries come from ``blocking.plan_pwconv`` (``tc`` gives way to ``simt``
    before the launch where a base is not 16-byte aligned); a tile outside
    the variant's compiled table raises.  A CPU tensor takes
    :func:`pwconv_plain`.  ``out_dtype`` is the store type.
    """
    global launches
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"pwconv shapes {tuple(x.shape)} {tuple(w.shape)}")
    if bias is not None and bias.shape != (w.shape[1],):
        raise ValueError(f"pwconv bias shape {tuple(bias.shape)}")
    if variant is not None and variant not in blocking.PW_VARIANTS:
        raise ValueError(f"pwconv: unknown variant {variant!r}; want one of "
                         f"{blocking.PW_VARIANTS}")
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
    cin, cout = _build.dtype_codes(x.dtype, odt)
    out = torch.empty((g, co), dtype=odt, device=dev)
    if out.numel() == 0:
        return out
    # decided before the launch, from the shape and the bases' alignment
    if variant is None:
        variant = blocking.pw_variant(g, ci, co, x.dtype,
                                      aligned=_aligned(x, w))
    elif variant == "tc" and not _aligned(x, w):
        # the tc tile gives way with the variant
        variant, block_g, block_co, block_ci = "simt", None, None, None
    if variant == "tc" and (x.dtype == torch.float32 or ci % 8 or co % 8):
        raise ValueError(f"pwconv: tc takes 16-bit operands with Ci and Co "
                         f"multiples of 8, not {x.dtype} {ci}->{co}")
    w_aligned = _aligned(w)
    plan = blocking.plan_pwconv(g, ci, co, dtype=x.dtype, variant=variant,
                                aligned=w_aligned)
    bg = block_g or plan.block_g
    bco = block_co or plan.block_co
    bci = block_ci or plan.block_c
    vec = blocking.pw_vector(co, x.dtype, w_aligned)
    why = blocking.pwconv_tile_error(variant, bg, bco, bci, ci=ci,
                                     vector=vec)
    if why is not None:
        raise ValueError(f"pwconv: {why}")
    cluster = -(-ci // bci) if variant == "stream" else 1
    lib, fn = _launcher()
    _build.check(lib, "pwconv", fn(
        _build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(out),
        g, ci, co, blocking.PW_VARIANTS.index(variant), bg, bco, bci,
        cluster, int(vec > 1), activation_code(activation), cin, cout,
        _build.stream(dev)))
    launches += 1
    launches_by_variant[variant] += 1
    return out
