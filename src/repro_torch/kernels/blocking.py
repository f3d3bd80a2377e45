"""Block planner for the Hopper kernels, and the chain-plan schema.

Counterpart of ``repro/kernels/blocking.py``.  The schema (``BlockPlan``,
``ChainSegment``, ``ChainPlan``, the segment kinds) is the reference's; the
budget is re-aimed from a TPU core's VMEM (12 MiB, 128-lane snapping) at
ONE CTA of an H100: at most 227 KB (232,448 B) of dynamic shared memory.

The fused separable kernel (``csrc/separable_fused.cu``) tiles the output
into ``slab_h x tile_w`` pixels (at most :data:`FUSED_MAX_PIXELS`) by a
Co panel of at most :data:`FUSED_MAX_CO` channels, and loops over the DW
channels in chunks of ``block_c``.  Its input window therefore carries a
halo on BOTH axes, ``(slab_h-1)*s + Hf`` rows by ``(tile_w-1)*s + Wf``
columns; the reference's slab always spans the full output width.  The
shared-memory model below is the one the kernel's own layout follows
(``fused_layout`` in ``csrc/separable_fused.cu``); the kernel refuses
a launch whose layout exceeds the budget, so a drift fails loudly.

The fused-MBConv kernel (``csrc/fused_mbconv.cu``) has the same tile
and Co panel; per conv-output chunk it stages the dense filter chunk in
fp32 as well (``fused_mb_smem_bytes``).

The DW + squeeze-excite kernel (``csrc/dw_se.cu``) needs the WHOLE fp32 DW
output of an image resident, because its gate mixes the pooled mean of
every channel.  That does not fit one CTA for most MnasNet SE blocks, so
it runs one thread-block cluster of ``n`` CTAs per image, each holding a
``ceil(C / n)``-channel slice; :func:`plan_dw_se` takes the smallest ``n``
in :data:`DW_SE_CLUSTERS` whose slice fits.

``dwconv2d`` uses no shared memory (one thread per output pixel and
channel group, taps in registers); ``pwconv`` is a tiled GEMM whose
``(block_g, block_co, block_ci)`` tile is one of the kernel's compiled
shapes (:data:`PW_TILES_GC`, :data:`PW_BLOCK_CI`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: Dynamic shared memory one CTA may use on Hopper (227 KB).
DEFAULT_SMEM_BUDGET = 232_448

#: Accumulators and fused intermediates are fp32.
ACC_BYTES = 4

#: The fused kernel's CTA tile limits (256 threads, 4x4 register
#: micro-tile each): at most 64 output pixels by 64 output channels.
FUSED_MAX_PIXELS = 64
FUSED_MAX_CO = 64
#: Largest DW channel chunk a fused CTA stages at once.
FUSED_MAX_CB = 64

#: Channels per thread in ``dwconv2d`` (one 16-byte fp32 vector).
DW_VEC = 4
#: Largest filter the ``dwconv2d`` kernel holds in registers.
DW_MAX_TAPS = 7

#: pwconv tiles the kernel is compiled for: (block_g, block_co) pairs and
#: the K step, which is a runtime loop bound up to 32.
PW_TILES_GC = ((64, 64), (64, 128), (128, 64), (128, 128))
PW_BLOCK_CI = (8, 16, 32)

#: Threads of one ``dw_se`` CTA, and the cluster sizes it launches with
#: (8 is the largest portable cluster on Hopper).
DW_SE_THREADS = 1024
DW_SE_CLUSTERS = (1, 2, 4, 8)

_ALIGN = 16


def _a(n: int) -> int:
    """Round a shared-memory region up to 16 bytes, as the kernel does."""
    return -(-n // _ALIGN) * _ALIGN


def dtype_bytes(dtype: torch.dtype) -> int:
    """Element width streamed operands are budgeted at."""
    return dtype.itemsize


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """One kernel launch's block choices and the shared memory behind them.

    * ``dwconv2d``        — ``block_c``: channels per thread (1 or 4).
    * ``separable_fused`` — ``block_c`` (DW channel chunk), ``block_co``
      (Co panel), ``slab_h`` x ``tile_w`` output pixels per CTA.
    * ``pwconv``          — ``block_g``, ``block_co``, ``block_c`` (K step).
    * ``fused_mbconv``    — as ``separable_fused``; ``block_c`` chunks the
      conv output.
    * ``dw_se``           — ``cluster`` CTAs per image, ``block_c`` channels
      each; ``block_g`` carries the SE width ``c_se``.
    """
    block_c: int
    block_co: int
    slab_h: int
    n_slabs: int
    halo_rows: int
    smem_bytes: int
    dtype_bytes: int
    block_g: int = 0
    tile_w: int = 0
    cluster: int = 1


# ---------------------------------------------------------------------------
# dwconv2d
# ---------------------------------------------------------------------------

def plan_dwconv2d(hi: int, wi: int, ho: int, wo: int, c: int,
                  hf: int = 3, wf: int = 3, *,
                  dtype: torch.dtype = torch.float32,
                  smem_budget: int = DEFAULT_SMEM_BUDGET) -> BlockPlan:
    """Channels per thread for the depthwise kernel: a 4-wide vector when
    ``C`` allows it.  The kernel holds no shared memory."""
    return BlockPlan(
        block_c=DW_VEC if c % DW_VEC == 0 else 1, block_co=0, slab_h=ho,
        n_slabs=1, halo_rows=0, smem_bytes=0, dtype_bytes=dtype_bytes(dtype),
    )


# ---------------------------------------------------------------------------
# fused separable block ([PW-expand ->] DW -> PW)
# ---------------------------------------------------------------------------

def fused_smem_bytes(slab_h: int, tile_w: int, cb: int, cob: int, *,
                     ci: int = 0, hf: int = 3, wf: int = 3, stride: int = 1,
                     itemsize: int = 4) -> int:
    """Shared memory of one fused CTA.  ``ci > 0`` is the 3-stage kernel
    with ``ci`` raw input channels.

    Regions, each rounded up to 16 bytes: the fp32 DW output tile, stored
    channel-major with rows of ``FUSED_MAX_PIXELS + 4``; the fp32 PW weight
    chunk with rows of ``FUSED_MAX_CO``; then either the raw ``ci``-channel
    window (loaded once per CTA, transposed to fp32, rows padded to a
    multiple of 4 pixels), the fp32 expand-weight chunk ``(ci, cb)`` and the
    fp32 expanded window, or one ``cb`` chunk of the DW input window at the
    stream width.  The DW taps and bias live in registers; ``cob`` only
    bounds the panel the fixed-width rows hold.
    """
    if cob > FUSED_MAX_CO:
        raise ValueError(f"Co panel {cob} > {FUSED_MAX_CO}")
    hin = (slab_h - 1) * stride + hf
    win = (tile_w - 1) * stride + wf
    total = (_a(cb * (FUSED_MAX_PIXELS + 4) * ACC_BYTES)
             + _a(cb * FUSED_MAX_CO * ACC_BYTES))
    if ci:
        nwp = -(-hin * win // 4) * 4
        total += (_a(ci * nwp * ACC_BYTES) + _a(ci * cb * ACC_BYTES)
                  + _a(hin * win * cb * ACC_BYTES))
    else:
        total += _a(hin * win * cb * itemsize)
    return total


def tile_candidates(ho: int, wo: int) -> list[tuple[int, int]]:
    """Output tiles ``(slab_h, tile_w)``, largest first: up to 64 pixels,
    then halving rows and columns in turn down to one pixel."""
    tw = min(wo, 8)
    sh = min(ho, FUSED_MAX_PIXELS // tw)
    cands = [(sh, tw)]
    while (sh, tw) != (1, 1):
        if sh >= tw and sh > 1:
            sh = -(-sh // 2)
        else:
            tw = -(-tw // 2)
        cands.append((sh, tw))
    return cands


def _tile_plan(ho: int, wo: int, c: int, co: int, *, stride: int, hf: int,
               dtype: torch.dtype, smem_budget: int,
               smem) -> Optional[BlockPlan]:
    """The first fused tile that fits: the widest Co panel the kernel takes,
    then a chunk of at least 32 channels (or all of C), then the largest
    pixel tile, then the largest chunk.  ``smem(slab_h, tile_w, cb, cob)``
    is the kernel's shared-memory model."""
    cob = min(co, FUSED_MAX_CO)
    for min_cb in (min(c, 32), 1):
        for sh, tw in tile_candidates(ho, wo):
            cb = min(c, FUSED_MAX_CB)
            while cb >= min_cb and smem(sh, tw, cb, cob) > smem_budget:
                cb -= 1
            if cb < min_cb:
                continue
            n_slabs = -(-ho // sh)
            return BlockPlan(
                block_c=cb, block_co=cob, slab_h=sh, n_slabs=n_slabs,
                halo_rows=max(hf - stride, 0) if n_slabs > 1 else 0,
                smem_bytes=smem(sh, tw, cb, cob),
                dtype_bytes=dtype_bytes(dtype), tile_w=tw,
            )
    return None


def _fused_plan(ho: int, wo: int, ci: int, c: int, co: int, *, stride: int,
                hf: int, wf: int, dtype: torch.dtype, smem_budget: int
                ) -> Optional[BlockPlan]:
    nb = dtype_bytes(dtype)
    return _tile_plan(
        ho, wo, c, co, stride=stride, hf=hf, dtype=dtype,
        smem_budget=smem_budget,
        smem=lambda sh, tw, cb, cob: fused_smem_bytes(
            sh, tw, cb, cob, ci=ci, hf=hf, wf=wf, stride=stride,
            itemsize=nb))


def plan_separable(ho: int, wo: int, c: int, co: int, *, stride: int = 1,
                   hf: int = 3, wf: int = 3,
                   dtype: torch.dtype = torch.float32,
                   smem_budget: int = DEFAULT_SMEM_BUDGET,
                   residual: bool = False) -> Optional[BlockPlan]:
    """Tile plan for the 2-stage fused kernel (DW -> PW), or None when
    even a 1x1-pixel tile with a one-channel chunk exceeds the budget.

    Preference: the widest Co panel the kernel takes, then a channel chunk
    of at least 32 (or all of C), then the largest pixel tile, then the
    largest chunk that fits.  The residual streams straight from global
    memory into the epilogue and claims no shared memory.
    """
    return _fused_plan(ho, wo, 0, c, co, stride=stride, hf=hf, wf=wf,
                       dtype=dtype, smem_budget=smem_budget)


def plan_separable3(ho: int, wo: int, ci: int, c: int, co: int, *,
                    stride: int = 1, hf: int = 3, wf: int = 3,
                    dtype: torch.dtype = torch.float32,
                    smem_budget: int = DEFAULT_SMEM_BUDGET,
                    residual: bool = False) -> Optional[BlockPlan]:
    """Tile plan for the 3-stage fused kernel (expand -> DW -> project), or
    None when the raw ``ci``-channel window of even a 1x1-pixel tile does
    not fit (callers degrade to a standalone expand and the 2-stage plan).
    """
    return _fused_plan(ho, wo, ci, c, co, stride=stride, hf=hf, wf=wf,
                       dtype=dtype, smem_budget=smem_budget)


# ---------------------------------------------------------------------------
# fused MBConv (dense Hf x Wf conv -> act -> PW-project)
# ---------------------------------------------------------------------------

def fused_mb_smem_bytes(slab_h: int, tile_w: int, cb: int, cob: int, *,
                        ci: int, hf: int = 3, wf: int = 3,
                        stride: int = 1) -> int:
    """Shared memory of one fused-MBConv CTA (``mb_layout`` in
    ``csrc/fused_mbconv.cu``), each region rounded up to 16 bytes: the fp32
    conv-output chunk stored channel-major with rows of
    ``FUSED_MAX_PIXELS + 4``; the fp32 PW weight chunk with rows of
    ``FUSED_MAX_CO``; the raw ``(tile + halo) x ci`` window, transposed to
    fp32 with rows padded to a multiple of 4 pixels; and the fp32 filter
    chunk, ``hf * wf * ci`` rows of ``cb`` rounded up to 4.  Everything is
    staged in fp32, so the stream dtype does not enter."""
    if cob > FUSED_MAX_CO:
        raise ValueError(f"Co panel {cob} > {FUSED_MAX_CO}")
    hin = (slab_h - 1) * stride + hf
    win = (tile_w - 1) * stride + wf
    nwp = -(-hin * win // 4) * 4
    cbs = -(-cb // 4) * 4
    return (_a(cb * (FUSED_MAX_PIXELS + 4) * ACC_BYTES)
            + _a(cb * FUSED_MAX_CO * ACC_BYTES)
            + _a(ci * nwp * ACC_BYTES)
            + _a(hf * wf * ci * cbs * ACC_BYTES))


def plan_fused_mb(ho: int, wo: int, ci: int, c: int, co: int, *,
                  stride: int = 1, hf: int = 3, wf: int = 3,
                  dtype: torch.dtype = torch.float32,
                  smem_budget: int = DEFAULT_SMEM_BUDGET,
                  residual: bool = False) -> Optional[BlockPlan]:
    """Tile plan for the fused-MBConv kernel, or None when even a 1x1-pixel
    tile with a one-channel chunk exceeds the budget (the chain then
    degrades to ``mb`` + ``pw``).  ``ci`` is the raw-input width, ``c`` the
    conv-output (expanded) width, ``co`` the projected width.  Same
    preference order as :func:`plan_separable`; the residual claims no
    shared memory."""
    return _tile_plan(
        ho, wo, c, co, stride=stride, hf=hf, dtype=dtype,
        smem_budget=smem_budget,
        smem=lambda sh, tw, cb, cob: fused_mb_smem_bytes(
            sh, tw, cb, cob, ci=ci, hf=hf, wf=wf, stride=stride))


def plan_mb(ho: int, wo: int, ci: int, c: int, hf: int = 3, wf: int = 3, *,
            stride: int = 1, dtype: torch.dtype = torch.float32,
            smem_budget: int = DEFAULT_SMEM_BUDGET) -> BlockPlan:
    """Standalone dense conv (the fused-MBConv degradation target).  It runs
    the plain ``F.conv2d`` on every impl, as the reference runs XLA's conv,
    so it claims no kernel shared memory."""
    return BlockPlan(
        block_c=c, block_co=0, slab_h=ho, n_slabs=1, halo_rows=0,
        smem_bytes=0, dtype_bytes=dtype_bytes(dtype),
    )


# ---------------------------------------------------------------------------
# squeeze-excite: the DW + SE-epilogue pass, and the standalone SE
# ---------------------------------------------------------------------------

def dw_se_smem_bytes(ho: int, wo: int, c: int, c_se: int,
                     cluster: int) -> int:
    """Shared memory of one ``dw_se`` CTA (``dw_se_layout`` in
    ``csrc/dw_se.cu``) when ``cluster`` CTAs split the ``c`` channels of
    one image: the slice's fp32 DW output for the whole image, one float
    per thread for the pooling reduction, the slice's pooled means and
    gates, and the partial and summed hidden vectors of the gate."""
    cs = -(-c // cluster)
    return (_a(ho * wo * cs * ACC_BYTES) + _a(DW_SE_THREADS * ACC_BYTES)
            + 2 * _a(cs * ACC_BYTES) + 2 * _a(c_se * ACC_BYTES))


def plan_dw_se(hiu: int, wiu: int, ho: int, wo: int, c: int, c_se: int,
               hf: int = 3, wf: int = 3, *,
               dtype: torch.dtype = torch.float32,
               smem_budget: int = DEFAULT_SMEM_BUDGET
               ) -> Optional[BlockPlan]:
    """Cluster plan for the DW + SE-epilogue pass: the smallest cluster in
    :data:`DW_SE_CLUSTERS` whose per-CTA channel slice of the image's whole
    fp32 DW output fits the budget, or None when 8 CTAs cannot hold it
    (the chain then degrades to ``dw`` + ``se``).  There is no spatial
    ladder: the gate needs the pooled mean over the whole image, so a
    partial pool would be a wrong answer, not a slower one.  The input
    window is read from device memory, not staged."""
    for n in DW_SE_CLUSTERS:
        need = dw_se_smem_bytes(ho, wo, c, c_se, n)
        if need <= smem_budget:
            return BlockPlan(
                block_c=-(-c // n), block_co=0, slab_h=ho, n_slabs=1,
                halo_rows=0, smem_bytes=need, dtype_bytes=dtype_bytes(dtype),
                block_g=c_se, cluster=n)
    return None


def plan_se(b: int, c: int, c_se: int, *, dtype: torch.dtype = torch.float32,
            smem_budget: int = DEFAULT_SMEM_BUDGET) -> BlockPlan:
    """Standalone squeeze-excite: an fp32 mean, then the reduce and expand
    GEMMs through the ``pwconv`` kernel at ``G = b`` rows, then the sigmoid
    scale.  The claim is the larger GEMM tile; ``block_g`` carries
    ``c_se``."""
    p1 = plan_pwconv(b, c, c_se, dtype=dtype, smem_budget=smem_budget)
    p2 = plan_pwconv(b, c_se, c, dtype=dtype, smem_budget=smem_budget)
    return BlockPlan(
        block_c=c, block_co=0, slab_h=1, n_slabs=1, halo_rows=0,
        smem_bytes=max(p1.smem_bytes, p2.smem_bytes),
        dtype_bytes=dtype_bytes(dtype), block_g=c_se,
    )


# ---------------------------------------------------------------------------
# pwconv (tiled GEMM)
# ---------------------------------------------------------------------------

def pwconv_smem_bytes(bg: int, bci: int, bco: int) -> int:
    """fp32 A tile (rows padded by one against bank conflicts) and B tile
    of one K step."""
    return (bg * (bci + 1) + bci * bco) * ACC_BYTES


def plan_pwconv(g: int, ci: int, co: int, *,
                dtype: torch.dtype = torch.float32,
                smem_budget: int = DEFAULT_SMEM_BUDGET) -> BlockPlan:
    """The GEMM tile: 64 x 64 outputs by a K step of 16 (4 x 4 register
    micro-tile per thread).  Larger compiled tiles are reachable through
    ``KernelPolicy.block_g/co/ci``."""
    bg, bco, bci = 64, 64, 16
    return BlockPlan(
        block_c=bci, block_co=bco, slab_h=0, n_slabs=1, halo_rows=0,
        smem_bytes=pwconv_smem_bytes(bg, bci, bco),
        dtype_bytes=dtype_bytes(dtype), block_g=bg,
    )


# ---------------------------------------------------------------------------
# whole-chain plan schema (core/chain.plan -> kernels/lowering.lower)
# ---------------------------------------------------------------------------

#: Segment kinds of the reference's schema.  ``fused3`` / ``fused2`` run
#: ``separable_fused``, ``fusedmb`` runs ``fused_mbconv``, ``dw_se`` runs
#: ``dw_se``, ``pw`` / ``dw`` the standalone kernels; ``se`` is a mean,
#: two ``pwconv`` launches and a scale, and ``mb`` the plain dense conv.
SEGMENT_KINDS = ("fused3", "fused2", "fusedmb", "dw_se", "pw", "dw", "se",
                 "mb")

#: Segment kinds whose kernels take a residual operand.
FUSED_KINDS = ("fused3", "fused2", "fusedmb")


@dataclasses.dataclass(frozen=True)
class ChainSegment:
    """Which contiguous spec stages run as one kernel pass, at which
    blocks."""
    kind: str
    stages: tuple[int, ...]
    plan: BlockPlan

    def __post_init__(self):
        if self.kind not in SEGMENT_KINDS:
            raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """The planner's answer for one declared stage chain.

    ``residual``: the spec's residual is active at these shapes.
    ``residual_fused``: it rides in the final fused kernel's store;
    otherwise the lowering adds it as a separate op.
    """
    segments: tuple[ChainSegment, ...]
    residual: bool
    residual_fused: bool
    dtype_bytes: int
    smem_budget: int

    @property
    def n_kernel_passes(self) -> int:
        n = sum(2 if s.kind == "se" else 1 for s in self.segments)
        return n + (1 if self.residual and not self.residual_fused else 0)

    @property
    def fully_fused(self) -> bool:
        return len(self.segments) == 1 and self.segments[0].kind in (
            FUSED_KINDS) and (self.residual_fused or not self.residual)
