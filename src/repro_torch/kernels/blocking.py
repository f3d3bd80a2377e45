"""Block planner for the Hopper kernels, and the chain-plan schema.

Counterpart of ``repro/kernels/blocking.py``.  The schema (``BlockPlan``,
``ChainSegment``, ``ChainPlan``, the segment kinds) is the reference's; the
budget is re-aimed from a TPU core's VMEM (12 MiB, 128-lane snapping) at
ONE CTA of an H100: at most 227 KB (232,448 B) of dynamic shared memory.

The fused separable kernel (``csrc/separable_fused.cu``) gives a CTA
``slab_h`` full-width output rows of one image and a slice of the DW
channels; a thread-block cluster of up to :data:`SEP_MAX_CLUSTER` CTAs
splits C, so each expand and DW value is computed once per slab and
neighbouring slabs share only the window's halo rows (the whole image is
one slab at the 14x14 and 7x7 stages).  :func:`plan_separable_fused` picks
the slab, the cluster (enough CTAs to fill :data:`SMS`), the chunk of the
slice staged at once and the Co panel, from the kernel's shared-memory
model (:func:`separable_smem_bytes`, the kernel's ``sep_layout``); the
kernel refuses a launch whose layout exceeds the budget, so a drift fails
loudly.  :func:`separable_macs` counts a launch's multiply-adds.

The fused-MBConv kernel (``csrc/fused_mbconv.cu``) has the same shape with
the dense conv (an implicit GEMM) in place of expand + DW: full-width slabs,
a C-splitting cluster, chunks of the slice's filter staged double-buffered
(:func:`plan_fused_mb`, :func:`fused_mb_smem_bytes`).

The DW + squeeze-excite kernel (``csrc/dw_se.cu``) spreads each image over
many CTAs in two passes over ``dwconv2d``'s tiles (a pooling pass, then a
scaling pass that computes the DW again); :func:`plan_dw_se` decides the
segment by the reference's rule and takes the tile from
:func:`plan_dw_se_tile`, ``dwconv2d``'s search in an order of its own.

``dwconv2d`` stages a padded input tile per CTA and slides a register window
along runs of outputs (:func:`plan_dwconv2d`).  ``pwconv`` has three variants
(``csrc/pwconv.cu``), chosen by :func:`plan_pwconv` from the shape alone:
``stream`` for G <= :data:`PW_STREAM_MAX_G` rows (a weight-streaming tile,
Ci split over a cluster), ``tc`` for 16-bit operands whose rows TMA can
describe (wgmma tiles), ``simt`` for the rest (fp32 register tiles).  Each
variant's tiles are in :data:`PW_TILES`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

#: Dynamic shared memory one CTA may use on Hopper (227 KB).
DEFAULT_SMEM_BUDGET = 232_448

#: Accumulators and fused intermediates are fp32.
ACC_BYTES = 4

#: Largest conv-output channel chunk a ``fused_mbconv`` CTA stages at once.
FUSED_MAX_CB = 256

#: ``separable_fused`` (``csrc/separable_fused.cuh``): most output pixels a
#: slab holds, largest cluster splitting C (the largest portable one),
#: widest Co panel, and the fewest CTAs a launch gets where the image
#: allows it.
SEP_MAX_PIXELS = 256
SEP_MAX_CLUSTER = 8
SEP_MAX_PANEL = 256
SEP_MIN_CTAS = 64
#: Most expand multiply-adds a 3-stage plan does over its minimum (every
#: input pixel once) where a plan within it exists; shared memory a CTA may
#: hold for two to share an SM.
SEP_MAX_EXPAND = 2.0
SEP_TWO_CTAS = DEFAULT_SMEM_BUDGET // 2 - 1024

#: ``dwconv2d`` (``csrc/dwconv2d.cu``): the square filters with a compiled
#: path (any other runs the runtime-K path), the largest of them, output
#: columns a thread computes from one sliding register window, the widest
#: tile row, most 16-byte channel vectors and threads a CTA takes, and the
#: most shared memory a tile holds (several CTAs share an SM).
DW_TAPS = (3, 5, 7)
DW_MAX_TAPS = DW_TAPS[-1]
DW_RUN = 4
DW_MAX_TILE_W = 16
DW_MAX_VECS = 8
DW_THREADS = 256
DW_TILE_SMEM = 48 * 1024

#: SMs of an H100 SXM: the planner sizes grids to fill them.
SMS = 132

#: pwconv's variants (``csrc/pwconv.cu``), in the kernel's code order.
PW_VARIANTS = ("stream", "tc", "simt")
#: Largest G the ``stream`` variant takes, by stream dtype.  Decode (G =
#: batch) and the SE gate FCs (G = batch) sit below both.  Set on the card
#: by ``bench_pwconv.py --tune`` (``stream`` forced against the wide
#: variant, CUDA-graph timed; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
#: in fp32 ``stream`` beat ``simt`` at every G up to 64 (768->3072: 29.5
#: against 42.1 us at G = 64, 42.3 against 42.1 at G = 96; 1024->1024:
#: 22.2 against 55.2 at G = 64), so the CNN 7x7 stages at batch 1 (G = 49)
#: stream in fp32.  In bf16 ``tc`` was as fast or faster from G = 8 up
#: (768->3072: 6.8 against 9.3 us at G = 8; 1536->1536: 9.3 against 9.5),
#: so 16-bit streams only decode's G <= 16.
PW_STREAM_MAX_G = {torch.float32: 64, torch.bfloat16: 16, torch.float16: 16}
#: Compiled tiles of each variant, ``(block_g, block_co, block_ci)``.
#: ``stream``: ``block_g`` rows of G a CTA holds (a ``block_g`` x vector
#: sum tile a thread, at most 64 fp32 sums), ``block_co`` columns a CTA
#: owns (``block_co`` / vector a power of two <= 32 threads); ``block_ci``
#: is the Ci rows of each CTA of the split-K cluster, any size that needs
#: at most 8 CTAs, so it is ``None`` here.  ``tc``: M x N tile by a K step
#: of 64.  ``simt``: M x N tile by a K step of 8.
PW_TILES = {
    "stream": tuple((g, co, None) for g in (1, 2, 4, 8, 16)
                    for co in (32, 64, 128, 256)),
    "tc": ((128, 128, 64), (128, 64, 64), (64, 128, 64), (64, 64, 64)),
    "simt": ((128, 128, 8), (128, 64, 8), (64, 128, 8), (64, 64, 8)),
}
#: Deepest ring of the ``tc`` variant (no deeper than Ci's K steps) and the
#: alignment its 128-byte swizzle needs; Ci rows of x a ``stream`` CTA
#: stages at a time.
PW_TC_STAGES = 4
PW_TC_ALIGN = 1024
PW_STREAM_CHUNK = 256
PW_STREAM_WARPS = 8
#: Largest split-K cluster of ``stream`` (the largest portable cluster).
PW_STREAM_MAX_CLUSTER = 8

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

    * ``dwconv2d``        — ``slab_h x tile_w`` output pixels by ``block_c``
      channels a CTA, ``block_g`` channels a thread (``variant`` "vector"
      or "scalar"); ``ctas`` per image.
    * ``separable_fused`` — ``slab_h`` full-width output rows (``tile_w``
      = Wo) per CTA, ``cluster`` CTAs splitting the DW channels into
      slices of ``block_g``, ``block_c`` the chunk of a slice staged at
      once, ``block_co`` the Co panel; ``ctas`` the launch's CTA count.
    * ``pwconv``          — ``variant``, ``block_g``, ``block_co``,
      ``block_c`` (the K step; for ``stream`` the Ci rows of each of the
      ``cluster`` CTAs that split Ci).
    * ``fused_mbconv``    — as ``separable_fused``; ``block_c`` chunks the
      conv output.
    * ``dw_se``           — as ``dwconv2d``; ``ctas`` per pass of the
      launch (all images), ``smem_bytes`` the pooling pass's,
      ``workspace_bytes`` the fp32 shares of the reduce FC.
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
    variant: str = ""
    ctas: int = 0
    workspace_bytes: int = 0


# ---------------------------------------------------------------------------
# dwconv2d
# ---------------------------------------------------------------------------

def dw_vector(c: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Channels a ``dwconv2d`` thread takes at once: one 16-byte vector (4
    fp32, 8 bf16 or fp16) where C's rows are whole vectors on 16-byte
    aligned bases, else one channel."""
    v = 16 // dtype_bytes(dtype)
    return v if aligned and c % v == 0 else 1


def dw_compiled(hf: int, wf: int, stride: int) -> bool:
    """Whether ``dwconv2d`` has a compiled path (taps of a row in registers,
    a sliding register window) for this filter and stride; every other
    filter takes the runtime-K path, which reads its taps from shared
    memory."""
    return hf == wf and hf in DW_TAPS and stride in (1, 2)


def dwconv2d_smem_bytes(tile_h: int, tile_w: int, cg: int, hf: int, wf: int,
                        stride: int, dtype: torch.dtype) -> int:
    """Shared memory of one ``dwconv2d`` CTA (``dw_layout`` in
    ``csrc/dwconv2d.cu``): the padded input tile of ``cg`` channels at the
    stream width, ``(tile_h - 1) * stride + hf`` rows by ``(tile_w - 1) *
    stride + wf`` columns, and the fp32 taps of those channels."""
    hw = (tile_h - 1) * stride + hf
    ww = (tile_w - 1) * stride + wf
    return _a(hw * ww * cg * dtype_bytes(dtype)) + _a(hf * wf * cg * ACC_BYTES)


def dw_threads(tile_h: int, tile_w: int, cg: int, vec: int) -> int:
    """Threads of a ``dwconv2d`` CTA: one per channel vector and run of
    :data:`DW_RUN` output columns of each tile row."""
    return cg // vec * tile_h * -(-tile_w // DW_RUN)


def plan_dwconv2d(hi: int, wi: int, ho: int, wo: int, c: int,
                  hf: int = 3, wf: int = 3, *, stride: int = 1,
                  dtype: torch.dtype = torch.float32,
                  aligned: bool = True) -> BlockPlan:
    """The ``dwconv2d`` CTA tile: ``slab_h x tile_w`` output pixels by
    ``block_c`` channels, ``block_g`` channels a thread (``variant``
    "vector" for 16-byte vectors, "scalar" for one channel).

    Among tiles of whole runs of :data:`DW_RUN` columns (at most
    :data:`DW_MAX_TILE_W`), any number of rows and up to
    :data:`DW_MAX_VECS` channel vectors (32 scalar channels) in at most
    :data:`DW_THREADS` threads whose staged input fits :data:`DW_TILE_SMEM`,
    the planner takes, in order: at least a quarter of :data:`DW_THREADS`
    threads with work; channel groups with work for at least 3/4 of their
    lanes (a last group of mostly idle threads stages zeros: on the card a
    64-channel group of a 72-channel bf16 layer took 1.5-1.8x the best
    tile); the most channels (a warp's copies then cover whole rows of C);
    the most threads with work; the fewest staged input pixels per output
    (the halo).  The limits were read off ``bench_conv.py --kernel dwconv2d
    --tune`` on the card (PERF.md): at the 3x3 shapes the pick is within
    1.04x of the best tile timed, over all ten shapes a median 1.21x (the
    9x9 and 11x11 filters want taller tiles of fewer channels).  ``hi x wi``
    (the input before padding) does not enter: the kernel zero-fills what
    lies outside it.  Nor does a chain's shared-memory budget (which it
    may shrink to force the fused kernels to degrade): ``dwconv2d`` is what
    they degrade to."""
    ladder = dwconv2d_ladder(ho, wo, c, hf, wf, stride=stride, dtype=dtype,
                             aligned=aligned)
    if not ladder:
        raise ValueError(f"no dwconv2d tile of a {hf}x{wf} filter fits "
                         f"{DW_TILE_SMEM} B of shared memory")
    return ladder[0]


@functools.lru_cache(maxsize=4096)
def dwconv2d_ladder(ho: int, wo: int, c: int, hf: int = 3, wf: int = 3, *,
                    stride: int = 1, dtype: torch.dtype = torch.float32,
                    aligned: bool = True) -> tuple:
    """Every tile of :func:`plan_dwconv2d`'s search, as plans, in its
    preference order (its plan first).  The autotuner's ``dw`` ladder and
    ``bench_conv.py --kernel dwconv2d --tune``'s candidates."""
    return tuple(_dw_plan(ho, wo, c, hf, stride, dtype, *t) for t in
                 _dw_tiles(ho, wo, c, hf, wf, stride, dtype, aligned,
                           DW_TILE_SMEM))


def _dw_key(t: dict) -> tuple:
    """:func:`plan_dwconv2d`'s preference order (see its docstring)."""
    return (t["busy"] < DW_THREADS // 4, t["used"] < 0.75, -t["nv"],
            -t["busy"], t["halo"])


@functools.lru_cache(maxsize=4096)
def _dw_tiles(ho: int, wo: int, c: int, hf: int, wf: int, stride: int,
              dtype: torch.dtype, aligned: bool, limit: int, batch: int = 1,
              key=_dw_key, max_tile_w: int = 0) -> tuple:
    """The tile search of :func:`plan_dwconv2d` and :func:`plan_dw_se_tile`:
    ``(vec, nv, tile_w, tile_h, smem)`` of every tile whose shared memory
    fits ``limit``, least ``key`` first (ties in search order).  ``key``
    sees each tile's ``nv``, ``cg`` (its channels), ``threads``, ``busy``
    (threads with work), ``used`` (channel lanes with work), ``halo``
    (staged input pixels per output), ``ctas`` (of ``batch`` images) and
    ``floor`` (:data:`SEP_MIN_CTAS`, or as many as the work allows).  Tiles
    are at most ``max_tile_w`` columns wide (default: no wider than the
    output needs)."""
    vec = dw_vector(c, dtype, aligned)
    nvec = -(-c // vec)
    floor = min(SEP_MIN_CTAS, batch * ho * -(-wo // DW_RUN) * nvec)
    ranked = []
    for nv in range(1, min(nvec, DW_MAX_VECS if vec > 1 else 32) + 1):
        used = nvec / (-(-nvec // nv) * nv)  # channel lanes that have work
        for tw in range(DW_RUN, (max_tile_w or min(_up(wo, DW_RUN),
                                                    DW_MAX_TILE_W)) + 1,
                        DW_RUN):
            for th in range(1, min(ho, DW_THREADS // (nv * (tw // DW_RUN)))
                            + 1):
                smem = dwconv2d_smem_bytes(th, tw, nv * vec, hf, wf, stride,
                                           dtype)
                if smem > limit:
                    continue
                busy = nv * th * -(-min(tw, wo) // DW_RUN)
                halo = (((th - 1) * stride + hf) * ((tw - 1) * stride + wf)
                        / (th * min(tw, wo)))
                k = key({"nv": nv, "cg": nv * vec, "busy": busy,
                         "threads": nv * th * (tw // DW_RUN), "used": used,
                         "halo": halo, "floor": floor,
                         "ctas": batch * -(-ho // th) * -(-wo // tw)
                         * -(-nvec // nv)})
                ranked.append((k, (vec, nv, tw, th, smem)))
    ranked.sort(key=lambda r: r[0])
    return tuple(t for _, t in ranked)


def _dw_plan(ho, wo, c, hf, stride, dtype, vec, nv, tw, th, smem,
             batch: int = 1, **fields) -> BlockPlan:
    n_slabs = -(-ho // th)
    return BlockPlan(
        block_c=nv * vec, block_co=0, slab_h=th, n_slabs=n_slabs,
        halo_rows=max(hf - stride, 0) if n_slabs > 1 else 0,
        smem_bytes=smem, dtype_bytes=dtype_bytes(dtype), block_g=vec,
        tile_w=tw, variant="vector" if vec > 1 else "scalar",
        ctas=batch * n_slabs * -(-wo // tw) * -(-c // (nv * vec)), **fields)


# ---------------------------------------------------------------------------
# fused separable block ([PW-expand ->] DW -> PW), csrc/separable_fused.cu
# ---------------------------------------------------------------------------

def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def separable_slice(c: int, cluster: int) -> int:
    """DW channels each CTA of a ``cluster`` owns: ``ceil(C / cluster)``,
    rounded up to 8 once it is 8 or more (so slices start on 16-byte
    boundaries of the channel rows)."""
    cs = -(-c // cluster)
    return _up(cs, 8) if cs >= 8 else cs


def separable_smem_bytes(*, ci: int, c_slice: int, cb: int, panel: int,
                         cluster: int, slab_h: int, wo: int, hi: int,
                         wi: int, hf: int = 3, wf: int = 3, stride: int = 1,
                         tc: bool = False) -> int:
    """Shared memory of one ``separable_fused`` CTA (``sep_layout`` in
    ``csrc/separable_fused.cu``), each region rounded up to 16 bytes.

    ``ci > 0`` is the 3-stage kernel.  ``hi x wi`` is the input the kernel
    reads (before any SAME padding it applies itself): the raw window of a
    slab holds at most ``min(window rows, hi) x min(window cols, wi)`` real
    pixels.  Regions: the DW tile of the CTA's ``c_slice`` channels for the
    slab's ``slab_h x wo`` pixels and the window index of each real pixel,
    resident through both phases; then the
    larger of phase A (the fp32 window of one ``cb`` chunk, channel-major,
    and in 3-stage the raw window and the expand-weight chunk) and phase B
    (one ``panel`` of the project weights, its fp32 bias and the fp32
    partial output tile the cluster sums; a cluster of one sums its own).  ``tc`` (bf16) keeps the
    tensor-core operands: 16-bit rows padded to 16 in K plus 8, the DW tile
    as a bf16 hi and lo pair, pixel rows padded to 16, the weights K-major
    in rows of their width rounded up to 8, plus 8; otherwise every
    operand is fp32, pixel rows padded to 8.
    """
    p = slab_h * wo
    hwin = (slab_h - 1) * stride + hf
    wwin = (wo - 1) * stride + wf
    rp = min(hwin, hi) * min(wwin, wi)
    wmap = _a(rp * 4)
    phase_a = (_a(cb * hwin * wwin * ACC_BYTES)
               + _a(hf * wf * _up(cb, 8) * ACC_BYTES) + _a(_up(cb, 8) * ACC_BYTES))
    if tc:
        sk, sa, pm = _up(ci, 16) + 8, _up(c_slice, 16) + 8, _up(p, 16)
        dw = 2 * _a(pm * sa * 2)
        if ci:
            phase_a += (_a(_up(rp, 16) * sk * 2)
                        + _a(_up(ci, 16) * (_up(cb, 8) + 8) * 2))
        phase_b = _a(_up(c_slice, 16) * (panel + 8) * 2)
    else:
        pm = _up(p, 8)
        dw = _a(c_slice * pm * ACC_BYTES)
        if ci:
            phase_a += (_a(ci * _up(rp, 8) * ACC_BYTES)
                        + _a(ci * _up(cb, 8) * ACC_BYTES))
        phase_b = _a(c_slice * panel * ACC_BYTES)
    phase_b += _a(panel * ACC_BYTES) + _a(pm * panel * ACC_BYTES)
    return dw + wmap + max(phase_a, phase_b)


def separable_macs(batch: int, ho: int, wo: int, hi: int, wi: int, ci: int,
                   c: int, co: int, *, stride: int, hf: int, wf: int,
                   slab_h: int, pad_t: int = 0, pad_l: int = 0) -> dict:
    """Multiply-adds one launch does, by stage, and the expand's minimum
    (every input pixel expanded once, ``B*H*W*Ci*C``).  The kernel expands
    the real pixels of each slab's window (the zero SAME padding is never
    expanded: the expand is bias-free and every activation maps 0 to 0), so
    the expand repeats only the halo rows shared by neighbouring slabs."""
    rows = 0
    for oh0 in range(0, ho, slab_h):
        hwin = (min(slab_h, ho - oh0) - 1) * stride + hf
        r0 = oh0 * stride - pad_t
        rows += max(0, min(hi, r0 + hwin) - max(0, r0))
    wwin = (wo - 1) * stride + wf
    cols = max(0, min(wi, wwin - pad_l) - max(0, -pad_l))
    return {"expand": batch * rows * cols * ci * c,
            "expand_min": batch * hi * wi * ci * c,
            "dw": batch * ho * wo * c * hf * wf,
            "pw": batch * ho * wo * c * co}


def _halvings(n: int, floor: int = 1):
    """n, ceil(n / 2), ... down to ``floor``; multiples of 8 kept so."""
    out = [n]
    while n > floor:
        n = -(-n // 2)
        if n >= 8:
            n = _up(n, 8)
        if n >= out[-1]:
            n = out[-1] - 1
        out.append(max(n, floor))
    return out


def plan_separable_fused(ho: int, wo: int, ci: int, c: int, co: int, *,
                         stride: int = 1, hf: int = 3, wf: int = 3,
                         dtype: torch.dtype = torch.float32,
                         smem_budget: int = DEFAULT_SMEM_BUDGET,
                         batch: int = 1, hi: Optional[int] = None,
                         wi: Optional[int] = None) -> Optional[BlockPlan]:
    """The plan of one ``separable_fused`` launch (``ci = 0``: 2-stage), or
    None when even one output row with the largest cluster, a one-channel
    chunk and an 8-wide panel exceeds ``smem_budget``.

    A CTA owns ``slab_h`` full-width output rows of one image and a slice
    of the DW channels; a cluster of ``cluster`` CTAs splits C, so the
    expand and the DW run once per slab, and the partial projections are
    summed across the cluster.  Among the slab heights (balanced over the
    image), clusters of 1-8 and Co panels, each with the largest chunk that
    fits the budget, the planner prefers, in order: plans that put at least
    :data:`SEP_MIN_CTAS` CTAs on the card; where whole-image slabs with the
    largest cluster already do, an expand within :data:`SEP_MAX_EXPAND` of
    its minimum (with fewer images, repeating the halo's expand on SMs
    that would otherwise idle is the cheaper way to fill the card); two
    CTAs an SM; a CTA count nearest :data:`SMS` (a CTA's loads and barriers
    cost more than the SMs a second wave would add); the fewest chunks;
    the widest panel.  The order was read off ``bench_separable_fused.py
    --tune`` on the card (PERF.md).  ``hi x wi`` is the input the kernel
    reads (default: the VALID window of the output).
    """
    ladder = separable_fused_ladder(
        ho, wo, ci, c, co, stride=stride, hf=hf, wf=wf, dtype=dtype,
        smem_budget=smem_budget, batch=batch, hi=hi, wi=wi)
    return ladder[0] if ladder else None


@functools.lru_cache(maxsize=4096)
def separable_fused_ladder(ho: int, wo: int, ci: int, c: int, co: int, *,
                           stride: int = 1, hf: int = 3, wf: int = 3,
                           dtype: torch.dtype = torch.float32,
                           smem_budget: int = DEFAULT_SMEM_BUDGET,
                           batch: int = 1, hi: Optional[int] = None,
                           wi: Optional[int] = None) -> tuple:
    """Every plan of :func:`plan_separable_fused`'s search (slab height x
    cluster x Co panel, each through :func:`separable_plan_at`), in its
    preference order (its plan first, ties in search order).  The
    autotuner's ``fused2`` / ``fused3`` ladder and
    ``bench_separable_fused.py --tune``'s candidates."""
    hi = hi or (ho - 1) * stride + hf
    wi = wi or (wo - 1) * stride + wf
    most = batch * ho * SEP_MAX_CLUSTER  # one-row slabs, the largest cluster
    floor, target = min(SEP_MIN_CTAS, most), min(SMS, most)
    ranked: dict = {}
    for sh in sorted({-(-ho // -(-ho // h)) for h in _halvings(
            max(1, min(ho, SEP_MAX_PIXELS // wo)))}, reverse=True):
        excess = False
        if ci and batch * SEP_MAX_CLUSTER >= SEP_MIN_CTAS:
            m = separable_macs(batch, ho, wo, hi, wi, ci, c, co,
                               stride=stride, hf=hf, wf=wf, slab_h=sh)
            excess = m["expand"] > SEP_MAX_EXPAND * m["expand_min"]
        for n in (1, 2, 4, 8):
            for panel in _halvings(separable_panel(sh * wo, co), 8):
                p = separable_plan_at(
                    ho, wo, ci, c, co, slab_h=sh, cluster=n, panel=panel,
                    stride=stride, hf=hf, wf=wf, dtype=dtype,
                    smem_budget=smem_budget, batch=batch, hi=hi, wi=wi)
                if p is not None:
                    ranked.setdefault(p, (
                        p.ctas < floor, excess, p.smem_bytes > SEP_TWO_CTAS,
                        abs(math.log(p.ctas / target)),
                        -(-p.block_g // p.block_c), -p.block_co))
    return tuple(sorted(ranked, key=ranked.__getitem__))


def separable_panel(pixels: int, co: int) -> int:
    """The widest Co panel: whole 8-column register tiles, at most 256
    threads' worth of tiles beside ``pixels`` rows (and at most
    :data:`SEP_MAX_PANEL`), balanced over Co."""
    npmax = min(SEP_MAX_PANEL, 8 * max(1, 256 // -(-pixels // 8)))
    return _up(-(-co // -(-co // npmax)), 8)


def separable_plan_at(ho: int, wo: int, ci: int, c: int, co: int, *,
                      slab_h: int, cluster: int, panel: int,
                      stride: int = 1, hf: int = 3, wf: int = 3,
                      dtype: torch.dtype = torch.float32,
                      smem_budget: int = DEFAULT_SMEM_BUDGET,
                      batch: int = 1, hi: Optional[int] = None,
                      wi: Optional[int] = None,
                      min_cb: int = 1) -> Optional[BlockPlan]:
    """The plan at this slab, cluster and panel with the largest chunk (at
    least ``min_cb``) that fits ``smem_budget``, or None."""
    hi = hi or (ho - 1) * stride + hf
    wi = wi or (wo - 1) * stride + wf
    cs = separable_slice(c, cluster)
    n = -(-c // cs)
    n_slabs = -(-ho // slab_h)
    for cb in _halvings(cs):
        if cb < min_cb:
            break
        need = separable_smem_bytes(
            ci=ci, c_slice=cs, cb=cb, panel=panel, cluster=n, slab_h=slab_h,
            wo=wo, hi=hi, wi=wi, hf=hf, wf=wf, stride=stride,
            tc=dtype == torch.bfloat16)
        if need <= smem_budget:
            return BlockPlan(
                block_c=cb, block_co=panel, slab_h=slab_h, n_slabs=n_slabs,
                halo_rows=max(hf - stride, 0) if n_slabs > 1 else 0,
                smem_bytes=need, dtype_bytes=dtype_bytes(dtype), tile_w=wo,
                cluster=n, block_g=cs, ctas=batch * n_slabs * n)
    return None


def plan_separable(ho: int, wo: int, c: int, co: int, *, stride: int = 1,
                   hf: int = 3, wf: int = 3,
                   dtype: torch.dtype = torch.float32,
                   smem_budget: int = DEFAULT_SMEM_BUDGET,
                   residual: bool = False, batch: int = 1,
                   hi: Optional[int] = None,
                   wi: Optional[int] = None) -> Optional[BlockPlan]:
    """Plan of the 2-stage fused kernel (DW -> PW), or None when nothing
    fits (:func:`plan_separable_fused`).  The residual streams from device
    memory into the epilogue and claims no shared memory."""
    return plan_separable_fused(ho, wo, 0, c, co, stride=stride, hf=hf,
                                wf=wf, dtype=dtype, smem_budget=smem_budget,
                                batch=batch, hi=hi, wi=wi)


def plan_separable3(ho: int, wo: int, ci: int, c: int, co: int, *,
                    stride: int = 1, hf: int = 3, wf: int = 3,
                    dtype: torch.dtype = torch.float32,
                    smem_budget: int = DEFAULT_SMEM_BUDGET,
                    residual: bool = False, batch: int = 1,
                    hi: Optional[int] = None,
                    wi: Optional[int] = None) -> Optional[BlockPlan]:
    """Plan of the 3-stage fused kernel (expand -> DW -> project), or None
    when the raw ``ci``-channel window of even one output row does not fit
    (callers degrade to a standalone expand and the 2-stage plan)."""
    return plan_separable_fused(ho, wo, ci, c, co, stride=stride, hf=hf,
                                wf=wf, dtype=dtype, smem_budget=smem_budget,
                                batch=batch, hi=hi, wi=wi)

# ---------------------------------------------------------------------------
# fused MBConv (dense Hf x Wf conv -> act -> PW-project), csrc/fused_mbconv.cu
# ---------------------------------------------------------------------------

def fused_mb_smem_bytes(*, ci: int, c_slice: int, cb: int, panel: int,
                        slab_h: int, tile_w: int, hf: int = 3, wf: int = 3,
                        stride: int = 1, tc: bool = False) -> int:
    """Shared memory of one ``fused_mbconv`` CTA (``mb_layout`` in
    ``csrc/fused_mbconv.cu``), each region rounded up to 16 bytes.

    The resident tile of the CTA's ``c_slice`` conv-output channels for
    its ``slab_h x tile_w`` pixels, through both phases; then the larger
    of phase A (the tile's padded input window, pixel-major, and one
    filter chunk of ``hf * wf * Ci`` rows by ``cb`` columns, two where the
    slice has more than one chunk, so the next chunk's copy overlaps the
    product) and phase B (one ``panel`` of the project weights, its fp32
    bias and the fp32 partial output tile the cluster sums).  ``tc`` (bf16)
    keeps 16-bit operands: the tile as a hi and lo pair with pixel rows
    padded to 16 and K rows of the slice rounded up to 16 plus 8, Ci padded
    to 16 plus 8 a window pixel, filter rows of ``cb`` rounded up to 8 plus
    8; otherwise every operand is fp32, pixel rows padded to 8, Ci padded
    to 4 and then to an odd number of 16-byte columns a window pixel, filter
    rows of ``cb`` rounded up to 8."""
    p = slab_h * tile_w
    hwin = (slab_h - 1) * stride + hf
    wwin = (tile_w - 1) * stride + wf
    nbuf = 2 if -(-c_slice // cb) > 1 else 1
    if tc:
        pm, cip = _up(p, 16), _up(ci, 16)
        tile = 2 * _a(pm * (_up(c_slice, 16) + 8) * 2)
        phase_a = (_a(hwin * wwin * (cip + 8) * 2)
                   + nbuf * _a(hf * wf * cip * (_up(cb, 8) + 8) * 2))
        phase_b = _a(_up(c_slice, 16) * (panel + 8) * 2)
    else:
        pm, cip = _up(p, 8), _up(ci, 4)
        tile = _a(c_slice * pm * ACC_BYTES)
        phase_a = (_a(hwin * wwin * (cip // 4 | 1) * 4 * ACC_BYTES)
                   + nbuf * _a(hf * wf * cip * _up(cb, 8) * ACC_BYTES))
        phase_b = _a(c_slice * panel * ACC_BYTES)
    phase_b += _a(panel * ACC_BYTES) + _a(pm * panel * ACC_BYTES)
    return tile + max(phase_a, phase_b)


def fused_mb_plan_at(ho: int, wo: int, ci: int, c: int, co: int, *,
                     slab_h: int, cluster: int, panel: int,
                     tile_w: Optional[int] = None, stride: int = 1,
                     hf: int = 3, wf: int = 3,
                     dtype: torch.dtype = torch.float32,
                     smem_budget: int = DEFAULT_SMEM_BUDGET, batch: int = 1,
                     min_cb: int = 1) -> Optional[BlockPlan]:
    """The ``fused_mbconv`` plan at this tile (``tile_w`` default: full
    width), cluster and panel with the largest chunk (at least ``min_cb``,
    at most :data:`FUSED_MAX_CB`) that fits ``smem_budget``, or None."""
    tile_w = tile_w or wo
    cs = separable_slice(c, cluster)
    n = -(-c // cs)
    n_slabs = -(-ho // slab_h)
    tiles = n_slabs * -(-wo // tile_w)
    for cb in _halvings(min(cs, FUSED_MAX_CB)):
        if cb < min_cb:
            break
        need = fused_mb_smem_bytes(
            ci=ci, c_slice=cs, cb=cb, panel=panel, slab_h=slab_h,
            tile_w=tile_w, hf=hf, wf=wf, stride=stride,
            tc=dtype == torch.bfloat16)
        if need <= smem_budget:
            return BlockPlan(
                block_c=cb, block_co=panel, slab_h=slab_h, n_slabs=n_slabs,
                halo_rows=max(hf - stride, 0) if n_slabs > 1 else 0,
                smem_bytes=need, dtype_bytes=dtype_bytes(dtype),
                tile_w=tile_w, cluster=n, block_g=cs,
                ctas=batch * tiles * n)
    return None


def plan_fused_mb(ho: int, wo: int, ci: int, c: int, co: int, *,
                  stride: int = 1, hf: int = 3, wf: int = 3,
                  dtype: torch.dtype = torch.float32,
                  smem_budget: int = DEFAULT_SMEM_BUDGET,
                  residual: bool = False,
                  batch: int = 1) -> Optional[BlockPlan]:
    """The plan of one ``fused_mbconv`` launch, or None when even one output
    row with the largest cluster, a one-channel chunk and an 8-wide panel
    exceeds ``smem_budget`` (the chain then degrades to ``mb`` + ``pw``).
    ``ci`` is the raw-input width, ``c`` the conv-output (expanded) width,
    ``co`` the projected width.

    A CTA owns a tile of ``slab_h`` output rows by ``tile_w`` columns of
    one image and a slice of the conv channels; a cluster of ``cluster``
    CTAs splits C, so each conv value is computed once, and the partial
    projections are summed across the cluster.  Tiles span the full width
    (``tile_w = wo``) wherever one fits; narrower ones (halving the width)
    only where a full-width window of Ci channels does not.  Among the slab
    heights (balanced over the image), clusters of 1-8 and Co panels, each
    with the largest chunk that fits, the planner prefers, in order: at
    least :data:`SEP_MIN_CTAS` CTAs where the batch allows; the fewest
    chunks (the whole slice at once); in bf16, two CTAs an SM; the smallest
    cluster; a CTA count nearest :data:`SMS` CTAs (twice that in bf16); the
    widest panel.  The order was read off ``bench_conv.py --kernel
    fused_mbconv --tune`` on the card (PERF.md): at Lite0's blocks a slice
    computed in one chunk was the fastest plan at every shape, batch and
    type; fp32's 8x8 register tiles (about 180 registers a thread, so one
    CTA an SM) gained from one large CTA, bf16's tensor-core tiles from
    two.  The residual streams from device memory into the epilogue and
    claims no shared memory."""
    ladder = fused_mb_ladder(ho, wo, ci, c, co, stride=stride, hf=hf, wf=wf,
                             dtype=dtype, smem_budget=smem_budget,
                             batch=batch)
    return ladder[0] if ladder else None


@functools.lru_cache(maxsize=4096)
def fused_mb_ladder(ho: int, wo: int, ci: int, c: int, co: int, *,
                    stride: int = 1, hf: int = 3, wf: int = 3,
                    dtype: torch.dtype = torch.float32,
                    smem_budget: int = DEFAULT_SMEM_BUDGET,
                    batch: int = 1) -> tuple:
    """Every plan of :func:`plan_fused_mb`'s search at its tile width (slab
    height x cluster x Co panel, each through :func:`fused_mb_plan_at`), in
    its preference order (its plan first, ties in search order).  The
    autotuner's ``fusedmb`` ladder and ``bench_conv.py --kernel
    fused_mbconv --tune``'s candidates."""
    most = batch * ho * wo * SEP_MAX_CLUSTER
    floor, target = min(SEP_MIN_CTAS, most), min(SMS, most)
    tc = dtype == torch.bfloat16
    for tw in _halvings(wo):
        ranked: dict = {}
        for sh in sorted({-(-ho // -(-ho // h)) for h in _halvings(
                max(1, min(ho, SEP_MAX_PIXELS // tw)))}, reverse=True):
            for n in (1, 2, 4, 8):
                for panel in _halvings(separable_panel(sh * tw, co), 8):
                    p = fused_mb_plan_at(
                        ho, wo, ci, c, co, slab_h=sh, cluster=n,
                        panel=panel, tile_w=tw, stride=stride, hf=hf,
                        wf=wf, dtype=dtype, smem_budget=smem_budget,
                        batch=batch)
                    if p is not None:
                        ranked.setdefault(p, (
                            p.ctas < floor, -(-p.block_g // p.block_c),
                            tc and p.smem_bytes > SEP_TWO_CTAS, p.cluster,
                            abs(math.log(p.ctas / (target * (2 if tc
                                                              else 1)))),
                            -p.block_co))
        if ranked:
            return tuple(sorted(ranked, key=ranked.__getitem__))
    return ()


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

#: The reference's working-set budget of one TPU kernel (12 MiB of VMEM,
#: ``repro/kernels/blocking.py::DEFAULT_VMEM_BUDGET``).  :func:`plan_dw_se`
#: decides ``dw_se`` against ``dw`` + ``se`` by the reference's rule, so the
#: two packages plan the same segments at every resolution.
REF_VMEM_BUDGET = 12 * 1024 * 1024

#: ``dw_se`` (``csrc/dw_se.cu``): the fewest threads with work a tile
#: should have, and the channels a tile's group aims at (read off
#: ``bench_conv.py --kernel dw_se --tune`` on the card, PERF.md).
DW_SE_MIN_BUSY = 48
DW_SE_CHANNELS = 16


def ref_dw_se_vmem_bytes(hiu: int, wiu: int, ho: int, wo: int, c: int,
                         c_se: int, hf: int = 3, wf: int = 3,
                         itemsize: int = 4) -> int:
    """The reference's working set of its DW + SE kernel, a copy of
    ``repro/kernels/blocking.py::dw_se_vmem_bytes`` (the port imports
    nothing of the reference): the double-buffered input window and the
    filter at all ``c`` channels, the fp32 DW accumulator and output tile,
    and the gate weights and biases."""
    return (c * (2 * hiu * wiu * itemsize + hf * wf * itemsize
                 + ho * wo * (ACC_BYTES + itemsize))
            + 4 * c * c_se * itemsize
            + 2 * (c_se + c) * itemsize)


def dw_se_smem_bytes(pass_: int, tile_h: int, tile_w: int, cg: int, hf: int,
                     wf: int, stride: int, c_se: int,
                     dtype: torch.dtype) -> int:
    """Shared memory of one CTA of ``dw_se``'s pass ``pass_``
    (``dw_se_smem_bytes`` in ``csrc/dw_se.cu``), each region rounded up to
    16 bytes: 1 the pooling pass (the ``dwconv2d`` tile, the tile's fp32
    channel sums and its channels' rows of w1 in fp32), 2 the scaling pass
    (the tile, its channels' columns of w2 in fp32, the hidden vector and
    the gates); both also a column-sum scratch of max(256, c_se) floats."""
    tile = dwconv2d_smem_bytes(tile_h, tile_w, cg, hf, wf, stride, dtype)
    return tile + _dw_se_gate_smem(pass_, cg, c_se)


def _dw_se_gate_smem(pass_: int, cg: int, c_se: int) -> int:
    """The regions of ``dw_se``'s pass ``pass_`` beside the tile."""
    red = _a(max(256, c_se) * ACC_BYTES)
    if pass_ == 1:
        return _a(cg * ACC_BYTES) + _a(cg * c_se * ACC_BYTES) + red
    if pass_ == 2:
        return (_a(c_se * cg * ACC_BYTES) + _a(c_se * ACC_BYTES)
                + _a(cg * ACC_BYTES) + red)
    raise ValueError(f"dw_se has passes 1 and 2, not {pass_}")


def dw_se_workspace_bytes(batch: int, ctas: int, c_se: int) -> int:
    """``dw_se``'s fp32 workspace: each pooling CTA's share of the reduce
    FC (``ctas`` a pass per image)."""
    return batch * ctas * c_se * ACC_BYTES


def _dw_se_key(t: dict) -> tuple:
    """``dw_se``'s preference order (see :func:`plan_dw_se_tile`)."""
    return (t["busy"] < DW_SE_MIN_BUSY, t["used"] < 0.75,
            t["ctas"] < t["floor"], abs(math.log(t["cg"] / DW_SE_CHANNELS)),
            -t["threads"], t["halo"])


def plan_dw_se_tile(ho: int, wo: int, c: int, c_se: int, hf: int = 3,
                    wf: int = 3, *, stride: int = 1,
                    dtype: torch.dtype = torch.float32, batch: int = 1,
                    aligned: bool = True,
                    smem_budget: int = DEFAULT_SMEM_BUDGET
                    ) -> Optional[BlockPlan]:
    """The tile of both ``dw_se`` passes, from :func:`plan_dwconv2d`'s
    tiles (up to :data:`DW_MAX_TILE_W` columns even where the output is
    narrower) within :data:`DW_TILE_SMEM` and, with the regions beside
    the tile, ``smem_budget`` (None when none fits), in this order: at
    least :data:`DW_SE_MIN_BUSY` threads with work; channel groups with
    work for at least 3/4 of their lanes; at least :data:`SEP_MIN_CTAS`
    CTAs a pass for the ``batch`` images, where the work allows; the
    channel group nearest :data:`DW_SE_CHANNELS`; the most threads; the
    least halo.  Unlike ``dwconv2d``'s, the order takes fewer channels in
    taller and wider tiles, whose extra threads (even those whose outputs
    fall outside a narrow image) stage the window with more copies in
    flight.  It was read off ``bench_conv.py --kernel dw_se --tune`` on
    the card (PERF.md): over MnasNet's SE shapes at batch 1 and 8 and two
    at 224, fp32 and bf16, the picks sum to 1.08x the best tile timed at
    each shape.  ``ctas`` counts the CTAs of one pass over all ``batch``
    images."""
    ladder = dw_se_ladder(ho, wo, c, c_se, hf, wf, stride=stride,
                          dtype=dtype, batch=batch, aligned=aligned,
                          smem_budget=smem_budget)
    return ladder[0] if ladder else None


@functools.lru_cache(maxsize=4096)
def dw_se_ladder(ho: int, wo: int, c: int, c_se: int, hf: int = 3,
                 wf: int = 3, *, stride: int = 1,
                 dtype: torch.dtype = torch.float32, batch: int = 1,
                 aligned: bool = True,
                 smem_budget: int = DEFAULT_SMEM_BUDGET) -> tuple:
    """Every tile of :func:`plan_dw_se_tile`'s search, as plans, in its
    preference order (its plan first).  The autotuner's ``dw_se`` ladder
    and ``bench_conv.py --kernel dw_se --tune``'s candidates."""
    # the regions beside the tile grow with its channels: at most these
    vec = dw_vector(c, dtype, aligned)
    cg = min(DW_MAX_VECS * vec if vec > 1 else 32, _up(c, vec))
    extra = max(_dw_se_gate_smem(p, cg, c_se) for p in (1, 2))
    out = []
    for vec, nv, tw, th, _ in _dw_tiles(
            ho, wo, c, hf, wf, stride, dtype, aligned,
            min(DW_TILE_SMEM, smem_budget - extra), batch=batch,
            key=_dw_se_key, max_tile_w=DW_MAX_TILE_W):
        ctas = -(-ho // th) * -(-wo // tw) * -(-c // (nv * vec))
        out.append(_dw_plan(
            ho, wo, c, hf, stride, dtype, vec, nv, tw, th,
            dw_se_smem_bytes(1, th, tw, nv * vec, hf, wf, stride, c_se,
                             dtype),
            batch=batch,
            workspace_bytes=dw_se_workspace_bytes(batch, ctas, c_se)))
    return tuple(out)


def plan_dw_se(hiu: int, wiu: int, ho: int, wo: int, c: int, c_se: int,
               hf: int = 3, wf: int = 3, *, stride: int = 1,
               dtype: torch.dtype = torch.float32, batch: int = 1,
               smem_budget: int = DEFAULT_SMEM_BUDGET
               ) -> Optional[BlockPlan]:
    """Plan of the DW + SE-epilogue pass, or None (the chain then degrades
    to ``dw`` + ``se``).

    The segment kind follows the reference: None wherever the reference's
    working set (:func:`ref_dw_se_vmem_bytes` at the stream width) exceeds
    :data:`REF_VMEM_BUDGET`.  Otherwise the tile of
    :func:`plan_dw_se_tile`, which fits the card's shared memory at every
    shape; only a chain's shrunken ``smem_budget`` (which forces the fused
    kernels to degrade) can leave none."""
    if ref_dw_se_vmem_bytes(hiu, wiu, ho, wo, c, c_se, hf, wf,
                            dtype_bytes(dtype)) > REF_VMEM_BUDGET:
        return None
    return plan_dw_se_tile(ho, wo, c, c_se, hf, wf, stride=stride,
                           dtype=dtype, batch=batch, smem_budget=smem_budget)


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
# pwconv (tiled GEMM, three variants)
# ---------------------------------------------------------------------------

def pw_vector(co: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Elements of w a ``stream`` thread reads at once: one 16-byte vector
    where Co's rows are whole vectors and w's base is 16-byte aligned, else
    one element."""
    v = 16 // dtype_bytes(dtype)
    return v if aligned and co % v == 0 else 1


def tc_stages(bg: int, bco: int, bci: int, ci: int) -> int:
    """Ring depth of a ``tc`` CTA (``tc_stages`` in ``csrc/pwconv.cu``): no
    deeper than Ci's K steps, nor than lets two CTAs share an SM, nor than
    :data:`PW_TC_STAGES`; two at least once there are two K steps."""
    kt = -(-ci // bci)
    fit = (DEFAULT_SMEM_BUDGET // 2 - PW_TC_ALIGN - 16 * PW_TC_STAGES) // (
        (bg + bco) * bci * 2)
    s = min(kt, PW_TC_STAGES, fit)
    return s if s >= 2 else (1 if kt < 2 else 2)


def pwconv_smem_bytes(variant: str, bg: int, bco: int, bci: int,
                      ci: int) -> int:
    """Shared memory of one ``pwconv`` CTA for a reduction over ``ci``
    (``pwconv_smem_bytes`` in ``csrc/pwconv.cu``).  ``stream``: the fp32 x
    rows of one staged chunk, every warp's partial tile and the CTA's
    partial tile, each rounded up to 16 bytes.  ``tc``: alignment slack, a
    ring of :func:`tc_stages` stages of 16-bit x and w tiles and two
    mbarriers a stage.  ``simt``: two fp32 A and B buffers."""
    if variant == "stream":
        return (_a(min(bci, PW_STREAM_CHUNK) * bg * ACC_BYTES)
                + _a(PW_STREAM_WARPS * bg * bco * ACC_BYTES)
                + _a(bg * bco * ACC_BYTES))
    if variant == "tc":
        return PW_TC_ALIGN + tc_stages(bg, bco, bci, ci) * (
            (bg + bco) * bci * 2 + 16)
    if variant == "simt":
        return 2 * bci * (bg + bco) * ACC_BYTES
    raise ValueError(f"unknown pwconv variant {variant!r}")


def pw_variant(g: int, ci: int, co: int, dtype: torch.dtype, *,
               aligned: bool = True) -> str:
    """The variant for a (G, Ci) x (Ci, Co) product streamed at ``dtype``:
    ``stream`` at G <= :data:`PW_STREAM_MAX_G`; ``tc`` for bf16 / fp16
    whose rows are 16-byte multiples (Ci, Co multiples of 8) on 16-byte
    aligned bases; ``simt`` otherwise (every fp32 product)."""
    if g <= PW_STREAM_MAX_G[dtype]:
        return "stream"
    if (dtype in (torch.bfloat16, torch.float16) and aligned
            and ci % 8 == 0 and co % 8 == 0):
        return "tc"
    return "simt"


def _fill_tile(g: int, co: int, tiles) -> tuple:
    """The largest tile no wider than G and Co need (rounded up to 64),
    whose grid covers every SM, else the one with the most CTAs (the
    smaller tile of two with as many)."""
    best = None
    need_g, need_co = max(64, -(-g // 64) * 64), max(64, -(-co // 64) * 64)
    for t in tiles:
        if t[0] > need_g or t[1] > need_co:
            continue
        n = -(-g // t[0]) * -(-co // t[1])
        if n >= SMS:
            return t
        if best is None or n >= best[0]:
            best = (n, t)
    return best[1]


def stream_cluster(ci: int, ctas: int) -> int:
    """Split-K cluster of ``stream``: the smallest that puts two CTAs on
    every SM, keeping at least 128 Ci rows a CTA, at most 8.  (On the card,
    ``bench_pwconv.py --tune``: below 128 rows a CTA the partial-tile
    reduction cost more than the extra CTAs gained, e.g. 768->3072 at
    G = 8 in fp32 took 8.0 us at a cluster of 4 and 12.4 at 8.)"""
    n = 1
    while (n < PW_STREAM_MAX_CLUSTER and ctas * n < 2 * SMS
           and -(-ci // (2 * n)) >= 128):
        n *= 2
    return n


def pwconv_tile_error(variant: str, bg: int, bco: int, bci: int, *, ci: int,
                      vector: int) -> Optional[str]:
    """Why ``(bg, bco, bci)`` is not a tile the variant is compiled for, or
    None when it is."""
    if variant not in PW_TILES:
        return f"unknown variant {variant!r}"
    if variant != "stream":
        if (bg, bco, bci) not in PW_TILES[variant]:
            return (f"no compiled {variant} tile ({bg}, {bco}, {bci}); "
                    f"tiles {PW_TILES[variant]}")
        return None
    if (bg, bco, None) not in PW_TILES["stream"]:
        return (f"no compiled stream tile ({bg}, {bco}); (block_g, "
                f"block_co) in {[t[:2] for t in PW_TILES['stream']]}")
    nthr = bco // vector
    if bco % vector or nthr > 32:
        return (f"stream block_co {bco} is not 1..32 vectors of {vector}")
    if vector > 1 and bg * vector > 64:
        return f"stream block_g {bg} x vector {vector} > 64 sums a thread"
    if bci < 1 or -(-ci // bci) > PW_STREAM_MAX_CLUSTER:
        return (f"stream block_ci {bci} needs more than "
                f"{PW_STREAM_MAX_CLUSTER} CTAs for Ci = {ci}")
    return None


@functools.lru_cache(maxsize=4096)
def plan_pwconv(g: int, ci: int, co: int, *,
                dtype: torch.dtype = torch.float32,
                smem_budget: int = DEFAULT_SMEM_BUDGET,
                variant: Optional[str] = None,
                aligned: bool = True) -> BlockPlan:
    """The variant (:func:`pw_variant`, unless given) and its tile.

    * ``stream``: ``block_g`` the smallest compiled G tile that holds G
      (rows beyond 16, or 64 sums a thread, run as further CTAs),
      ``block_co`` 64 columns (32 where Co is at most 32 or w is read
      element by element), and Ci split by :func:`stream_cluster`.
    * ``tc`` / ``simt``: the largest compiled M x N tile whose grid covers
      the card's SMs, else the one with the most CTAs.
    ``aligned``: w (and, for ``tc``, x) start on 16-byte boundaries.
    Every compiled tile fits one CTA, so ``smem_budget`` (the fused
    kernels' budget, which a chain may shrink to force a degradation)
    does not bind here, as it did not before the variants.
    """
    variant = variant or pw_variant(g, ci, co, dtype, aligned=aligned)
    cluster = 1
    if variant == "stream":
        vec = pw_vector(co, dtype, aligned)
        bg = 1
        while bg < min(g, 16) and (vec == 1 or 2 * bg * vec <= 64):
            bg *= 2
        bco = 64 if vec > 1 and co > 32 else 32
        ctas = -(-co // bco) * -(-g // bg)
        cluster = stream_cluster(ci, ctas)
        bci = -(-ci // cluster)
        cluster = -(-ci // bci)
    elif variant in ("tc", "simt"):
        bg, bco, bci = _fill_tile(g, co, PW_TILES[variant])
    else:
        raise ValueError(f"unknown pwconv variant {variant!r}")
    return _pw_plan(variant, bg, bco, bci, ci, dtype, cluster)


def _pw_plan(variant: str, bg: int, bco: int, bci: int, ci: int,
             dtype: torch.dtype, cluster: int = 1) -> BlockPlan:
    return BlockPlan(
        block_c=bci, block_co=bco, slab_h=0, n_slabs=1, halo_rows=0,
        smem_bytes=pwconv_smem_bytes(variant, bg, bco, bci, ci),
        dtype_bytes=dtype_bytes(dtype), block_g=bg, cluster=cluster,
        variant=variant,
    )


#: The largest G whose ``pwconv`` ladder holds ``stream`` tiles:
#: ``bench_pwconv.py --tune`` timed ``stream`` against the wide variants up
#: to G = 96 (PERF.md); above that every CTA of at most 16 rows reads all
#: of w again.
PW_STREAM_LADDER_MAX_G = 128


def _pw_variant_fits(variant: str, g: int, ci: int, co: int,
                     dtype: torch.dtype, aligned: bool) -> bool:
    """Whether ``variant`` takes a (G, Ci) x (Ci, Co) product at ``dtype``:
    ``tc`` only 16-bit operands TMA can describe (Ci and Co multiples of
    8, 16-byte aligned bases), ``stream`` only G up to
    :data:`PW_STREAM_LADDER_MAX_G`."""
    if variant == "tc":
        return (dtype in (torch.bfloat16, torch.float16) and aligned
                and ci % 8 == 0 and co % 8 == 0)
    if variant == "stream":
        return g <= PW_STREAM_LADDER_MAX_G
    return variant == "simt"


def _pw_tiles(variant: str, g: int, ci: int, co: int, dtype: torch.dtype,
              aligned: bool) -> list:
    """The variant's compiled tiles for this product, as plans, in table
    order: ``tc`` / ``simt`` tiles no wider than G and Co need (rounded up
    to 64, as :func:`_fill_tile` takes them); ``stream`` at its planned
    ``block_g``, each ``block_co`` up to Co's width by each split-K
    cluster, where :func:`pwconv_tile_error` accepts the tile."""
    if variant != "stream":
        need_g, need_co = max(64, _up(g, 64)), max(64, _up(co, 64))
        return [_pw_plan(variant, *t, ci, dtype) for t in PW_TILES[variant]
                if t[0] <= need_g and t[1] <= need_co]
    bg = plan_pwconv(g, ci, co, dtype=dtype, variant="stream",
                     aligned=aligned).block_g
    vec = pw_vector(co, dtype, aligned)
    out = []
    for tile_g, bco, _ in PW_TILES["stream"]:
        if tile_g != bg or (bco > 32 and bco > _up(co, 32)):
            continue
        for cluster in (1, 2, 4, 8):
            bci = -(-ci // cluster)
            if pwconv_tile_error("stream", bg, bco, bci, ci=ci,
                                 vector=vec) is None:
                out.append(_pw_plan("stream", bg, bco, bci, ci, dtype,
                                    -(-ci // bci)))
    return out


@functools.lru_cache(maxsize=4096)
def pwconv_ladder(g: int, ci: int, co: int, *,
                  dtype: torch.dtype = torch.float32,
                  aligned: bool = True) -> tuple:
    """``pwconv``'s variants x tiles for a (G, Ci) x (Ci, Co) product, in
    this order: :func:`plan_pwconv`'s plan; every other variant that takes
    the product (:func:`_pw_variant_fits`) at its own planned tile; then
    the other tiles of the planned variant and of the others
    (:func:`_pw_tiles`).  The autotuner's ``pw`` ladder and
    ``bench_pwconv.py --tune``'s ``stream`` candidates."""
    first = plan_pwconv(g, ci, co, dtype=dtype, aligned=aligned)
    variants = [first.variant] + [
        v for v in PW_VARIANTS if v != first.variant
        and _pw_variant_fits(v, g, ci, co, dtype, aligned)]
    ranked = dict.fromkeys(
        plan_pwconv(g, ci, co, dtype=dtype, variant=v, aligned=aligned)
        for v in variants)
    for v in variants:
        ranked.update(dict.fromkeys(_pw_tiles(v, g, ci, co, dtype,
                                              aligned)))
    return tuple(ranked)


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
