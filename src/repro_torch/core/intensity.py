"""Analytical arithmetic-intensity (AI) / operational-intensity (OI) models.

The port's own copy of ``repro/core/intensity.py``: every equation of the
paper (``t_tf_dw`` .. ``t_rtrd_pw``), :class:`Traffic`, and the
per-segment traffic models (``dwconv2d_traffic`` .. ``pwconv_traffic_rtra``),
number for number the reference's at the same arguments.
:func:`network_traffic` sums ``core/chain.chain_traffic`` over a planned
body; ``mobilenet_inference`` prints it as the "modeled HBM" line.

Paper notation (fp32, 16-byte SIMD registers, FMA = 2 flops/lane · 4 lanes):

* ``T_tf_dw``    — TF-Lite DWConv AI  (paper: 1/8, or < 1/6 with the
                   benefit-of-the-doubt filter-in-register variant).
* ``T_ours_dw``  — paper Alg. 4 DWConv AI, eq. (1); ≥ 9/22 for 3×3 filters.
* ``T_rtra_pw``  — BLAS GEMM kernel (A-stationary) AI = 4/(3 + 8/Co).
* ``T_rtrd_pw``  — paper Alg. 6 (output-stationary) AI = 2/(1 + 8/Ci).

What the segment models price is the reference's TPU tiling (one kernel
pass's device-memory traffic at its BlockSpec tiles), read off the port's
``BlockPlan`` fields of the same names.  Two of those fields mean
something else in the port's plans (``kernels/blocking.py::BlockPlan``):

* in ``separable_fused`` and ``fused_mbconv`` a thread-block ``cluster``
  splits C and ``block_c`` is the chunk of a CTA's slice staged at once
  (the reference's ``block_c`` is the DW channel block); the Co panel
  ``block_co`` and the slab fields mean what they mean there;
* in ``pwconv``'s ``stream`` variant ``block_c`` is the Ci rows of each
  CTA of the split-K cluster (the reference's GEMM reduction block).

So the models are the reference's arithmetic at those fields, not the
traffic of the Hopper kernels (whose launches read each operand once per
CTA that needs it, through L2); the kernels' own roofline bounds are
``chip_smoke.py``'s ``bound_ms``.
"""
from __future__ import annotations

import dataclasses
import math

FMA_FLOPS_PER_LANE = 2  # multiply + add
SIMD_LANES = 4          # 128-bit NEON / fp32
SIMD_BYTES = 16


# ---------------------------------------------------------------------------
# Paper equations (ARM level)
# ---------------------------------------------------------------------------

def t_tf_dw(w_ob: int | None = None) -> float:
    """TF-Lite DWConv AI. Plain: 1/8. With filter kept in registers across the
    kk loop (benefit of the doubt): 1/((3 + 1/W_ob) * 2) < 1/6."""
    if w_ob is None:
        return (FMA_FLOPS_PER_LANE * SIMD_LANES) / (4 * SIMD_BYTES)  # = 1/8
    return 1.0 / ((3.0 + 1.0 / w_ob) * 2.0)


def t_ours_dw(hf: int, wf: int, h_ob: int, w_ob: int, ho: int, wo: int) -> float:
    """Paper eq. (1): AI of Alg. 4.

    W = H_ob*W_ob*Hf*Wf FMA ops -> 8W flops. Traffic: amortized filter load +
    output load+store once + input stream (16 bytes per FMA).
    """
    w_work = h_ob * w_ob * hf * wf
    filt = (hf * wf) / ((ho / h_ob) * (wo / w_ob))
    out = h_ob * w_ob * 2
    return (8.0 * w_work) / (16.0 * (filt + out + w_work))


def t_ours_dw_asymptotic(hf: int, wf: int) -> float:
    """Paper's simplification: T = Hf*Wf / ((2 + Hf*Wf) * 2)   (>= 9/22 for 3x3)."""
    return (hf * wf) / ((2.0 + hf * wf) * 2.0)


def t_rtra_pw(g_b: int = 8, ci_b: int = 8, co_b: int = 4, co: int = 1024) -> float:
    """BLAS RTRA kernel AI (paper): D streamed twice per reduction block."""
    flops = 2.0 * g_b * ci_b * co_b
    bytes_ = (g_b * co_b * 2 + ci_b * co_b + (g_b * ci_b) / (co / co_b)) * 4.0
    return flops / bytes_


def t_rtrd_pw(g_b: int = 8, co_b: int = 8, ci_b: int = 4, ci: int = 1024) -> float:
    """Paper RTRD kernel AI: D resident across the whole Ci reduction."""
    flops = 2.0 * g_b * ci_b * co_b
    bytes_ = (g_b * ci_b + ci_b * co_b + (g_b * co_b * 2) / (ci / ci_b)) * 4.0
    return flops / bytes_


# ---------------------------------------------------------------------------
# TPU (VMEM-level) translation — same ratios, BlockSpec tiles, HBM traffic.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Traffic:
    """FLOPs and HBM<->VMEM bytes of one kernel invocation."""
    flops: float
    bytes_hbm: float

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes_hbm, 1.0)

    def time_s(self, peak_flops: float, hbm_bw: float) -> tuple[float, float]:
        """(compute_s, memory_s) roofline terms for this kernel."""
        return self.flops / peak_flops, self.bytes_hbm / hbm_bw


def dwconv2d_traffic(
    b: int, hi: int, wi: int, c: int, hf: int, wf: int, stride: int,
    dtype_bytes: int = 4,
) -> Traffic:
    """Our dwconv2d kernel: input read once, filter once, output stored once —
    the information floor (paper's store-once / filter-stationary design)."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    flops = 2.0 * b * ho * wo * c * hf * wf
    bytes_ = dtype_bytes * (b * hi * wi * c + hf * wf * c + b * ho * wo * c)
    return Traffic(flops, bytes_)


def dwconv2d_traffic_rowpar(
    b: int, hi: int, wi: int, c: int, hf: int, wf: int, stride: int,
    p: int, l1_bytes: int = 32 * 1024, dtype_bytes: int = 4,
) -> Traffic:
    """TF-Lite-style row-parallel partitioning at p cores: every core re-reads
    the WHOLE filter (Hf*Wf*C) and halo rows; models the paper's core-
    inscalability argument for the fig-7 scalability benchmark."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    flops = 2.0 * b * ho * wo * c * hf * wf
    halo_rows = (hf - stride) if hf > stride else 0
    bytes_ = dtype_bytes * (
        b * hi * wi * c                      # input
        + b * p * halo_rows * wi * c         # halo re-reads at p chunk seams
        + p * hf * wf * c                    # filter replicated in every L1
        + b * ho * wo * c                    # output
    )
    # L1 thrash: when a core's filter + filter-support rows exceed its L1,
    # filter and input rows evict each other, so the filter is re-fetched per
    # output row and each input row is touched once per filter row instead of
    # once (the paper's "cache misses fly high" regime; worsens with p since
    # all cores hold the FULL filter).
    ws = (hf * wf * c + hf * wi * c) * dtype_bytes
    if ws > l1_bytes:
        bytes_ += dtype_bytes * b * (ho - 1) * hf * wf * c
        bytes_ += dtype_bytes * b * hi * wi * c * (hf - 1)
    return Traffic(flops, bytes_)


def pwconv_traffic_rtrd(
    g: int, ci: int, co: int, bg: int, bci: int, bco: int,
    dtype_bytes: int = 4,
) -> Traffic:
    """Our output-stationary GEMM: A re-read per Co panel, B re-read per G
    panel, D written once (never re-read)."""
    flops = 2.0 * g * ci * co
    n_jpanels = math.ceil(co / bco)
    n_gpanels = math.ceil(g / bg)
    bytes_ = dtype_bytes * (
        g * ci * n_jpanels      # A streamed once per output column panel
        + ci * co * n_gpanels   # B streamed once per output row panel
        + g * co                # D stored once  <- the RTRD win
    )
    return Traffic(flops, bytes_)


def separable_traffic_unfused(
    b: int, hi: int, wi: int, c: int, co: int, hf: int, wf: int, stride: int,
    bg: int = 256, bci: int = 256, bco: int = 256, dtype_bytes: int = 4,
) -> Traffic:
    """Depthwise-separable block as two standalone kernels: the DW output
    (B*Ho*Wo*C) is stored to HBM by dwconv2d and re-read by pwconv once per
    Co panel — the intermediate round-trip the fused kernel removes."""
    dw = dwconv2d_traffic(b, hi, wi, c, hf, wf, stride, dtype_bytes)
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    pw = pwconv_traffic_rtrd(b * ho * wo, c, co, bg, bci, bco, dtype_bytes)
    return Traffic(dw.flops + pw.flops, dw.bytes_hbm + pw.bytes_hbm)


def separable_slab_halo_bytes(
    b: int, wi: int, c: int, hf: int, stride: int, n_slabs: int,
    n_co_panels: int = 1, dtype_bytes: int = 4,
) -> float:
    """The price of row-slab blocking: input rows re-fetched at slab seams.

    Adjacent slabs' input windows overlap by ``max(Hf - stride, 0)`` rows,
    so each of the ``n_slabs - 1`` interior seams re-reads that many rows of
    ``Wi x C`` input — per Co panel, since the input is streamed once per
    panel. Zero when unslabbed (n_slabs == 1) or when stride >= Hf (the
    windows are disjoint)."""
    halo = max(hf - stride, 0)
    return float(dtype_bytes * n_co_panels * b * (n_slabs - 1) * halo
                 * wi * c)


def separable_traffic_fused(
    b: int, hi: int, wi: int, c: int, co: int, hf: int, wf: int, stride: int,
    block_co: int | None = None, slab_h: int | None = None,
    dtype_bytes: int = 4,
) -> Traffic:
    """Fused DW+PW kernel (kernels/separable_fused.py): the DW output exists
    only in VMEM. Input streamed once per Co panel (recompute instead of
    round-trip), PW weight once per (batch, slab) row-panel, output stored
    once. With a single Co panel (the planner's preferred case) this is
    exactly the unfused traffic minus the intermediate store + re-read.

    ``slab_h`` models the row-slab grid dimension (BlockPlan.slab_h): each
    slab fetches its ``(slab_h-1)*stride + Hf``-row input window, so
    adjacent slabs re-read a halo counted explicitly by
    :func:`separable_slab_halo_bytes`; the filter tile is re-fetched per
    slab and the PW weight is re-streamed per slab (the accumulator now
    spans one slab, not the whole image). Slabbing moves NO extra flops —
    every output row is computed exactly once."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    n_co = math.ceil(co / (block_co or co))
    n_slabs = math.ceil(ho / slab_h) if slab_h else 1
    flops = (n_co * 2.0 * b * ho * wo * c * hf * wf  # DW recomputed per panel
             + 2.0 * b * ho * wo * c * co)           # PW stage
    bytes_ = dtype_bytes * (
        n_co * b * hi * wi * c                # input slab, once per Co panel
        + n_co * n_slabs * b * hf * wf * c    # DW filter tile per grid cell
        + n_slabs * b * c * co                # PW weight per (batch, slab)
        + b * ho * wo * co                    # output stored once
        # intermediate term: 0 — never leaves VMEM
    ) + separable_slab_halo_bytes(b, wi, c, hf, stride, n_slabs, n_co,
                                  dtype_bytes)
    return Traffic(flops, bytes_)


def separable_traffic_fused3(
    b: int, hi: int, wi: int, ci: int, c: int, co: int,
    hf: int, wf: int, stride: int,
    block_co: int | None = None, slab_h: int | None = None,
    dtype_bytes: int = 4,
) -> Traffic:
    """3-stage fused chain (PW-expand -> DW -> PW-project in ONE kernel
    pass, kernels/separable_fused.py with ``expand_w``): the expansion GEMM
    is computed on the fly per row slab, so neither the EXPANDED tensor
    (``B*Hi*Wi*C`` — 6x the input at MobileNetV2's expansion factor) nor
    the DW output ever exists in HBM.

    ``ci`` is the raw-input width, ``c`` the expanded (DW) width, ``co``
    the projected width.  Streams: RAW input once per Co panel (at ``ci``
    channels — cheaper than the 2-stage kernel's expanded-width stream),
    expand weight + DW filter per grid cell, project weight per
    (batch, slab), output once.  The expand GEMM and DW compute are
    replayed per Co panel (recompute instead of round-trip); the slab-seam
    halo re-read is counted at ``ci`` channels.  Expansion recompute of
    halo rows moves negligible extra flops and is excluded (the model
    counts each expanded pixel once per Co panel)."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    n_co = math.ceil(co / (block_co or co))
    n_slabs = math.ceil(ho / slab_h) if slab_h else 1
    flops = (n_co * 2.0 * b * hi * wi * ci * c    # expand GEMM per Co panel
             + n_co * 2.0 * b * ho * wo * c * hf * wf  # DW per Co panel
             + 2.0 * b * ho * wo * c * co)             # PW-project stage
    bytes_ = dtype_bytes * (
        n_co * b * hi * wi * ci               # RAW input, once per Co panel
        + n_co * n_slabs * b * ci * c         # expand W tile per grid cell
        + n_co * n_slabs * b * hf * wf * c    # DW filter tile per grid cell
        + n_slabs * b * c * co                # project W per (batch, slab)
        + b * ho * wo * co                    # output stored once
        # expanded + DW intermediates: 0 — never leave VMEM
    ) + separable_slab_halo_bytes(b, wi, ci, hf, stride, n_slabs, n_co,
                                  dtype_bytes)
    return Traffic(flops, bytes_)


def fused_mb_traffic(
    b: int, hi: int, wi: int, ci: int, c: int, co: int,
    hf: int, wf: int, stride: int,
    block_co: int | None = None, slab_h: int | None = None,
    dtype_bytes: int = 4,
) -> Traffic:
    """Fused-MBConv kernel (kernels/fused_mbconv.py): full ``hf x wf`` conv
    -> act -> PW-project in ONE pass.  ``ci`` is the raw-input width, ``c``
    the conv-output (expanded) width, ``co`` the projected width.  Streams:
    raw input once per Co panel, the dense conv filter per grid cell, the
    project weight per (batch, slab), output once — the expanded tensor
    (``B*Ho*Wo*C``) never exists in HBM.  The conv compute is replayed per
    Co panel (recompute instead of round-trip)."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    n_co = math.ceil(co / (block_co or co))
    n_slabs = math.ceil(ho / slab_h) if slab_h else 1
    flops = (n_co * 2.0 * b * ho * wo * ci * c * hf * wf  # conv per Co panel
             + 2.0 * b * ho * wo * c * co)                # PW-project stage
    bytes_ = dtype_bytes * (
        n_co * b * hi * wi * ci               # RAW input, once per Co panel
        + n_co * n_slabs * b * hf * wf * ci * c  # conv filter per grid cell
        + n_slabs * b * c * co                # project W per (batch, slab)
        + b * ho * wo * co                    # output stored once
        # conv intermediate: 0 — never leaves VMEM
    ) + separable_slab_halo_bytes(b, wi, ci, hf, stride, n_slabs, n_co,
                                  dtype_bytes)
    return Traffic(flops, bytes_)


def mb_traffic(
    b: int, h: int, w: int, ci: int, c: int, hf: int, wf: int, stride: int,
    dtype_bytes: int = 4,
) -> Traffic:
    """Standalone dense conv (the fused-MBConv degradation target,
    XLA-lowered): input read once, filter once, output stored once.
    ``h, w`` are the UNPADDED input dims (SAME geometry)."""
    ho, wo = -(-h // stride), -(-w // stride)
    flops = 2.0 * b * ho * wo * ci * c * hf * wf
    bytes_ = dtype_bytes * (b * h * w * ci + hf * wf * ci * c
                            + b * ho * wo * c)
    return Traffic(flops, bytes_)


def se_traffic(
    b: int, h: int, w: int, c: int, c_se: int,
    dtype_bytes: int = 4,
) -> Traffic:
    """Standalone squeeze-excite pass: the input tensor is read by the
    global pool, read AGAIN by the channelwise scale, and the scaled
    result stored — two reads + one write of ``B*H*W*C`` purely to apply
    two tiny FCs over the spatial mean (the round-trip the fused ``dw_se``
    segment removes).  Gate FLOPs: pool + two FCs + sigmoid + scale."""
    flops = (b * h * w * c                  # pool accumulation
             + 2.0 * b * c * c_se * 2      # the two FCs
             + 4.0 * b * c                  # sigmoid (approx)
             + b * h * w * c)               # the scale
    bytes_ = dtype_bytes * (
        3 * b * h * w * c                   # pool read + scale read + store
        + 2 * c * c_se + c_se + c           # gate weights + biases
    )
    return Traffic(flops, bytes_)


def dw_se_traffic(
    b: int, hi: int, wi: int, c: int, c_se: int, hf: int, wf: int,
    stride: int, dtype_bytes: int = 4,
) -> Traffic:
    """Fused DW + SE-epilogue kernel (kernels/se_epilogue.py): the DW
    output stays VMEM-resident through the pool, the gate FCs and the
    scale, and is stored exactly once, already scaled — vs the standalone
    composition's store + two re-reads (:func:`se_traffic`).  Input read
    once, DW filter + gate weights once; full-channel single-slab
    residency means no panel or halo re-reads at all."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    flops = (2.0 * b * ho * wo * c * hf * wf    # DW
             + b * ho * wo * c                   # pool
             + 2.0 * b * c * c_se * 2           # the two FCs
             + 4.0 * b * c                       # sigmoid (approx)
             + b * ho * wo * c)                  # the scale
    bytes_ = dtype_bytes * (
        b * hi * wi * c                          # input read once
        + hf * wf * c                            # DW filter
        + 2 * c * c_se + c_se + c                # gate weights + biases
        + b * ho * wo * c                        # output stored once
        # DW intermediate + gate: 0 — never leave VMEM
    )
    return Traffic(flops, bytes_)


def separable_traffic_2stage(
    b: int, h: int, w: int, ci: int, c: int, co: int,
    hf: int, wf: int, stride: int,
    block_co: int | None = None, slab_h: int | None = None,
    bg: int = 256, bci: int = 256, bco: int = 256,
    dtype_bytes: int = 4,
) -> Traffic:
    """The PR-2 lowering of an inverted residual: standalone expansion GEMM
    (RTRD) whose ``B*H*W*C`` output round-trips HBM, then the 2-stage fused
    DW -> PW kernel.  ``h, w`` are the UNPADDED input dims (the expansion
    runs pre-padding); the fused stage sees the SAME-padded geometry."""
    ho, wo = -(-h // stride), -(-w // stride)
    hi = (ho - 1) * stride + hf
    wi = (wo - 1) * stride + wf
    expand = pwconv_traffic_rtrd(b * h * w, ci, c, bg, bci, bco, dtype_bytes)
    tail = separable_traffic_fused(b, hi, wi, c, co, hf, wf, stride,
                                   block_co=block_co, slab_h=slab_h,
                                   dtype_bytes=dtype_bytes)
    return Traffic(expand.flops + tail.flops,
                   expand.bytes_hbm + tail.bytes_hbm)


def separable_traffic_unfused3(
    b: int, h: int, w: int, ci: int, c: int, co: int,
    hf: int, wf: int, stride: int,
    bg: int = 256, bci: int = 256, bco: int = 256,
    dtype_bytes: int = 4,
) -> Traffic:
    """Fully unfused inverted residual: expansion GEMM + standalone DW +
    standalone PW-project, every intermediate round-tripping HBM."""
    ho, wo = -(-h // stride), -(-w // stride)
    hi = (ho - 1) * stride + hf
    wi = (wo - 1) * stride + wf
    expand = pwconv_traffic_rtrd(b * h * w, ci, c, bg, bci, bco, dtype_bytes)
    tail = separable_traffic_unfused(b, hi, wi, c, co, hf, wf, stride,
                                     bg, bci, bco, dtype_bytes)
    return Traffic(expand.flops + tail.flops,
                   expand.bytes_hbm + tail.bytes_hbm)


def separable_intermediate_bytes(
    b: int, hi: int, wi: int, c: int, co: int, hf: int, wf: int, stride: int,
    bco: int = 256, dtype_bytes: int = 4,
) -> float:
    """The removed term: HBM bytes the unfused composition spends moving the
    DW intermediate (one store + one load per Co panel of pwconv)."""
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    n_jpanels = math.ceil(co / bco)
    return dtype_bytes * b * ho * wo * c * (1 + n_jpanels)


def pwconv_traffic_rtra(
    g: int, ci: int, co: int, bg: int, bci: int, bco: int,
    dtype_bytes: int = 4,
) -> Traffic:
    """A-stationary GEMM (BLAS/RTRA): D round-trips once per Ci block."""
    flops = 2.0 * g * ci * co
    n_kpanels = math.ceil(ci / bci)
    n_gpanels = math.ceil(g / bg)
    bytes_ = dtype_bytes * (
        g * ci                      # A streamed once (stationary per panel)
        + ci * co * n_gpanels       # B streamed per row panel
        + g * co * 2 * n_kpanels    # D loaded+stored per reduction block
    )
    return Traffic(flops, bytes_)


def network_traffic(net, network_plan, *,
                    dtype_bytes: int | None = None) -> Traffic:
    """Modeled HBM traffic + FLOPs of a planned whole network: the sum of
    ``chain_traffic`` over every block at the shapes the NetworkPlan walked.

    Each block's bytes are counted at ITS plan's ``dtype_bytes`` — the
    stream width the planner budgeted at — so a bf16-streaming policy
    (``ChainPlan.dtype_bytes == 2``) halves every streamed term relative to
    the fp32 baseline, block by block, with no change to the FLOP count.
    ``dtype_bytes`` overrides that width uniformly (what-if re-costing).

    ``net`` / ``network_plan`` are ``core/network.py``'s NetworkSpec /
    NetworkPlan (duck-typed here; the lazy import below avoids the cycle
    core.chain -> core.intensity).
    """
    from repro_torch.core import chain  # deferred: chain imports this
    flops = 0.0
    bytes_ = 0.0
    for spec, cp, shape in zip(net.blocks, network_plan.plans,
                               network_plan.block_shapes):
        t = chain.chain_traffic(spec, cp, shape, dtype_bytes=dtype_bytes)
        flops += t.flops
        bytes_ += t.bytes_hbm
    return Traffic(flops, bytes_)
