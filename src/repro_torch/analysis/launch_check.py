"""launch_check — the card's launch limits over the launch models.

Counterpart of ``repro/analysis/mosaic_check.py``.  The reference lints
its kernels against Mosaic's lane and sublane tiling, which this card does
not have; what refuses a launch here is the launch configuration itself:
the CUDA driver rejects a grid, a CTA, a cluster or a shared-memory request
beyond the card's limits with a launch error (PERF.md, section 6: a
``pwconv`` ``stream`` launch of 16,776,961 channels asked for more than
65,535 CTAs in y and was refused).  So the rules have ids of their own
(LC2xx, in place of MC2xx), over the same
:class:`~repro_torch.kernels.gridspec.LaunchModel` the planlint pass
enumerates:

* LC201 (error) — a grid dimension beyond the card's limit (x at most
  2^31 - 1, y and z at most 65,535).
* LC202 — more than 1024 threads in a CTA, or none (error); a CTA that is
  not whole warps (info: the CUDA driver takes it, and the depthwise tiles
  choose one deliberately, a thread a channel vector and run of four
  columns, e.g. 252 threads for 7 rows of 9 runs by 4 vectors; the last
  warp idles in part).
* LC203 (error) — a thread-block cluster of more than 8 CTAs (the
  portable size), or one that does not divide its grid dimension.
* LC204 (error) — dynamic shared memory over the most a CTA may opt into
  (232,448 B).
* LC205 — the 16-byte paths: a ``tc`` launch whose tensor map has a row
  pitch that is not a multiple of 16 B or a box edge over 256 (error: TMA
  cannot describe it); a 16-byte vector path that the channel count denies
  (info, e.g. hymba's bf16 ``w_bcdt`` and ``w_dt`` Linears, which run on
  ``simt``).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.diagnostics import ERROR, INFO, Diagnostic
from repro_torch.kernels import gridspec
from repro_torch.kernels.gridspec import LaunchModel


def check_grid_limits(model: LaunchModel,
                      segment: str = "") -> List[Diagnostic]:
    """LC201: each grid dimension within the card's limit."""
    geo = f"{model.name} grid={model.grid}"
    for axis, n, limit in zip("xyz", model.grid, gridspec.GRID_LIMITS):
        if n > limit:
            return [Diagnostic(
                "LC201", ERROR,
                f"{model.name} asks for {n} CTAs in grid {axis}, more than "
                f"the card's {limit}: the CUDA driver refuses the launch",
                segment, geo,
                "a wider tile along that dimension (fewer CTAs)")]
    return []


def check_block(model: LaunchModel, segment: str = "") -> List[Diagnostic]:
    """LC202: 1..1024 threads a CTA (error); a partial last warp (info)."""
    n = model.threads
    geo = f"{model.name} block={model.block}"
    if n < 1 or n > gridspec.MAX_THREADS:
        return [Diagnostic(
            "LC202", ERROR,
            f"{model.name} CTA of {model.block} = {n} threads, not 1.."
            f"{gridspec.MAX_THREADS}: the CUDA driver refuses the launch",
            segment, geo, "a smaller tile")]
    if n % gridspec.WARP:
        return [Diagnostic(
            "LC202", INFO,
            f"{model.name} CTA of {n} threads is not whole warps: "
            f"{-n % gridspec.WARP} lanes of its last warp idle", segment,
            geo)]
    return []


def check_cluster(model: LaunchModel, segment: str = "") -> List[Diagnostic]:
    """LC203: a cluster of at most 8 CTAs that divides its grid."""
    size = model.cluster[0] * model.cluster[1] * model.cluster[2]
    geo = f"{model.name} grid={model.grid} cluster={model.cluster}"
    if size < 1 or size > gridspec.MAX_CLUSTER:
        return [Diagnostic(
            "LC203", ERROR,
            f"{model.name} cluster of {size} CTAs, more than the portable "
            f"{gridspec.MAX_CLUSTER}", segment, geo,
            "split the reduction over at most 8 CTAs")]
    if any(n % c for n, c in zip(model.grid, model.cluster)):
        return [Diagnostic(
            "LC203", ERROR,
            f"{model.name} cluster {model.cluster} does not divide the grid "
            f"{model.grid}", segment, geo,
            "every grid dimension must be whole clusters")]
    return []


def check_smem(model: LaunchModel, segment: str = "") -> List[Diagnostic]:
    """LC204: dynamic shared memory within the opt-in maximum."""
    if model.smem > gridspec.MAX_SMEM:
        return [Diagnostic(
            "LC204", ERROR,
            f"{model.name} asks for {model.smem} B of dynamic shared memory, "
            f"more than a CTA may opt into ({gridspec.MAX_SMEM} B)", segment,
            f"{model.name} smem={model.smem}", "shrink the tile")]
    return []


def check_vectors(model: LaunchModel,
                  segment: str = "") -> List[Diagnostic]:
    """LC205: TMA's tensor maps (error) and denied 16-byte paths (info)."""
    diags = []
    for pitch, box in model.tma:
        if pitch % gridspec.TMA_PITCH or max(box) > gridspec.TMA_MAX_BOX:
            diags.append(Diagnostic(
                "LC205", ERROR,
                f"{model.name} tensor map of row pitch {pitch} B and box "
                f"{box}: TMA takes pitches of 16-byte multiples and boxes "
                f"of at most {gridspec.TMA_MAX_BOX}", segment,
                f"{model.name} tma={model.tma}",
                "the tc variant needs Ci and Co multiples of 8 16-bit "
                "elements"))
    if model.vector_note:
        diags.append(Diagnostic("LC205", INFO,
                                f"{model.name}: {model.vector_note}",
                                segment, model.name))
    return diags


def lint_model(model: LaunchModel, segment: str = "") -> List[Diagnostic]:
    """All launch rules over one launch model."""
    return (check_grid_limits(model, segment) + check_block(model, segment)
            + check_cluster(model, segment) + check_smem(model, segment)
            + check_vectors(model, segment))
