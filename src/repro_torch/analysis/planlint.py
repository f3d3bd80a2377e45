"""planlint — static verification of ChainPlans against the Hopper kernels'
launches.

Counterpart of ``repro/analysis/planlint.py``.  Parity tests catch wrong
values; this pass catches infeasible or silently degraded plans before
anything runs.  Three layers of checks per segment, with the reference's
rule ids wherever the claim carries over:

1. **Plan fields** (PL101, PL102, PL110-PL114): the plan's shared-memory
   claim within the kernel's limit (PL101: ``autotune._smem_limit``, the
   policy budget for the fused kernels and ``dw_se``, ``DW_TILE_SMEM`` for
   ``dwconv2d``, a CTA's 227 KB for ``pwconv``) and equal to the planner's
   own model recomputed at the plan's fields (PL102, drift); every field a
   value the planners and their ``*_ladder`` searches can produce: the
   channel slice, chunk, cluster and depthwise channel group (PL110), the
   Co panel (PL111), the slab fields ``slab_h`` / ``n_slabs`` /
   ``halo_rows`` / ``tile_w`` and the CTA count (PL112), the ``pwconv``
   variant and tile (PL113), and what ``dw_se`` and ``se`` plans carry
   (PL114: the workspace of ``dw_se``'s reduce-FC shares; ``se``'s
   reduced width in ``block_g``).
2. **Launch shared memory** (PL103): each launch's dynamic shared memory,
   from the :class:`~repro_torch.kernels.gridspec.LaunchModel` the lowering
   will launch, over 232,448 B (error) or over the kernel's limit
   (warning).
3. **Grid enumeration** (PL120-PL123): every CTA of the launch (a sample
   above :data:`MAX_GRID_POINTS`, with an INFO diagnostic) is evaluated to
   prove its input window in bounds of the padded input and its output tile
   inside the output (PL120), the output tiles of every image and Co panel
   covering the output (PL121) with no two CTAs outside one cluster writing
   the same elements (PL122, a write race), and each cluster's members
   summing slices that cover the reduced channels exactly once (PL123, the
   counterpart of the reference's reduction-dimension rule).

Entry point: :func:`lint_chain`; :func:`chain_models` gives the launch
models for ``launch_check``; :func:`check_grid` is public so that tests can
corrupt a model directly.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.diagnostics import ERROR, INFO, WARNING, Diagnostic
from repro_torch.kernels import blocking, gridspec
from repro_torch.kernels.autotune import _SegGeom, _segment_geoms, _smem_limit
from repro_torch.kernels.blocking import BlockPlan, ChainPlan
from repro_torch.kernels.gridspec import LaunchModel

#: CTA count up to which a launch is enumerated in full; larger grids are
#: checked at per-dimension boundary samples (first, last, middle) and
#: coverage is skipped with an INFO diagnostic, never silently.
MAX_GRID_POINTS = 200_000


def walk_segments(spec, chain_plan: ChainPlan,
                  x_shape: Sequence[int]) -> List[_SegGeom]:
    """Per-segment kernel geometry: the autotuner's shape walk."""
    return _segment_geoms(spec.stages, chain_plan, x_shape)


def stream_dtype(chain_plan: ChainPlan,
                 dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The dtype the plan's segments stream at: ``dtype`` where given
    (the policy's stream dtype), else bf16 for a 2-byte plan and fp32 for
    a 4-byte one."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if chain_plan.dtype_bytes == 2 else torch.float32


def _geom_str(geom: _SegGeom) -> str:
    if geom.kind == "pw":
        return f"pw g={geom.g} ci={geom.ci} co={geom.co}"
    return (f"{geom.kind} b={geom.batch} ho={geom.ho} wo={geom.wo} "
            f"ci={geom.ci} c={geom.c} co={geom.co} stride={geom.stride} "
            f"hf={geom.hf}x{geom.wf}")


def _slab_heights(ho: int, tile_w: int) -> set:
    """The slab heights the fused ladders try at this tile width."""
    return {-(-ho // -(-ho // h)) for h in blocking._halvings(
        max(1, min(ho, blocking.SEP_MAX_PIXELS // tile_w)))}


# ---------------------------------------------------------------------------
# PL101, PL102, PL110-PL114: plan fields
# ---------------------------------------------------------------------------

def claimed_smem(geom: _SegGeom, plan: BlockPlan,
                 dtype: torch.dtype) -> int:
    """The planner's own shared-memory model at the plan's fields."""
    g, p = geom, plan
    tc = dtype == torch.bfloat16
    if g.kind in ("fused2", "fused3"):
        return blocking.separable_smem_bytes(
            ci=g.ci if g.kind == "fused3" else 0, c_slice=p.block_g,
            cb=p.block_c, panel=p.block_co, cluster=p.cluster,
            slab_h=p.slab_h, wo=g.wo, hi=g.hi, wi=g.wi, hf=g.hf, wf=g.wf,
            stride=g.stride, tc=tc)
    if g.kind == "fusedmb":
        return blocking.fused_mb_smem_bytes(
            ci=g.ci, c_slice=p.block_g, cb=p.block_c, panel=p.block_co,
            slab_h=p.slab_h, tile_w=p.tile_w, hf=g.hf, wf=g.wf,
            stride=g.stride, tc=tc)
    if g.kind == "dw":
        return blocking.dwconv2d_smem_bytes(p.slab_h, p.tile_w, p.block_c,
                                            g.hf, g.wf, g.stride, dtype)
    if g.kind == "dw_se":
        return blocking.dw_se_smem_bytes(1, p.slab_h, p.tile_w, p.block_c,
                                         g.hf, g.wf, g.stride, g.g, dtype)
    if g.kind == "pw":
        return blocking.pwconv_smem_bytes(p.variant, p.block_g, p.block_co,
                                          p.block_c, g.ci)
    if g.kind == "se":
        return blocking.plan_se(g.batch, g.c, g.g, dtype=dtype).smem_bytes
    return 0  # "mb": the plain dense conv, no kernel


def _fused_fields(g: _SegGeom, p: BlockPlan, err) -> None:
    cs, n = p.block_g, p.cluster
    slices = {blocking.separable_slice(g.c, k) for k in (1, 2, 4, 8)}
    if cs not in slices or n != -(-g.c // cs):
        err("PL110", f"channel slice {cs} with cluster {n} is not one the "
            f"planner splits C={g.c} into (slices {sorted(slices)}, "
            "cluster ceil(C / slice))",
            "blocking.separable_slice over clusters of 1, 2, 4 and 8")
        return
    most = min(cs, blocking.FUSED_MAX_CB) if g.kind == "fusedmb" else cs
    if p.block_c not in blocking._halvings(most):
        err("PL110", f"chunk block_c={p.block_c} is not a halving of the "
            f"slice's {most} channels", "blocking._halvings of the slice")
    tw = p.tile_w
    if g.kind == "fusedmb":
        if tw not in blocking._halvings(g.wo):
            err("PL112", f"tile_w={tw} is not a halving of wo={g.wo}")
            return
    elif tw != g.wo:
        err("PL112", f"tile_w={tw}, but separable_fused slabs are the full "
            f"width wo={g.wo}")
        return
    if p.block_co not in blocking._halvings(
            blocking.separable_panel(max(p.slab_h, 1) * tw, g.co), 8):
        err("PL111", f"block_co={p.block_co} is not a Co panel for co={g.co}"
            f" beside a {p.slab_h}x{tw} slab",
            "panels are halvings of blocking.separable_panel")
    _slab_fields(g, p, err, _slab_heights(g.ho, tw),
                 g.batch * -(-g.ho // max(p.slab_h, 1)) * -(-g.wo // tw) * n)


def _slab_fields(g: _SegGeom, p: BlockPlan, err, heights, ctas) -> None:
    """PL112: the slab height one the ladder tries, and the fields that
    follow from it."""
    sh = p.slab_h
    if sh < 1 or sh > g.ho or (heights is not None and sh not in heights):
        err("PL112", f"slab_h={sh} is not a slab height of ho={g.ho}"
            + (f" (the ladder's: {sorted(heights)})" if heights else ""))
        return
    n_slabs = -(-g.ho // sh)
    if p.n_slabs != n_slabs:
        err("PL112", f"n_slabs={p.n_slabs} but ceil(ho/slab_h)={n_slabs}")
    halo = max(g.hf - g.stride, 0) if n_slabs > 1 else 0
    if p.halo_rows != halo:
        err("PL112", f"halo_rows={p.halo_rows}, expected {halo} (hf-stride "
            "at interior seams)")
    if p.ctas != ctas:
        err("PL112", f"ctas={p.ctas}, but the launch has {ctas}")


def _dw_fields(g: _SegGeom, p: BlockPlan, err, dtype: torch.dtype,
               batch: int, max_tile_w: int) -> None:
    vec = blocking.dw_vector(g.c, dtype)
    nvec = -(-g.c // vec)
    most = min(nvec, blocking.DW_MAX_VECS if vec > 1 else 32)
    if (p.block_g != vec or p.block_c % vec
            or not 1 <= p.block_c // vec <= most):
        err("PL110", f"channel group block_c={p.block_c} of vectors "
            f"block_g={p.block_g} is not 1..{most} vectors of {vec} "
            f"channels (C={g.c})", "blocking.dwconv2d_ladder")
        return
    tw = p.tile_w
    if tw < blocking.DW_RUN or tw % blocking.DW_RUN or tw > max_tile_w:
        err("PL112", f"tile_w={tw} is not whole runs of {blocking.DW_RUN} "
            f"columns up to {max_tile_w}")
        return
    if (p.slab_h >= 1 and blocking.dw_threads(p.slab_h, tw, p.block_c, vec)
            > blocking.DW_THREADS):
        err("PL112", f"a {p.slab_h}x{tw}x{p.block_c} tile needs more than "
            f"{blocking.DW_THREADS} threads")
        return
    _slab_fields(g, p, err, None, batch * -(-g.ho // max(p.slab_h, 1))
                 * -(-g.wo // tw) * -(-g.c // p.block_c))


def lint_segment_fields(geom: _SegGeom, plan: BlockPlan, budget: int,
                        segment: str,
                        dtype: torch.dtype = torch.float32
                        ) -> List[Diagnostic]:
    """PL110-PL114 (fields), then PL102 (the claim against the planner's
    model, only where the fields are coherent) and PL101 (the claim
    against the kernel's limit), for one segment streamed at ``dtype``."""
    diags: List[Diagnostic] = []
    geo = _geom_str(geom)

    def err(rule, msg, hint=""):
        diags.append(Diagnostic(rule, ERROR, msg, segment, geo, hint))

    g, p = geom, plan
    if g.kind in ("fused2", "fused3", "fusedmb"):
        _fused_fields(g, p, err)
    elif g.kind == "dw":
        _dw_fields(g, p, err, dtype, 1,
                   min(blocking._up(g.wo, blocking.DW_RUN),
                       blocking.DW_MAX_TILE_W))
    elif g.kind == "dw_se":
        _dw_fields(g, p, err, dtype, g.batch, blocking.DW_MAX_TILE_W)
        per_image = p.ctas // max(g.batch, 1)
        if not diags and p.workspace_bytes != blocking.dw_se_workspace_bytes(
                g.batch, per_image, g.g):
            err("PL114", f"workspace_bytes={p.workspace_bytes} does not "
                f"carry {g.batch} images x {per_image} CTAs x c_se={g.g} "
                "fp32 shares of the reduce FC",
                "blocking.dw_se_workspace_bytes")
    elif g.kind == "pw":
        vec = blocking.pw_vector(g.co, dtype)
        why = None
        if p.variant not in blocking.PW_VARIANTS:
            why = f"unknown variant {p.variant!r}"
        elif not blocking._pw_variant_fits(p.variant, g.g, g.ci, g.co, dtype,
                                           True):
            why = (f"variant {p.variant} does not take a {g.g}x{g.ci} @ "
                   f"{g.ci}x{g.co} product at {dtype}")
        else:
            why = blocking.pwconv_tile_error(p.variant, p.block_g,
                                             p.block_co, p.block_c, ci=g.ci,
                                             vector=vec)
        if why is None:
            cluster = -(-g.ci // p.block_c) if p.variant == "stream" else 1
            if p.cluster != cluster:
                why = (f"cluster={p.cluster}, but the {p.variant} launch "
                       f"has {cluster}")
        if why is not None:
            err("PL113", why, "blocking.pwconv_ladder")
        if p.n_slabs != 1 or p.halo_rows != 0:
            err("PL112", f"pw segment carries slab fields (n_slabs="
                f"{p.n_slabs}, halo_rows={p.halo_rows})",
                "pwconv has no spatial slab dimension")
    elif g.kind == "se":
        if (p.block_g != g.g or p.block_c != g.c or p.n_slabs != 1
                or p.halo_rows != 0 or p.slab_h != 1):
            err("PL114", f"se plan (block_g={p.block_g}, block_c="
                f"{p.block_c}, slab_h={p.slab_h}, n_slabs={p.n_slabs}, "
                f"halo_rows={p.halo_rows}) does not carry c_se={g.g} in "
                f"block_g and C={g.c} in block_c with no slabs",
                "blocking.plan_se")
    else:  # "mb"
        if p.n_slabs != 1 or p.halo_rows != 0:
            err("PL112", f"mb segment carries slab fields (n_slabs="
                f"{p.n_slabs}, halo_rows={p.halo_rows})",
                "the plain dense conv has no spatial slab dimension")

    if not diags:
        # PL102 only where the fields are coherent: the model at corrupted
        # fields would double-report
        claimed = claimed_smem(g, p, dtype)
        if p.smem_bytes != claimed:
            diags.append(Diagnostic(
                "PL102", ERROR,
                f"smem_bytes={p.smem_bytes} but the planner model at these "
                f"blocks gives {claimed}", segment, geo,
                "the plan was hand-edited or the shared-memory model changed "
                "under a persisted plan: re-plan or re-tune"))
    limit = _smem_limit(g.kind, budget)
    if p.smem_bytes > limit:
        diags.append(Diagnostic(
            "PL101", ERROR,
            f"claimed smem_bytes={p.smem_bytes} exceeds the kernel's limit "
            f"{limit}", segment, geo,
            "shrink the tile (slab_h, chunk, panel) or raise "
            "policy.smem_budget"))
    return diags


# ---------------------------------------------------------------------------
# PL103 + PL120-PL123: launch shared memory and grid enumeration
# ---------------------------------------------------------------------------

def check_smem_derived(model: LaunchModel, limit: int, segment: str = "",
                       geometry: str = "") -> List[Diagnostic]:
    """PL103: the launch's dynamic shared memory against what a CTA may
    hold (error) and the kernel's limit (warning)."""
    geometry = geometry or model.name
    if model.smem > gridspec.MAX_SMEM:
        return [Diagnostic(
            "PL103", ERROR,
            f"{model.name} launches with {model.smem} B of shared memory a "
            f"CTA, more than {gridspec.MAX_SMEM} B", segment, geometry,
            "this launch cannot run on the card: shrink the tile")]
    if model.smem > limit:
        return [Diagnostic(
            "PL103", WARNING,
            f"{model.name} launches with {model.smem} B of shared memory a "
            f"CTA, over the limit {limit} B (a CTA may hold it)", segment,
            geometry, "fewer CTAs share an SM; consider a smaller tile")]
    return []


def _grid_samples(grid: Tuple[int, ...]):
    """Every grid index when affordable, else per-dim boundary samples."""
    total = grid[0] * grid[1] * grid[2]
    if total <= MAX_GRID_POINTS:
        return itertools.product(*(range(g) for g in grid)), True
    dims = [sorted({p for p in (0, g - 1, g // 2, min(1, g - 1),
                                max(g - 2, 0)) if 0 <= p < g}) for g in grid]
    return itertools.product(*dims), False


def _cover_diags(tiles: dict, shape: tuple, segment: str,
                 geometry: str) -> List[Diagnostic]:
    """PL121 (gaps) and PL122 (overlaps between tiles of different
    clusters) over the distinct clipped output tiles, cell by cell: the
    cells are the boxes between consecutive tile edges along each
    dimension, so a grid-aligned tiling has one cell a tile."""
    cuts = []
    for d, ext in enumerate(shape):
        edges = {0, ext}
        for box in tiles:
            edges.update(box[d])
        cuts.append(sorted(e for e in edges if 0 <= e <= ext))
    index = [{e: i for i, e in enumerate(c)} for c in cuts]
    seen: dict = {}
    for box, owner in tiles.items():
        spans = [range(index[d][lo], index[d][hi])
                 for d, (lo, hi) in enumerate(box)]
        for cell in itertools.product(*spans):
            prev = seen.setdefault(cell, owner)
            if prev != owner:
                lo = tuple(cuts[d][i] for d, i in enumerate(cell))
                return [Diagnostic(
                    "PL122", ERROR,
                    f"output elements at {lo} written by the CTAs of "
                    f"clusters {prev} and {owner}: a write race", segment,
                    geometry, "output tiles must be disjoint across "
                    "clusters")]
    n_cells = 1
    for c in cuts:
        n_cells *= len(c) - 1
    if len(seen) < n_cells:
        missing = next(cell for cell in itertools.product(
            *(range(len(c) - 1) for c in cuts)) if cell not in seen)
        lo = tuple(cuts[d][i] for d, i in enumerate(missing))
        return [Diagnostic(
            "PL121", ERROR,
            f"output coverage gap: the elements at {lo} of {shape} are "
            "never written", segment, geometry,
            "the grid does not tile the output: check the slab, tile and "
            "panel counts")]
    return []


def check_grid(model: LaunchModel, *, segment: str = "",
               geometry: str = "") -> List[Diagnostic]:
    """PL120-PL123 by enumerating the launch's CTAs (module docstring)."""
    diags: List[Diagnostic] = []
    geometry = geometry or f"{model.name} grid={model.grid}"
    points, full = _grid_samples(model.grid)
    if not full:
        diags.append(Diagnostic(
            "PL121", INFO,
            f"{model.name} grid {model.grid} too large for exhaustive "
            "coverage check; bounds checked at boundary samples only",
            segment, geometry))
    cx, cy, cz = model.cluster
    out_shape, in_shape = model.out_shape, model.in_shape
    tiles: dict = {}
    members: dict = {}
    bad_in = bad_out = False
    for x, y, z in points:
        w = model.work(x, y, z)
        if not bad_in:
            for d, ((lo, hi), ext) in enumerate(zip(w.window, in_shape)):
                if lo < 0 or hi > ext or lo >= hi:
                    diags.append(Diagnostic(
                        "PL120", ERROR,
                        f"{model.name} CTA {(x, y, z)} reads [{lo}, {hi}) "
                        f"of input dim {d} (extent {ext} after padding)",
                        segment, geometry,
                        "the window or the padding is wrong"))
                    bad_in = True
                    break
        box = tuple((lo, min(hi, ext)) for (lo, hi), ext
                    in zip(w.out, out_shape))
        if any(lo < 0 or lo >= hi for lo, hi in box):
            if not bad_out:
                diags.append(Diagnostic(
                    "PL120", ERROR,
                    f"{model.name} CTA {(x, y, z)} writes the tile {w.out} "
                    f"outside the output {out_shape}", segment, geometry,
                    "the grid has more tiles than the output"))
                bad_out = True
            continue
        owner = (x // cx, y // cy, z // cz)
        prev = tiles.setdefault(box, owner)
        if prev != owner and not any(d.rule == "PL122" for d in diags):
            diags.append(Diagnostic(
                "PL122", ERROR,
                f"{model.name} output tile {box} written by the CTAs of "
                f"clusters {prev} and {owner}: a write race", segment,
                geometry, "output tiles must be disjoint across clusters"))
        if model.reduce and full:
            members.setdefault(owner, []).append(w.red)
    for owner, slices in members.items():
        got = sorted(s for s in slices if s is not None)
        edge, ok = 0, len(got) == len(slices)
        for lo, hi in got:
            if lo != edge or hi <= lo:
                ok = False
                break
            edge = hi
        if not ok or edge != model.reduce:
            diags.append(Diagnostic(
                "PL123", ERROR,
                f"{model.name} cluster {owner} sums the slices {got} of the "
                f"reduced dim (extent {model.reduce}), not each channel "
                "exactly once", segment, geometry,
                "the cluster's members must split the reduction into "
                "disjoint slices that cover it"))
            break
    if full and not bad_out and not any(d.rule == "PL122" for d in diags):
        diags.extend(_cover_diags(tiles, out_shape, segment, geometry))
    return diags


# ---------------------------------------------------------------------------
# lint_chain: the whole pass over one planned chain
# ---------------------------------------------------------------------------

def chain_models(spec, chain_plan: ChainPlan, x_shape: Sequence[int],
                 dtype: Optional[torch.dtype] = None,
                 ) -> List[Tuple[str, _SegGeom, Optional[list]]]:
    """(segment label, geometry, its launch models) per segment; the models
    are None where the plan's fields are too corrupted to derive them (an
    ``mb`` segment has none by design: it is the plain dense conv)."""
    sdt = stream_dtype(chain_plan, dtype)
    out = []
    for si, (geom, seg) in enumerate(zip(
            walk_segments(spec, chain_plan, x_shape), chain_plan.segments)):
        try:
            models = gridspec.segment_models(geom, seg.plan, sdt)
        except (AssertionError, ArithmeticError, ValueError, KeyError):
            models = None
        out.append((f"seg{si}/{seg.kind}", geom, models))
    return out


def lint_chain(spec, chain_plan: ChainPlan, x_shape: Sequence[int], *,
               label: str = "chain",
               dtype: Optional[torch.dtype] = None) -> List[Diagnostic]:
    """The full planlint pass: fields, launch shared memory, grid proofs.
    ``dtype`` is the stream dtype (default: from the plan's width)."""
    diags: List[Diagnostic] = []
    sdt = stream_dtype(chain_plan, dtype)
    budget = chain_plan.smem_budget
    for (seg_label, geom, models), seg in zip(
            chain_models(spec, chain_plan, x_shape, sdt),
            chain_plan.segments):
        segment = f"{label}/{seg_label}"
        field_diags = lint_segment_fields(geom, seg.plan, budget, segment,
                                          sdt)
        diags.extend(field_diags)
        if any(d.severity == ERROR for d in field_diags):
            continue  # grid checks on corrupted fields would only cascade
        if models is None:
            diags.append(Diagnostic(
                "PL112", ERROR, "cannot derive the launches from this plan",
                segment, _geom_str(geom)))
            continue
        limit = _smem_limit(geom.kind, budget)
        for model in models:
            geo = f"{_geom_str(geom)} {model.name} grid={model.grid}"
            diags.extend(check_smem_derived(model, limit, segment, geo))
            diags.extend(check_grid(model, segment=segment, geometry=geo))
    return diags
