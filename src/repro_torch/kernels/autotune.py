"""Measured ChainPlan autotuner with a persistent on-disk cache.

Counterpart of ``repro/kernels/autotune.py`` (DESIGN.md §6).  The analytic
planner (``core/chain.plan`` -> ``kernels/blocking.py``) picks each
kernel's blocks by a fixed preference order read off the card; the fastest
plan that fits is not always the first one that order meets.  This module
closes that gap for a declared chain by measuring a pruned candidate set:

* **candidate ladder** — per chain segment, up to
  :data:`MAX_SEGMENT_CANDIDATES` plans the kernel launches, the analytic
  plan first.  Unlike the reference, whose ladders size TPU VMEM blocks,
  the ladders are the port's own plan searches for the Hopper kernels, in
  their own preference order (``blocking.separable_fused_ladder``,
  ``fused_mb_ladder``, ``dwconv2d_ladder``, ``dw_se_ladder``,
  ``pwconv_ladder``), taken one plan per structural choice (slab height
  and cluster of the fused kernels, channel group and tile width of the
  depthwise ones): the later terms of the searches' keys, such as the
  project panel, only break ties.  ``dw_se`` has a ladder here, where the
  reference has none (on the TPU any plan but full-channel, single-slab
  residency is wrong): the port's two-pass kernel is correct at every
  tile.  ``se`` and ``mb`` have none, as in the reference;
* **timing** — each candidate chain is lowered (``kernels/lowering.lower``
  runs plans verbatim) and, on the card, captured as a CUDA graph of
  :data:`GRAPH_CALLS` calls (``measure.graph_ms``; a graph replay is what
  the main path runs), timed with CUDA events: ``warmup`` replays, then the
  median of ``repeats``; each candidate's graph and pool are released
  before the next is captured.  On the CPU it is the host clock around
  eager calls, as in the reference;
* **persistent cache** — winners go to a JSON file keyed on the problem
  signature: the stages, the input shape and dtype, the dtype policy,
  whether fusion is allowed (the reference's key omits it, so its fused and
  unfused plans of one problem would share an entry), the shared-memory
  budget, the ``pwconv`` tile overrides where set (the lowering lets them
  override the plan), and the backend: the resolved impl, the device's name
  and compute capability, the torch and CUDA versions and, for the
  kernels, a digest of their build identity (``_build.library_path``), so
  that a winner measured with other kernel sources never replays.  A
  corrupted file loads as empty; a cached plan that fails the static
  verifier's planlint (``analysis.lint_cached_plan``, as the reference
  holds its cache) or is no longer one of its segments' candidates is
  dropped with a warning and the caller re-plans.

A candidate must beat the incumbent by more than :data:`REL_IMPROVEMENT`
to win, so measurement noise cannot flip plans between runs.

Failures: under the default ``KernelPolicy(on_failure="raise")`` a
candidate that fails to launch raises, naming the segment and the plan,
and nothing is written to the cache: every ladder candidate is meant to be
feasible, so a failing one is a kernel or planner bug.  Under
``on_failure="degrade"``, as in the reference
(``repro/kernels/autotune.py:520-560``), a candidate whose failure the
runtime's whitelist recognizes (``runtime/failures.classify``: an injected
fault, a launch the driver refused for its configuration, an out-of-memory
error) loses at its first attempt with an infinite time and is recorded in
the entry's ``failed`` list (empty when every candidate ran); when every
candidate failed, the analytic plan is returned and nothing is persisted.
Unlike the reference, a failed measurement is not retried: the refused
launches are deterministic for a plan.  Any other exception (a bug, a
failed build, a sticky CUDA error) raises under either policy.  Measuring
inside a CUDA-graph capture raises.  Under ``"degrade"`` a cached winner
that uses a quarantined rung (``runtime/quarantine.py``) is dropped with a
warning and the caller re-plans around the ban.

Entry points: ``core/chain.execute(policy=KernelPolicy(autotune=True))``
measures on the first call and replays the cache afterwards;
``core/chain.plan`` consults :func:`lookup_cached_plan`;
``core/network.tune_network`` tunes a whole body block by block.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import statistics
import time
import warnings
from typing import Optional, Sequence

import torch

from repro_torch import measure
from repro_torch.kernels import _build, blocking, lowering
from repro_torch.kernels.blocking import BlockPlan, ChainPlan, ChainSegment
from repro_torch.kernels.diskstore import VersionedJsonStore
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.runtime import failures

#: Cache-file schema version of the port's own cache; bump on an
#: incompatible layout change (old files then read as empty and re-tune).
CACHE_VERSION = 1

#: Candidates measured per chain segment (the analytic plan included).
MAX_SEGMENT_CANDIDATES = 8

#: A candidate must beat the incumbent by this relative margin to win.
REL_IMPROVEMENT = 0.02

#: Calls of a candidate chain in one timed CUDA graph (its replay time is
#: divided by them): a microsecond chain is timed well above the events'
#: resolution.
GRAPH_CALLS = 5


def default_cache_path() -> str:
    """``$REPRO_TORCH_TUNE_CACHE``, else ``autotune.json`` beside the
    kernels' libraries in the checkout's ``build/repro_torch/`` (ignored by
    git); never the reference's file."""
    return (os.environ.get("REPRO_TORCH_TUNE_CACHE")
            or str(_build.BUILD_DIR / "autotune.json"))


def cache_path(policy: KernelPolicy) -> str:
    return policy.tune_cache or default_cache_path()


# ---------------------------------------------------------------------------
# Problem signature: the cache key schema
# ---------------------------------------------------------------------------

def _stage_signature(s) -> dict:
    """Duck-typed stage descriptor, the reference's.  Order matters: SE is
    the only stage with ``reduce``; FusedMB has BOTH ``features`` and
    ``stride`` (a PW has only ``features``)."""
    if hasattr(s, "reduce"):
        return {"kind": "se", "reduce": int(s.reduce),
                "activation": s.activation}
    if hasattr(s, "features") and hasattr(s, "stride"):
        return {"kind": "mb", "features": int(s.features),
                "stride": int(s.stride), "hf": int(s.hf), "wf": int(s.wf),
                "padding": s.padding.lower(), "activation": s.activation,
                "bias": bool(s.bias)}
    if hasattr(s, "features"):
        return {"kind": "pw", "features": int(s.features),
                "activation": s.activation, "bias": bool(s.bias)}
    return {"kind": "dw", "stride": int(s.stride), "hf": int(s.hf),
            "wf": int(s.wf), "padding": s.padding.lower(),
            "activation": s.activation, "bias": bool(s.bias)}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def default_device() -> torch.device:
    """The card where there is one, else the CPU: where a tensor of the
    entry points lands unless the caller asks otherwise."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def device_identity(device) -> dict:
    """The device's name and compute capability (the CPU has none)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": dev.type, "capability": None}
    return {"device": torch.cuda.get_device_name(dev),
            "capability": list(torch.cuda.get_device_capability(dev))}


@functools.lru_cache(maxsize=1)
def kernels_digest() -> str:
    """Digest of every kernel library's build identity (its hashed name
    covers the source, the headers and the flags)."""
    names = " ".join(_build.library_path(n).name for n in _build.SOURCES)
    return hashlib.sha256(names.encode()).hexdigest()[:16]


def backend_fingerprint(policy: KernelPolicy, device) -> dict:
    """What makes a measurement transferable: the same resolved impl on
    the same kind of device, with the same torch and CUDA and (for the
    kernels) the same kernel sources.  Resolved as ``policy.resolved``
    does, without its check: a plan is keyed even where it will not run."""
    dev = torch.device(device)
    impl = (policy.impl if policy.impl != "auto"
            else "cuda" if dev.type == "cuda" else "torch")
    return {"impl": impl, **device_identity(device),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernels": kernels_digest() if impl == "cuda" else None}


def problem_signature(spec, x_shape: Sequence[int], dtype: torch.dtype,
                      policy: KernelPolicy, device=None) -> dict:
    """The full serialized problem identity a measurement is valid for, on
    ``device`` (default: :func:`default_device`)."""
    residual = spec.residual
    sig = {
        "stages": [_stage_signature(s) for s in spec.stages],
        "residual": residual if isinstance(residual, bool) else str(residual),
        "x_shape": [int(v) for v in x_shape],
        "dtype": dtype_name(dtype),
        "dtype_policy": policy.dtype_policy.signature(),
        "fusion": policy.fusion_allowed,
        "smem_budget": int(policy.smem_budget),
        "backend": backend_fingerprint(policy, device or default_device()),
    }
    for name in ("block_g", "block_co", "block_ci"):
        if getattr(policy, name):
            sig[name] = int(getattr(policy, name))
    return sig


def signature_digest(signature: dict) -> str:
    """Stable digest of a JSON signature: a cache key."""
    blob = json.dumps(signature, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:20]


def problem_key(spec, x_shape: Sequence[int], dtype: torch.dtype,
                policy: KernelPolicy, device=None) -> str:
    """The cache key: the digest of :func:`problem_signature`."""
    return signature_digest(problem_signature(spec, x_shape, dtype, policy,
                                              device))


# ---------------------------------------------------------------------------
# ChainPlan (de)serialization
# ---------------------------------------------------------------------------

_PLAN_FIELDS = {f.name: (str if f.name == "variant" else int)
                for f in dataclasses.fields(BlockPlan)}


def serialize_chain_plan(cp: ChainPlan) -> dict:
    return {
        "segments": [
            {"kind": s.kind, "stages": list(s.stages),
             "plan": dataclasses.asdict(s.plan)}
            for s in cp.segments],
        "residual": bool(cp.residual),
        "residual_fused": bool(cp.residual_fused),
        "dtype_bytes": int(cp.dtype_bytes),
        "smem_budget": int(cp.smem_budget),
    }


def _deserialize_block_plan(d: dict) -> BlockPlan:
    if set(d) != set(_PLAN_FIELDS):
        raise ValueError(f"BlockPlan fields {sorted(d)}")
    return BlockPlan(**{k: conv(d[k]) for k, conv in _PLAN_FIELDS.items()})


def deserialize_chain_plan(d: dict) -> ChainPlan:
    """The inverse of :func:`serialize_chain_plan`; raises KeyError,
    TypeError or ValueError on a malformed dict."""
    segments = tuple(
        ChainSegment(kind=s["kind"], stages=tuple(int(i) for i in s["stages"]),
                     plan=_deserialize_block_plan(s["plan"]))
        for s in d["segments"])
    return ChainPlan(
        segments=segments,
        residual=bool(d["residual"]),
        residual_fused=bool(d["residual_fused"]),
        dtype_bytes=int(d["dtype_bytes"]),
        smem_budget=int(d["smem_budget"]),
    )


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------

class TuneCache(VersionedJsonStore):
    """JSON-file-backed map ``key -> {signature, plan, measured_us, ...}``
    (:class:`~repro_torch.kernels.diskstore.VersionedJsonStore`: a missing
    file loads silently, a corrupted one warns and loads as empty, and save
    merges on write and replaces the file atomically)."""

    version = CACHE_VERSION


# ---------------------------------------------------------------------------
# Candidate enumeration (the pruned ladder the tuner measures)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SegGeom:
    """Shapes a segment's kernel sees: what its ladder needs."""
    kind: str
    ho: int
    wo: int
    ci: int        # segment input channels (raw input for fused3/fusedmb)
    c: int         # DW / expanded width (fused segments)
    co: int        # output channels
    stride: int
    hf: int
    wf: int
    g: int         # GEMM rows (pw); SE reduced width (dw_se / se)
    residual: bool  # the folded residual rides this segment's kernel
    batch: int
    hi: int        # the segment's input rows and columns
    wi: int


def _segment_geoms(stages, cp: ChainPlan,
                   x_shape: Sequence[int]) -> list:
    """Walk the chain shapes segment by segment (duck-typed on the stage
    objects, as the reference's walk)."""
    b, h, w, c = (int(v) for v in x_shape)
    geoms = []
    for si, seg in enumerate(cp.segments):
        with_res = bool(cp.residual_fused and si == len(cp.segments) - 1)
        st = [stages[i] for i in seg.stages]
        if seg.kind in ("fused3", "fused2", "fusedmb"):
            conv, proj = st[-2], st[-1]
            width = st[0].features if seg.kind != "fused2" else c
            ho, wo = conv.out_dims(h, w)
            geoms.append(_SegGeom(seg.kind, ho, wo, c, width, proj.features,
                                  conv.stride, conv.hf, conv.wf, 0, with_res,
                                  b, h, w))
            c = proj.features
        elif seg.kind == "dw_se":
            d, se = st
            ho, wo = d.out_dims(h, w)
            geoms.append(_SegGeom("dw_se", ho, wo, c, c, c, d.stride, d.hf,
                                  d.wf, se.reduce, False, b, h, w))
        elif seg.kind == "se":
            geoms.append(_SegGeom("se", h, w, c, c, c, 1, 0, 0, st[0].reduce,
                                  False, b, h, w))
            ho, wo = h, w
        elif seg.kind == "mb":
            mb = st[0]
            ho, wo = mb.out_dims(h, w)
            geoms.append(_SegGeom("mb", ho, wo, c, mb.features, mb.features,
                                  mb.stride, mb.hf, mb.wf, 0, False, b, h, w))
            c = mb.features
        elif seg.kind == "pw":
            geoms.append(_SegGeom("pw", h, w, c, 0, st[0].features, 1, 0, 0,
                                  b * h * w, False, b, h, w))
            ho, wo, c = h, w, st[0].features
        else:  # "dw"
            d = st[0]
            ho, wo = d.out_dims(h, w)
            geoms.append(_SegGeom("dw", ho, wo, c, c, c, d.stride, d.hf,
                                  d.wf, 0, False, b, h, w))
        h, w = ho, wo
    return geoms


def _ladder(geom: _SegGeom, dtype: torch.dtype, smem_budget: int) -> tuple:
    """The kernel's own plan search for this segment, its plan first."""
    g = geom
    if g.kind in ("fused2", "fused3"):
        return blocking.separable_fused_ladder(
            g.ho, g.wo, g.ci if g.kind == "fused3" else 0, g.c, g.co,
            stride=g.stride, hf=g.hf, wf=g.wf, dtype=dtype,
            smem_budget=smem_budget, batch=g.batch, hi=g.hi, wi=g.wi)
    if g.kind == "fusedmb":
        return blocking.fused_mb_ladder(
            g.ho, g.wo, g.ci, g.c, g.co, stride=g.stride, hf=g.hf, wf=g.wf,
            dtype=dtype, smem_budget=smem_budget, batch=g.batch)
    if g.kind == "dw":
        return blocking.dwconv2d_ladder(g.ho, g.wo, g.c, g.hf, g.wf,
                                        stride=g.stride, dtype=dtype)
    if g.kind == "dw_se":
        return blocking.dw_se_ladder(
            g.ho, g.wo, g.c, g.g, g.hf, g.wf, stride=g.stride, dtype=dtype,
            batch=g.batch, smem_budget=smem_budget)
    if g.kind == "pw":
        return blocking.pwconv_ladder(g.g, g.ci, g.co, dtype=dtype)
    return ()  # "se", "mb": no ladder, as in the reference


#: The plan fields that make two candidates of a kind different kernels'
#: work; the ladder's later plans that repeat them only break ties.
_STRUCTURE = {"fused2": ("slab_h", "cluster"), "fused3": ("slab_h", "cluster"),
              "fusedmb": ("slab_h", "tile_w", "cluster"),
              "dw": ("block_c", "tile_w"), "dw_se": ("block_c", "tile_w")}


def _structure(kind: str, p: BlockPlan):
    fields = _STRUCTURE.get(kind)
    return p if fields is None else tuple(getattr(p, f) for f in fields)


def segment_candidates(geom: _SegGeom, base: BlockPlan, dtype: torch.dtype,
                       smem_budget: int,
                       max_candidates: int = MAX_SEGMENT_CANDIDATES,
                       ) -> list:
    """Up to ``max_candidates`` plans for one segment at the stream
    ``dtype``, ``base`` (the analytic plan) first, then the segment's
    ladder in its order, one plan per structural choice."""
    cands, seen = [base], {_structure(geom.kind, base)}
    for p in _ladder(geom, dtype, smem_budget):
        if len(cands) >= max_candidates:
            break
        s = _structure(geom.kind, p)
        if s not in seen:
            seen.add(s)
            cands.append(p)
    return cands


def _with_segment_plan(cp: ChainPlan, si: int, plan: BlockPlan) -> ChainPlan:
    segments = tuple(
        dataclasses.replace(seg, plan=plan) if i == si else seg
        for i, seg in enumerate(cp.segments))
    return dataclasses.replace(cp, segments=segments)


# ---------------------------------------------------------------------------
# Validating a cached plan
# ---------------------------------------------------------------------------

def _smem_limit(kind: str, smem_budget: int) -> int:
    """Shared memory a segment's kernel may claim a CTA: the budget for the
    fused kernels and ``dw_se``, ``dwconv2d``'s tile limit, and for
    ``pwconv`` (and the ``se`` GEMMs) whatever one CTA may hold."""
    if kind == "dw":
        return blocking.DW_TILE_SMEM
    if kind in blocking.FUSED_KINDS or kind == "dw_se":
        return smem_budget
    return blocking.DEFAULT_SMEM_BUDGET


def plan_mismatch(spec, cp: ChainPlan, x_shape: Sequence[int],
                  base_plan: ChainPlan, dtype: torch.dtype) -> Optional[str]:
    """Why ``cp`` is not a plan the tuner could have chosen for this chain
    (``base_plan`` its analytic plan at the stream ``dtype``), or None:
    its segments' kinds and stages must be the chain's segment walk, each
    segment's plan one of :func:`segment_candidates` for its geometry, and
    its shared memory within the kernel's limit by the kernel's model."""
    for name in ("residual", "residual_fused", "dtype_bytes", "smem_budget"):
        if getattr(cp, name) != getattr(base_plan, name):
            return (f"its {name} {getattr(cp, name)} is not the chain's "
                    f"{getattr(base_plan, name)}")
    walk = [(s.kind, s.stages) for s in base_plan.segments]
    if [(s.kind, s.stages) for s in cp.segments] != walk:
        return f"its segments are not the chain's segment walk {walk}"
    geoms = _segment_geoms(spec.stages, base_plan, x_shape)
    for si, (geom, seg, bseg) in enumerate(zip(geoms, cp.segments,
                                               base_plan.segments)):
        if seg.plan not in segment_candidates(geom, bseg.plan, dtype,
                                              cp.smem_budget):
            return (f"segment {si} ({seg.kind}) plan {seg.plan} is not one "
                    "of its candidates")
        if seg.plan.smem_bytes > _smem_limit(seg.kind, cp.smem_budget):
            return (f"segment {si} ({seg.kind}) claims {seg.plan.smem_bytes}"
                    f" B of shared memory, more than "
                    f"{_smem_limit(seg.kind, cp.smem_budget)}")
    return None


def cached_plan_problem(spec, cp: ChainPlan, x_shape: Sequence[int],
                        base_plan: ChainPlan,
                        dtype: torch.dtype) -> Optional[str]:
    """Why a replayed plan must not run, or None: first the static
    verifier's planlint (``analysis.lint_cached_plan``, as the reference
    holds its cache, ``repro/kernels/autotune.py:208-209``), then
    :func:`plan_mismatch`."""
    from repro_torch.analysis import lint_cached_plan  # analysis sits above
    rules = lint_cached_plan(spec, cp, x_shape, dtype=dtype)
    if rules is not None:
        return f"it failed planlint ({rules})"
    return plan_mismatch(spec, cp, x_shape, base_plan, dtype)


def validate_cached_plan(spec, cp: ChainPlan, x_shape: Sequence[int],
                         key: str, path: str, base_plan: ChainPlan,
                         dtype: torch.dtype) -> Optional[ChainPlan]:
    """``cp`` when :func:`cached_plan_problem` finds nothing, else None
    with a warning naming the cache path, the key and the problem (the
    planlint rule ids, or the mismatch): an entry that a planner or kernel
    change left behind, or one edited by hand, is dropped and the caller
    re-plans (a stale cache is a performance artifact; the kernel still
    runs)."""
    why = cached_plan_problem(spec, cp, x_shape, base_plan, dtype)
    if why is None:
        return cp
    warnings.warn(
        f"dropping tune-cache entry {key} from {path}: {why}; falling back "
        "to the analytic plan (the entry is stale: delete the cache or "
        "re-tune)", stacklevel=3)
    return None


def _quarantined(cp: ChainPlan, key: str, path: str,
                 policy: KernelPolicy) -> bool:
    """Under ``on_failure="degrade"``: whether ``cp`` uses a rung that the
    quarantine bans for ``key`` (warned about: the winner must not replay,
    the planner degrades around it).  Never true under ``"raise"``."""
    if policy.on_failure != "degrade":
        return False
    from repro_torch.runtime import quarantine  # runtime sits above
    banned = quarantine.load(quarantine.quarantine_path(policy)).banned(key)
    if not quarantine.uses_banned(cp, banned):
        return False
    warnings.warn(
        f"dropping tune-cache entry {key} from {path}: its plan uses "
        f"quarantined rungs ({sorted(banned)} banned); the analytic planner "
        "will degrade around them", stacklevel=4)
    return True


def _cached_plan(spec, entry: Optional[dict], x_shape, key: str, path: str,
                 base_plan: ChainPlan, dtype: torch.dtype,
                 policy: KernelPolicy) -> Optional[ChainPlan]:
    """The entry's plan, decoded, not quarantined, and validated; or None."""
    if entry is None:
        return None
    try:
        cp = deserialize_chain_plan(entry["plan"])
    except (KeyError, TypeError, ValueError):
        return None  # undecodable: re-tune and overwrite
    if _quarantined(cp, key, path, policy):
        return None
    return validate_cached_plan(spec, cp, x_shape, key, path, base_plan,
                                dtype)


def lookup_cached_plan(spec, x_shape: Sequence[int], dtype: torch.dtype,
                       policy: KernelPolicy, *, base_plan: ChainPlan,
                       device=None) -> Optional[ChainPlan]:
    """Pure cache consult (no measurement): the tuned ChainPlan for this
    problem on ``device``, or None on a miss, an undecodable or invalid
    entry, or (under ``on_failure="degrade"``) a winner that uses a
    quarantined rung.  ``base_plan`` is the chain's analytic plan."""
    path = cache_path(policy)
    key = problem_key(spec, x_shape, dtype, policy, device)
    return _cached_plan(spec, TuneCache.load(path).get(key), x_shape, key,
                        path, base_plan,
                        policy.dtype_policy.stream_dtype(dtype), policy)


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------

def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def measure_run(run, params, x: torch.Tensor, *, warmup: int = 1,
                repeats: int = 5) -> float:
    """Median seconds of one ``run(params, x)``.  On the card: a CUDA graph
    of :data:`GRAPH_CALLS` calls (``measure.graph_ms``: three eager calls
    on a side stream build the kernels first), ``warmup`` untimed replays,
    then the median of ``repeats`` replays timed with CUDA events; the
    graph and its pool are released before it returns.  On the CPU: the
    host clock around ``warmup`` untimed and ``repeats`` timed eager
    calls."""
    with torch.inference_mode():
        if x.device.type == "cuda":
            return measure.graph_ms(lambda: run(params, x), x.device,
                                    launches=GRAPH_CALLS,
                                    reps=max(repeats, 1),
                                    warmup=warmup) / 1e3
        for _ in range(max(warmup, 1)):
            run(params, x)
        ts = []
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            run(params, x)
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """What one autotune consult answered: the plan to execute, whether it
    replayed the cache (``n_measured == 0`` then), the timings behind the
    decision (microseconds; on a hit, as recorded at tune time) and, on a
    miss, every chain plan measured with its seconds and every candidate
    that failed (``{"candidate", "error"}`` records, as in the entry's
    ``failed`` list).  ``n_measured`` counts the plans timed, failed ones
    included; ``measured_us`` is infinite when every one failed."""
    plan: ChainPlan
    cache_hit: bool
    measured_us: float
    analytic_us: float
    n_measured: int
    key: str
    cache_path: str
    measured: tuple = ()
    failed: tuple = ()


def autotune_chain(spec, params, x: torch.Tensor, *, policy: KernelPolicy,
                   base_plan: ChainPlan, warmup: int = 1, repeats: int = 5,
                   max_candidates: int = MAX_SEGMENT_CANDIDATES,
                   cache: Optional[TuneCache] = None) -> AutotuneResult:
    """Measured plan selection for one declared chain at one input.

    Cache hit: decode, validate and return the stored winner with ZERO
    measurements.  Miss: time the analytic ``base_plan``, then
    coordinate-descend over the per-segment candidates (vary one segment,
    the others at the incumbent), timing the WHOLE chain each time, and
    persist the winner.  The analytic plan is always a candidate.  Under
    ``policy.on_failure == "degrade"`` a candidate whose failure is
    classified (``runtime/failures.classify``) loses with an infinite time
    and is recorded in the entry's ``failed`` list; when every candidate
    failed, ``base_plan`` is returned and nothing is persisted.  Any other
    failure, and under the default ``"raise"`` every failure, raises with a
    note naming the segment and the plan, and nothing is written; so does a
    miss inside a CUDA-graph capture.  Under ``on_failure="degrade"`` a cached winner
    that uses a quarantined rung is a miss, and the tune runs again around
    ``base_plan`` (which the caller planned around the ban).
    """
    path = cache_path(policy)
    if cache is None:
        cache = TuneCache.load(path)
    key = problem_key(spec, x.shape, x.dtype, policy, x.device)
    entry = cache.get(key)
    sdt = policy.dtype_policy.stream_dtype(x.dtype)
    plan = _cached_plan(spec, entry, x.shape, key, path, base_plan, sdt,
                        policy)
    if plan is not None:
        return AutotuneResult(
            plan=plan, cache_hit=True,
            measured_us=float(entry.get("measured_us", 0.0)),
            analytic_us=float(entry.get("analytic_us", 0.0)),
            n_measured=0, key=key, cache_path=path)
    if capturing():
        raise RuntimeError(
            f"autotune: tune-cache miss for {key} inside a CUDA-graph "
            "capture; measuring there would record the candidates into the "
            "graph (tune before capturing)")

    measured, failed = [], []

    def timed(cp: ChainPlan, what: str) -> float:
        try:
            t = measure_run(lowering.lower(spec, cp, policy), params, x,
                            warmup=warmup, repeats=repeats)
        except Exception as e:
            if (policy.on_failure != "degrade"
                    or failures.classify(e) is None):
                e.add_note(f"autotune: while timing {what} of tune-cache "
                           f"key {key}; nothing was written to {path}")
                raise
            # a candidate that cannot run loses; the failure is recorded
            failed.append({"candidate": what,
                           "error": f"{type(e).__name__}: {e}"[:200]})
            return float("inf")
        measured.append((cp, t))
        return t

    t_base = timed(base_plan, "the analytic plan")
    best, t_best = base_plan, t_base
    for si, geom in enumerate(_segment_geoms(spec.stages, base_plan,
                                             x.shape)):
        incumbent = best.segments[si].plan
        for cand in segment_candidates(geom, incumbent, sdt,
                                       base_plan.smem_budget,
                                       max_candidates):
            if cand == incumbent:
                continue
            cp = _with_segment_plan(best, si, cand)
            t = timed(cp, f"segment {si} ({geom.kind}) at {cand}")
            if t < t_best * (1.0 - REL_IMPROVEMENT):
                best, t_best = cp, t
    n_measured = len(measured) + len(failed)
    if t_best == float("inf"):
        # every candidate failed: nothing to persist; the analytic plan
        # goes back unpersisted, for the caller's own failure handling
        warnings.warn(
            f"autotune: every candidate failed to run for {key} "
            f"({len(failed)} failures, first: {failed[0]['error']}); "
            "returning the analytic plan unpersisted", stacklevel=2)
        return AutotuneResult(plan=base_plan, cache_hit=False,
                              measured_us=t_best, analytic_us=t_base,
                              n_measured=n_measured, key=key,
                              cache_path=path, failed=tuple(failed))
    cache.put(key, {
        "signature": problem_signature(spec, x.shape, x.dtype, policy,
                                       x.device),
        "plan": serialize_chain_plan(best),
        "measured_us": t_best * 1e6,
        "analytic_us": t_base * 1e6,
        "n_measured": n_measured,
        "failed": failed,
    })
    cache.save()
    return AutotuneResult(plan=best, cache_hit=False,
                          measured_us=t_best * 1e6, analytic_us=t_base * 1e6,
                          n_measured=n_measured, key=key, cache_path=path,
                          measured=tuple(measured), failed=tuple(failed))
