"""The runtime degradation ladder.

Counterpart of ``repro/runtime/ladder.py``, ported verbatim.  It mirrors
the planner's feasibility ladder (3-fused -> 2-fused -> unfused,
``core/chain.plan``) with one extra rung the planner cannot express: the
plain PyTorch version of the block (``kernels/ref.py``, ``impl="torch"``),
which runs on the same device, inside the same CUDA graph, and trades all
of the kernels' data-movement wins for the guarantee of running.

    RUNGS = fused3 -> fusedmb -> fused2 -> dw_se -> unfused -> ref

A failure maps to a BAN — the rung the quarantine removes — from the
segment tag the taxonomy carries:

* a ``fused3`` / ``fusedmb`` / ``fused2`` / ``dw_se`` segment failure bans
  exactly that fusion kind (the planner's next walk degrades the window
  one step — fusedmb to mb+pw, dw_se to dw+se);
* a standalone ``pw`` / ``dw`` / ``se`` / ``mb`` segment failure bans
  ``unfused`` — the standalone kernels themselves are unusable for this
  problem, so the block runs at the plain rung where the fault was
  injected (a real one raises instead, ``runtime/executor.py``; an ``se``
  failure is its two ``pwconv`` launches failing; ``mb`` is already the
  plain conv but shares the segment taxonomy);
* an untagged failure (chain-scope failure, numeric-guard trip on the
  final output) bans the highest rung the failing plan actually used.
"""
from __future__ import annotations

from typing import Optional

RUNGS = ("fused3", "fusedmb", "fused2", "dw_se", "unfused", "ref")


def plan_rung(cp) -> str:
    """The ladder rung a ChainPlan executes at: its highest fusion kind."""
    kinds = {seg.kind for seg in cp.segments}
    for r in ("fused3", "fusedmb", "fused2", "dw_se"):
        if r in kinds:
            return r
    return "unfused"


def ban_for_failure(failure, cp=None) -> str:
    """Which rung to quarantine for this classified failure (see module
    docstring); ``cp`` is the plan that was executing, for untagged
    failures."""
    if failure.segment_kind in ("fused3", "fusedmb", "fused2", "dw_se"):
        return failure.segment_kind
    if failure.segment_kind in ("pw", "dw", "se", "mb"):
        return "unfused"
    return plan_rung(cp) if cp is not None else "unfused"


def next_rung(ban: str, banned) -> str:
    """The rung the retry lands on after banning ``ban``, given the full
    banned set (for telemetry/warning messages).  Advisory: RUNGS
    interleaves both stage-algebra families (separable and SE/fused-MB),
    so the retry's ACTUAL rung is whatever the re-plan produces for the
    spec — a fused3 ban on a chain with no FusedMB stage lands on fused2,
    skipping the inapplicable fusedmb rung this names."""
    start = RUNGS.index(ban) + 1 if ban in RUNGS else len(RUNGS) - 1
    for r in RUNGS[start:]:
        if r == "ref" or r not in banned:
            return r
    return "ref"
