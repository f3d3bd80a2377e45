"""repro_torch.analysis — static plan and launch verifier.

Counterpart of ``repro/analysis``: proves a plan's claims before anything
runs, against the Hopper kernels this port launches and the H100's limits.
Three passes:

* ``planlint``     — plan fields, the shared-memory claims, and grid
  enumeration over the launch models (PL1xx), from
  :mod:`repro_torch.kernels.gridspec`, the launches the lowering makes.
* ``launch_check`` — the card's launch limits over the same models
  (LC2xx, where the reference has Mosaic's tiling rules, MC2xx).
* ``trace_audit``  — fusion and cast audits (JX3xx) over a trace of the
  lowered runner.

Entry points: :func:`analyze_chain` and :func:`analyze_network` return a
:class:`~repro_torch.analysis.diagnostics.Report`; :func:`verify_or_raise`
turns its errors into :class:`PlanVerificationError` (what
``KernelPolicy(verify=True)`` does where a plan is made);
:func:`lint_cached_plan` holds a replayed tune-cache entry to planlint;
``python -m repro_torch.analysis`` sweeps the benchmarked geometries and
the four bodies' network plans.  Everything here runs on a host with no
card: planning takes shapes only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.analysis import launch_check, planlint, trace_audit
from repro_torch.analysis.diagnostics import (ERROR, INFO, WARNING,
                                              Diagnostic, Report)
from repro_torch.kernels.blocking import ChainPlan
from repro_torch.kernels.policy import DEFAULT_POLICY, KernelPolicy

__all__ = [
    "Diagnostic", "Report", "PlanVerificationError",
    "analyze_chain", "analyze_network", "verify_or_raise",
    "lint_cached_plan", "ERROR", "WARNING", "INFO",
]


class PlanVerificationError(AssertionError):
    """A plan failed static verification; ``.report`` holds the findings."""

    def __init__(self, report: Report):
        self.report = report
        rules = ", ".join(report.rules(ERROR))
        super().__init__(
            f"plan verification failed ({rules}):\n"
            + "\n".join(d.format() for d in report.errors))


def analyze_chain(spec, chain_plan: ChainPlan, x_shape: Sequence[int], *,
                  dtype: torch.dtype = torch.float32,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  label: str = "chain", trace: bool = True,
                  device="cpu") -> Report:
    """All passes over one planned chain whose input is ``dtype``.
    ``trace=False`` skips the trace audit (at plan time the static passes
    are the cheap gate); ``device`` is where the trace runs."""
    sdt = policy.dtype_policy.stream_dtype(dtype)
    report = Report()
    report.extend(planlint.lint_chain(spec, chain_plan, x_shape,
                                      label=label, dtype=sdt))
    for seg_label, _geom, models in planlint.chain_models(
            spec, chain_plan, x_shape, sdt):
        for model in models or ():
            report.extend(launch_check.lint_model(model,
                                                  f"{label}/{seg_label}"))
    if trace:
        report.extend(trace_audit.lint_chain_trace(
            spec, chain_plan, x_shape, dtype=dtype, policy=policy,
            label=label, device=device))
    return report


def analyze_network(net, nplan, *, policy: KernelPolicy = DEFAULT_POLICY,
                    block_dtype_policies=None, trace: bool = True,
                    device="cpu") -> Report:
    """All passes over a resolved NetworkPlan: each block analyzed at the
    shape and dtype the plan walk recorded, under its effective policy."""
    from repro_torch.core.network import resolve_block_policies
    from repro_torch.kernels.policy import DTYPES
    policies = resolve_block_policies(net, policy, block_dtype_policies)
    report = Report()
    for i, (spec, cp, shape, dt, pol) in enumerate(zip(
            net.blocks, nplan.plans, nplan.block_shapes,
            nplan.block_dtypes, policies)):
        report.extend(analyze_chain(
            spec, cp, shape, dtype=DTYPES[dt], policy=pol,
            label=f"block{i}", trace=trace, device=device).diagnostics)
    return report


def verify_or_raise(report: Report) -> Report:
    """Raise :class:`PlanVerificationError` on any error diagnostic."""
    if not report.ok:
        raise PlanVerificationError(report)
    return report


def lint_cached_plan(spec, chain_plan: ChainPlan, x_shape: Sequence[int],
                     *, label: str = "cache",
                     dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Static validation of a replayed tune-cache entry (planlint, streamed
    at ``dtype``): the error rule ids as one string, or None when the plan
    is clean.  ``kernels/autotune.py`` calls it on every cache hit."""
    diags = planlint.lint_chain(spec, chain_plan, x_shape, label=label,
                                dtype=dtype)
    rules = sorted({d.rule for d in diags if d.severity == ERROR})
    return ", ".join(rules) if rules else None
