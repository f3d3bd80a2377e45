"""Fault-tolerant execution: the degradation ladder's driver.

Counterpart of ``repro/runtime/executor.py``.  ``core/chain.execute`` and
``core/network.execute_network`` route here under an explicit
``KernelPolicy(on_failure="degrade")`` (the reference's default; the port's
is ``"raise"``) or with ``policy.numeric_guard``.  The steady state is the
production path — the same plan, the same lowering, the same CUDA graph —
plus one ``try``; only a classified failure enters the ladder:

1. classify (``runtime/failures.py``): anything off the whitelist (a bug,
   a failed build, a sticky CUDA error) re-raises unwrapped, and
   ``on_failure="raise"`` propagates the taxonomy error;
2. quarantine the rung the failure maps to (``runtime/ladder.py``) in the
   persistent store (``runtime/quarantine.py``): later calls and processes
   skip it with zero retries;
3. re-plan one rung down and retry, bounded by the ladder's length, each
   fallback recorded in telemetry and warned about;
4. the last rung runs the analytic plan's plain version (``impl="torch"``,
   ``kernels/ref.py``) on the same device, with fault injection
   suppressed: the rung of last resort cannot itself be injected away.
   Only an injected fault reaches it.  A real failure moves down the
   kernel rungs only: where it would ban ``unfused`` (the standalone
   kernels failed), no kernel rung is left and it raises, with no ban
   written, so no real kernel failure is ever hidden behind the plain
   version.  A numeric-guard trip whose input was already non-finite
   blames no kernel: it raises and quarantines nothing.

The whole network keeps its one-graph fast path: on a classified failure
of the graph (raised while it was planned, warmed up or captured, or by
the numeric guard on its output) the failing call recovers with per-block
guarded chains, run eagerly; each block quarantines its own problem, and
since a failing plan is never memoized (``core/network``), the next call
plans around the bans and captures a new graph, in which a block with
``unfused`` banned runs its plain version.  An eager recovery's result is
never memoized.

On the card a failure can surface only where host code runs: while the
graph is planned, warmed up or captured, never in a replay.  Inside an
outer capture nothing can recover (an eager re-run would be recorded into
that capture): a failure there propagates even under ``"degrade"``, and
the numeric guard, a host sync, does not run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from repro_torch.runtime import (failures, faultinject, ladder, quarantine,
                                 telemetry)

#: One attempt per ladder rung:
#: fused3 -> fusedmb -> fused2 -> dw_se -> unfused -> ref.
MAX_ATTEMPTS = len(ladder.RUNGS)


def _capturing(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _require_finite(y: torch.Tensor, *, scope: str, injected: bool) -> None:
    """The ``policy.numeric_guard`` check: a host-side all-finite test of
    the output (a sync — the price of the guard; never inside a capture)."""
    if not bool(torch.isfinite(y.float()).all()):
        raise failures.NumericalFailure(
            f"non-finite values in {scope} output (numeric_guard)",
            injected=injected)


def _guard(point: str, y: torch.Tensor, *, scope: str) -> torch.Tensor:
    """``numeric:*`` injection, then the finite check."""
    poisoned = faultinject.poison(point, y)
    _require_finite(poisoned, scope=scope, injected=poisoned is not y)
    return poisoned


def _unrecoverable(failure, x: torch.Tensor, ban: str) -> str:
    """Why a classified failure must raise instead of degrading, or "":
    a numeric trip on a non-finite input (no kernel is to blame), or a
    real failure that would ban ``unfused`` (no kernel rung is left, and
    only an injected fault may reach the plain rung)."""
    if (isinstance(failure, failures.NumericalFailure)
            and not failure.injected
            and not bool(torch.isfinite(x.float()).all())):
        return ("the input was already non-finite, so no kernel is to "
                "blame; nothing was quarantined")
    if ban == "unfused" and not failure.injected:
        return ("no kernel rung is left below the standalone kernels, and "
                "the plain version stands in only for an injected fault; "
                "nothing was quarantined")
    return ""


def execute_chain(spec, params, x, *, policy, chain_plan=None):
    """Guarded ``chain.execute``: the ladder loop described above."""
    from repro_torch.core import chain  # core sits above the runtime layer
    from repro_torch.kernels import autotune, lowering

    degrade = policy.on_failure == "degrade"
    capturing = _capturing(x)
    key = autotune.problem_key(spec, x.shape, x.dtype, policy, x.device)
    qpath = quarantine.quarantine_path(policy)
    q = quarantine.load(qpath)
    banned = set(q.banned(key)) if degrade else set()
    supplied = chain_plan
    if supplied is not None and quarantine.uses_banned(supplied, banned):
        warnings.warn(
            f"ignoring supplied chain_plan for {key}: it uses quarantined "
            f"rungs ({sorted(banned)} banned in {qpath})",
            RuntimeWarning, stacklevel=3)
        supplied = None
    if banned:
        telemetry.record_quarantine_hit(scope="chain", key=key,
                                        banned=banned)
    cp = None
    failure = None
    for attempt in range(MAX_ATTEMPTS):
        ref_mode = degrade and "unfused" in banned
        run_policy = (dataclasses.replace(policy, impl="torch")
                      if ref_mode else policy)
        try:
            if ref_mode:
                # the plain rung runs the ANALYTIC plan's plain version:
                # planned quarantine-blind (on_failure="raise" skips the
                # consult), so the output is the plain path's
                cp = chain.plan(spec, x.shape, dtype=x.dtype,
                                policy=dataclasses.replace(
                                    run_policy, autotune=False,
                                    on_failure="raise"), device=x.device)
            elif attempt == 0 and not banned:
                # the production path: explicit plan / autotune / analytic
                cp = chain.resolve_plan(spec, params, x, policy=policy,
                                        chain_plan=supplied)
            else:
                # after a failure, or quarantined: an analytic re-plan;
                # plan() consults the quarantine and skips banned rungs
                cp = chain.plan(spec, x.shape, dtype=x.dtype,
                                policy=dataclasses.replace(policy,
                                                           autotune=False),
                                device=x.device)
            runner = lowering.lower(spec, cp, run_policy)
            ctx = (faultinject.suppressed() if ref_mode
                   else contextlib.nullcontext())
            with ctx:
                faultinject.check("compile:chain")
                y = runner(params, x)
                if policy.numeric_guard and not capturing:
                    y = _guard("numeric:chain", y, scope="chain")
            if attempt:
                telemetry.record_recovery(
                    scope="chain", key=key,
                    rung="ref" if ref_mode else ladder.plan_rung(cp))
            return y
        except Exception as e:
            failure = failures.classify(e)
            if failure is None:
                raise  # not a recognized failure: never masked
            if (not degrade or ref_mode or capturing
                    or attempt + 1 >= MAX_ATTEMPTS):
                if failure is e:
                    raise
                raise failure from e
            ban = ladder.ban_for_failure(failure, cp)
            why = _unrecoverable(failure, x, ban)
            if why:
                failure.add_note(f"runtime ladder: {why}")
                if failure is e:
                    raise
                raise failure from e
            from_rung = ("ref" if ref_mode
                         else ladder.plan_rung(cp) if cp is not None
                         else "unknown")
            banned.add(ban)
            to_rung = ladder.next_rung(ban, banned)
            q.add_failure(
                key,
                signature=autotune.problem_signature(spec, x.shape, x.dtype,
                                                     policy, x.device),
                ban=ban,
                failure={**failure.describe(), "from_rung": from_rung})
            q.save()
            telemetry.record_fallback(
                scope="chain", key=key, from_rung=from_rung,
                to_rung=to_rung, failure_kind=failure.kind,
                segment_kind=failure.segment_kind,
                injected=failure.injected, error=str(failure))
            warnings.warn(
                f"runtime ladder: {failure.kind} failure at rung "
                f"{from_rung} (segment {failure.segment_kind}) for chain "
                f"{key}: {failure}; quarantined {ban!r} in {qpath}, "
                f"retrying at {to_rung}", RuntimeWarning, stacklevel=3)
    raise failure  # bounded attempts exhausted (unreachable: ref re-raises)


def run_network(net, params, x, *, policy, network_plan=None,
                block_dtype_policies=None):
    """Guarded ``execute_network_graph``: one CUDA graph on the happy path;
    on a classified failure, recover with per-block guarded chains (each
    block quarantining its own problem), run eagerly, so that the next call
    re-plans and captures a new graph around the bad blocks.  Returns
    ``(output, graph)``, the graph None where the eager runner ran or the
    call recovered."""
    from repro_torch.core import network  # core sits above the runtime

    degrade = policy.on_failure == "degrade"
    capturing = _capturing(x)
    try:
        y, graph = network._execute_network_raw(
            net, params, x, policy=policy, network_plan=network_plan,
            block_dtype_policies=block_dtype_policies)
        if policy.numeric_guard and not capturing:
            y = _guard("numeric:network", y, scope="network")
        return y, graph
    except Exception as e:
        failure = failures.classify(e)
        if failure is None:
            raise
        why = "" if not degrade or capturing else _unrecoverable(
            failure, x, "")
        if why:
            failure.add_note(f"runtime ladder: {why}")
        if not degrade or capturing or why:
            if failure is e:
                raise
            raise failure from e
        # a graph whose output failed the guard is not kept either: the
        # next call plans and captures again
        network._NETWORK_CACHE.pop(network._memo_key(
            net, params, x, policy, network_plan, block_dtype_policies),
            None)
        nkey = network.network_key(net, x.shape, x.dtype, policy,
                                   block_dtype_policies, x.device)
        telemetry.record_fallback(
            scope="network", key=nkey, from_rung="network-graph",
            to_rung="per-block", failure_kind=failure.kind,
            segment_kind=failure.segment_kind, injected=failure.injected,
            error=str(failure))
        warnings.warn(
            f"runtime ladder: {failure.kind} failure in the whole-network "
            f"call for {nkey}: {failure}; recovering block by block "
            "(failing blocks will be quarantined and the next call "
            "re-plans around them)", RuntimeWarning, stacklevel=3)
        policies = network.resolve_block_policies(net, policy,
                                                  block_dtype_policies)
        y = x
        with torch.inference_mode():
            for spec, p, pol in zip(net.blocks, params, policies):
                y = execute_chain(spec, p, y, policy=pol)
        telemetry.record_recovery(scope="network", key=nkey,
                                  rung="per-block")
        return y, None
