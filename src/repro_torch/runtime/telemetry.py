"""Fallback-event telemetry: per-process counters and a report.

Counterpart of ``repro/runtime/telemetry.py``, ported verbatim.  Every
degradation the runtime executor performs is recorded here — which rung
fell to which, for which problem key, classified how, and whether the
underlying failure was injected — so that runs can check the aggregate: a
faulted run's report must record exactly the injected fallbacks, and a
clean steady-state run must report zero.

In memory and per process on purpose (the persistent artifact is the
quarantine store): ``runtime_report()`` snapshots to a JSON-serializable
dict, ``reset_runtime_telemetry()`` zeroes between phases.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

#: Bounded event log — counters never saturate, the event detail does.
MAX_EVENTS = 256

_LOCK = threading.Lock()
_COUNTERS: collections.Counter = collections.Counter()
_EVENTS: list = []


def _append_event(event: dict) -> None:
    _EVENTS.append(event)
    if len(_EVENTS) > MAX_EVENTS:
        del _EVENTS[: len(_EVENTS) - MAX_EVENTS]


def record_fallback(*, scope: str, key: str, from_rung: str, to_rung: str,
                    failure_kind: str, segment_kind: Optional[str],
                    injected: bool, error: str) -> None:
    """One rung-down retry (or whole-network -> per-block recovery)."""
    with _LOCK:
        _COUNTERS["fallbacks"] += 1
        _COUNTERS[f"fallbacks.{failure_kind}"] += 1
        _COUNTERS[f"fallbacks.{scope}"] += 1
        if injected:
            _COUNTERS["injected_fallbacks"] += 1
        _append_event({
            "event": "fallback", "scope": scope, "key": key,
            "from_rung": from_rung, "to_rung": to_rung,
            "failure_kind": failure_kind, "segment_kind": segment_kind,
            "injected": bool(injected), "error": str(error)[:300],
        })


def record_recovery(*, scope: str, key: str, rung: str) -> None:
    """A degraded attempt succeeded — the ladder landed somewhere."""
    with _LOCK:
        _COUNTERS["recoveries"] += 1
        _append_event({"event": "recovery", "scope": scope, "key": key,
                       "rung": rung})


def record_quarantine_hit(*, scope: str, key: str, banned) -> None:
    """A plan consult honored a persisted quarantine entry (skipped the
    banned rungs with ZERO retry attempts — the steady state after a
    failure)."""
    with _LOCK:
        _COUNTERS["quarantine_hits"] += 1
        _append_event({"event": "quarantine_hit", "scope": scope,
                       "key": key, "banned": sorted(banned)})


def fallback_count() -> int:
    with _LOCK:
        return int(_COUNTERS.get("fallbacks", 0))


def runtime_report() -> dict:
    """JSON-serializable snapshot; steady state = ``fallbacks == 0``."""
    with _LOCK:
        return {
            "fallbacks": int(_COUNTERS.get("fallbacks", 0)),
            "injected_fallbacks": int(_COUNTERS.get("injected_fallbacks", 0)),
            "numeric_trips": int(_COUNTERS.get("fallbacks.numeric", 0)),
            "recoveries": int(_COUNTERS.get("recoveries", 0)),
            "quarantine_hits": int(_COUNTERS.get("quarantine_hits", 0)),
            "counters": {k: int(v) for k, v in sorted(_COUNTERS.items())},
            "events": [dict(e) for e in _EVENTS],
        }


def reset_runtime_telemetry() -> None:
    with _LOCK:
        _COUNTERS.clear()
        _EVENTS.clear()
