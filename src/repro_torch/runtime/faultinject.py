"""Deterministic fault-injection harness for the runtime ladder.

Counterpart of ``repro/runtime/faultinject.py``, with the same catalog of
nine named points.  Tests, ``chip_smoke.py`` and ``mobilenet_inference.py
--fault-inject`` arm a point; the next time execution passes it an
:class:`~repro_torch.runtime.failures.InjectedFault` is raised (or, for the
``numeric:*`` points, the output is NaN-poisoned, so the numeric guard
detects a real non-finite value).  A disarmed point costs one dict lookup:
nothing is patched, so the injected control flow is the production one.

On the card a point fires where the host code passes it: the ``lowering:*``
points while a chain's runner dispatches its segments (eagerly, or during
a CUDA graph's warm-up and capture), never during a replay, which runs no
host code.

A point fires exactly ``times`` times (:data:`PERSISTENT` = every pass),
counted per arm; :func:`fired_counts` lets a run check that the telemetry
records exactly the injected fallbacks.  :func:`suppressed` marks the
plain rung: the ladder's last rung must not be injectable, or a persistent
fault could make the fallback of last resort fail too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.runtime.failures import InjectedFault

#: The injection-point catalog.  Arming any other name is a ValueError: a
#: typo must fail the run arming it, not silently do nothing.
INJECTION_POINTS = {
    "lowering:separable_fused":
        "fused2/fused3 segment dispatch (kernels/lowering: the two rungs "
        "share the kernel, so they share the point)",
    "lowering:fused_mbconv":
        "fusedmb/mb segment dispatch (kernels/lowering: the fused kernel "
        "and the standalone conv share the point)",
    "lowering:se_epilogue":
        "dw_se/se segment dispatch (kernels/lowering: the two rungs share "
        "the point)",
    "lowering:pwconv":
        "standalone pw segment dispatch (kernels/lowering)",
    "lowering:dwconv2d":
        "standalone dw segment dispatch (kernels/lowering)",
    "compile:chain":
        "chain runner invocation (runtime/executor.execute_chain)",
    "compile:network":
        "whole-network runner invocation (core/network.build_network_fn: "
        "the eager call, or the graph's warm-up and capture on the card; "
        "never a replay)",
    "numeric:chain":
        "NaN-poisons the chain output before the numeric guard",
    "numeric:network":
        "NaN-poisons the network output before the numeric guard",
}

#: ``times`` value meaning "fire on every pass until disarmed".
PERSISTENT = -1


@dataclasses.dataclass
class _Fault:
    point: str
    times: int
    fired: int = 0
    message: Optional[str] = None

    @property
    def live(self) -> bool:
        return self.times < 0 or self.fired < self.times


_faults: Dict[str, _Fault] = {}
_local = threading.local()


def arm(point: str, times: int = 1, message: Optional[str] = None) -> None:
    """Arm ``point`` to fire ``times`` times (:data:`PERSISTENT` forever)."""
    if point not in INJECTION_POINTS:
        raise ValueError(
            f"unknown injection point {point!r}; catalog: "
            f"{sorted(INJECTION_POINTS)}")
    _faults[point] = _Fault(point, times=int(times), message=message)


def disarm(point: str) -> None:
    _faults.pop(point, None)


def disarm_all() -> None:
    _faults.clear()


def armed_points() -> Tuple[str, ...]:
    return tuple(sorted(p for p, f in _faults.items() if f.live))


def fired_counts() -> Dict[str, int]:
    """{point: times fired} for every point armed since the last disarm."""
    return {p: f.fired for p, f in _faults.items()}


def _suppressed() -> bool:
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def suppressed():
    """No point fires inside: the plain rung runs in this, so a persistent
    fault cannot take down the rung of last resort."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


@contextlib.contextmanager
def injected(point: str, times: int = 1, message: Optional[str] = None):
    """Scoped arm: arms on enter, disarms on exit."""
    arm(point, times=times, message=message)
    try:
        yield
    finally:
        disarm(point)


def _default_message(point: str) -> str:
    if point.startswith("lowering:"):
        return ("kernel launch refused: invalid configuration "
                f"(fault-injected at {point})")
    return f"out of device memory (fault-injected at {point})"


def _fire(point: str) -> bool:
    f = _faults.get(point)
    if f is None or _suppressed() or not f.live:
        return False
    f.fired += 1
    return True


def check(point: str) -> None:
    """Raise :class:`InjectedFault` when ``point`` is armed and live; a
    no-op (one dict lookup) otherwise.  Suppressed inside
    :func:`suppressed`."""
    if _fire(point):
        raise InjectedFault(_faults[point].message
                            or _default_message(point), point=point)


def poison(point: str, y):
    """NaN-poison one element of a copy of ``y`` when ``point`` is armed
    (the ``numeric:*`` points): the guard then detects a real non-finite
    output.  Returns ``y`` itself when the point does not fire."""
    if not _fire(point):
        return y
    y = y.clone()
    y.view(-1)[0] = float("nan")
    return y


def arm_from_spec(spec: str) -> Tuple[str, ...]:
    """Arm from a CLI string: comma-separated ``point[:times]`` items,
    persistent when ``times`` is omitted.  Returns the armed point names."""
    points = []
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        name, times = item, PERSISTENT
        # point names contain one ':' (category:site); a second one is the
        # fire count
        if item.count(":") == 2:
            name, _, t = item.rpartition(":")
            times = int(t)
        arm(name, times=times)
        points.append(name)
    return tuple(points)
