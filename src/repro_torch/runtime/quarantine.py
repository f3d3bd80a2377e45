"""Persistent plan quarantine: failed rungs stay failed.

Counterpart of ``repro/runtime/quarantine.py``.  When the degradation
ladder quarantines a rung for a problem, the decision outlives the
process: the next run (a fresh server, a re-launched benchmark) skips the
known-bad plan with zero retries instead of failing it again.  The store
follows the tune cache's discipline:

* same key: ``kernels/autotune.problem_key`` — the stages, the input shape
  and dtype, the dtype policy, fusion, the shared-memory budget and the
  backend (the resolved impl, the device's name and capability, the torch
  and CUDA versions and the kernels' source digest), so a ban never
  crosses devices and does not outlive a rebuilt kernel;
* same persistence: ``kernels/diskstore.VersionedJsonStore`` — versioned,
  merge-on-write atomic saves, a corrupted file warns and loads as empty;
* same placement: ``quarantine.json`` beside a pinned ``policy.tune_cache``,
  else ``$REPRO_TORCH_QUARANTINE``, else ``build/repro_torch/
  quarantine.json`` in the checkout, beside the default tune cache (never
  the reference's file).  Deleting the file clears every ban.

Entry format (one per problem key)::

    {"signature": {...problem_signature...},
     "banned": ["fused3", ...],            # subset of BANNABLE
     "failures": [{...KernelFailure.describe() + from_rung...}, ...]}

``banned`` names the ladder rungs the planner must skip: ``fused3`` /
``fusedmb`` / ``fused2`` / ``dw_se`` remove those windows from
``core/chain.plan``'s walk; ``unfused`` means the standalone kernels failed
too, and the block runs its plain version.  Only an injected fault bans
``unfused``: a real failure of the standalone kernels raises with nothing
written (``runtime/executor.py``), so the store never sends a block to its
plain version behind a real fault.

Only an explicit ``KernelPolicy(on_failure="degrade")`` reads the store:
under the default ``"raise"`` no plan ever consults it.  A memo keyed on
the file's mtime and size makes the steady-state consult one ``os.stat``.
"""
from __future__ import annotations

import os
import threading
from typing import FrozenSet, Sequence

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels.diskstore import VersionedJsonStore

QUARANTINE_VERSION = 1

#: Rungs an entry may ban (the "ref" rung never: it is the fallback of last
#: resort and fault injection is suppressed around it).
BANNABLE = ("fused3", "fusedmb", "fused2", "dw_se", "unfused")


def default_quarantine_path() -> str:
    """``$REPRO_TORCH_QUARANTINE``, else ``quarantine.json`` beside the
    kernels' libraries in the checkout's ``build/repro_torch/``."""
    return (os.environ.get("REPRO_TORCH_QUARANTINE")
            or str(_build.BUILD_DIR / "quarantine.json"))


def quarantine_path(policy) -> str:
    """The store lives beside the policy's tune cache when one is pinned
    (same directory, same lifecycle); else the default path."""
    if policy.tune_cache:
        d = os.path.dirname(policy.tune_cache)
        return os.path.join(d or ".", "quarantine.json")
    return default_quarantine_path()


class Quarantine(VersionedJsonStore):
    version = QUARANTINE_VERSION

    def banned(self, key: str) -> FrozenSet[str]:
        entry = self.entries.get(key)
        if not isinstance(entry, dict):
            return frozenset()
        banned = entry.get("banned")
        if not isinstance(banned, list):
            return frozenset()
        return frozenset(b for b in banned if b in BANNABLE)

    def add_failure(self, key: str, *, signature: dict, ban: str,
                    failure: dict) -> None:
        if ban not in BANNABLE:
            raise ValueError(f"rung {ban!r} cannot be banned; want one of "
                             f"{BANNABLE}")
        entry = self.entries.get(key)
        if not isinstance(entry, dict):
            entry = {"signature": signature, "banned": [], "failures": []}
        entry["banned"] = sorted(set(entry.get("banned", [])) | {ban})
        entry.setdefault("failures", []).append(dict(failure))
        entry["failures"] = entry["failures"][-16:]
        self.entries[key] = entry

    def save(self) -> None:
        super().save()
        _memo_store(self.path, self)


# -- steady-state load memo (mtime/size keyed, one os.stat per consult) -----

_MEMO_LOCK = threading.Lock()
_MEMO: dict = {}


def _stat_sig(path: str):
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def load(path: str) -> Quarantine:
    sig = _stat_sig(path)
    with _MEMO_LOCK:
        hit = _MEMO.get(path)
        if hit is not None and hit[0] == sig:
            return hit[1]
    q = Quarantine.load(path)
    with _MEMO_LOCK:
        _MEMO[path] = (sig, q)
    return q


def _memo_store(path: str, q: Quarantine) -> None:
    with _MEMO_LOCK:
        _MEMO[path] = (_stat_sig(path), q)


def clear_memo() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


def banned_kinds(spec, x_shape: Sequence[int], dtype, policy,
                 device=None) -> FrozenSet[str]:
    """The rungs quarantined for this exact problem on ``device`` (default:
    ``autotune.default_device()``): what ``core/chain.plan`` skips and the
    executor starts below.  Records a quarantine-hit telemetry event when
    non-empty."""
    q = load(quarantine_path(policy))
    if not q.entries:
        return frozenset()
    key = _autotune.problem_key(spec, x_shape, dtype, policy, device)
    banned = q.banned(key)
    if banned:
        from repro_torch.runtime import telemetry
        telemetry.record_quarantine_hit(scope="plan", key=key, banned=banned)
    return banned


def uses_banned(cp, banned) -> bool:
    """Whether a ChainPlan runs a quarantined rung: any rung at all once
    ``unfused`` is banned (the block then runs its plain version), else a
    segment of a banned kind."""
    return bool(banned) and ("unfused" in banned
                             or any(s.kind in banned for s in cp.segments))
