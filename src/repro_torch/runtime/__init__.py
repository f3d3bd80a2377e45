"""repro_torch.runtime — the runtime ladder, an opt-in.

Counterpart of ``repro/runtime/``: a failure taxonomy (``failures``), a
deterministic fault-injection harness (``faultinject``), a degradation
ladder with a persistent plan quarantine (``ladder``, ``quarantine``,
``executor``) and fallback telemetry (``telemetry``).
``core/chain.execute`` and ``core/network.execute_network`` route here
under an explicit ``KernelPolicy(on_failure="degrade")`` or with
``numeric_guard``.  The port's default is ``on_failure="raise"``, where the
reference's is ``"degrade"``: on the main path a kernel failure raises, and
no plan consults the quarantine.

Lazy attribute re-exports on purpose: ``kernels/lowering.py`` imports the
submodules ``failures`` / ``faultinject`` (which runs this ``__init__``),
so nothing here may import the kernel or core layers at module scope.
"""
from __future__ import annotations

_EXPORTS = {
    "KernelFailure": "failures",
    "LoweringFailure": "failures",
    "CompileFailure": "failures",
    "NumericalFailure": "failures",
    "InjectedFault": "failures",
    "classify": "failures",
    "INJECTION_POINTS": "faultinject",
    "RUNGS": "ladder",
    "Quarantine": "quarantine",
    "quarantine_path": "quarantine",
    "execute_chain": "executor",
    "run_network": "executor",
    "runtime_report": "telemetry",
    "reset_runtime_telemetry": "telemetry",
    "fallback_count": "telemetry",
}

__all__ = sorted(_EXPORTS) + ["executor", "failures", "faultinject",
                              "ladder", "quarantine", "telemetry"]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.runtime' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.runtime.{mod}"),
                   name)
