"""Structured failure taxonomy for the runtime ladder.

Counterpart of ``repro/runtime/failures.py`` (the port keeps its own copy;
it imports nothing of the reference).  The classes are the reference's:

* :class:`LoweringFailure` — a kernel cannot run at this plan: on the card,
  a launch the driver refuses for its configuration (grid, block, shared
  memory, no image for the device);
* :class:`CompileFailure` — the device ran out of memory for this plan;
* :class:`NumericalFailure` — the ``numeric_guard`` found non-finite values
  in a chain or network output.

Each failure is tagged with the segment that produced it (kind, index and
stage indices), so that the ladder (``runtime/ladder.py``) knows which rung
to quarantine.

:func:`classify` is a whitelist, narrower than the reference's, which wraps
any ``RuntimeError``.  In PyTorch a ``RuntimeError`` is also what a plain
op raises on a bug (a shape mismatch) and what a missing ``nvcc`` or a
failed build raises (``kernels/_build.py``); degrading around those would
hide them.  Only these are wrapped:

* an :class:`InjectedFault` (``runtime/faultinject.py``);
* a :class:`~repro_torch.kernels._build.KernelLaunchError` whose CUDA code
  is a launch-configuration error (:data:`LOWERING_CODES`: the context
  survives it) or an allocation failure (:data:`COMPILE_CODES`);
* ``torch.cuda.OutOfMemoryError``, as a :class:`CompileFailure`.

Everything else answers ``None`` and propagates unwrapped.  A sticky code
(:data:`STICKY_CODES`: an illegal address, a device assert, ...) leaves the
CUDA context unusable for every rung, the plain one included: it is never
wrapped, and the exception gains a note saying that the context is lost.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels._build import KernelLaunchError

#: The CUDA runtime's error codes this module names (``cudaError`` in the
#: toolkit's ``driver_types.h``; ``chip_smoke.py`` checks every entry
#: against the header on the card).
CUDA_ERRORS = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
    214: "cudaErrorECCUncorrectable",
    700: "cudaErrorIllegalAddress",
    701: "cudaErrorLaunchOutOfResources",
    702: "cudaErrorLaunchTimeout",
    710: "cudaErrorAssert",
    714: "cudaErrorHardwareStackError",
    715: "cudaErrorIllegalInstruction",
    716: "cudaErrorMisalignedAddress",
    717: "cudaErrorInvalidAddressSpace",
    718: "cudaErrorInvalidPc",
    719: "cudaErrorLaunchFailure",
    720: "cudaErrorCooperativeLaunchTooLarge",
}

#: Launch-configuration errors: the driver refused this launch and the
#: context is intact, so another plan can run.  -> LoweringFailure.
LOWERING_CODES = frozenset({1, 9, 98, 209, 701, 720})
#: The device could not allocate for this launch.  -> CompileFailure.
COMPILE_CODES = frozenset({2})
#: Errors after which every CUDA call of the process fails: never wrapped.
STICKY_CODES = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718, 719})

_CONTEXT_LOST = ("CUDA error {code} ({name}) is sticky: the CUDA context is "
                 "lost and every later CUDA call in this process fails, so "
                 "no rung of the runtime ladder can run; restart the process")


class KernelFailure(RuntimeError):
    """Base of the taxonomy; ``kind`` names the class in telemetry,
    quarantine records and ``runtime_report()``."""

    kind = "kernel"

    def __init__(self, message: str, *,
                 segment_kind: Optional[str] = None,
                 segment_index: Optional[int] = None,
                 stage_indices: Optional[Sequence[int]] = None,
                 original: Optional[BaseException] = None,
                 injected: bool = False):
        super().__init__(message)
        self.segment_kind = segment_kind
        self.segment_index = segment_index
        self.stage_indices = (tuple(int(i) for i in stage_indices)
                              if stage_indices is not None else None)
        self.original = original
        self.injected = bool(injected)

    def describe(self) -> dict:
        """JSON-serializable record for quarantine entries / telemetry."""
        return {
            "kind": self.kind,
            "message": str(self)[:300],
            "segment_kind": self.segment_kind,
            "segment_index": self.segment_index,
            "stage_indices": (list(self.stage_indices)
                              if self.stage_indices is not None else None),
            "original": (type(self.original).__name__
                         if self.original is not None else None),
            "injected": self.injected,
        }


class LoweringFailure(KernelFailure):
    kind = "lowering"


class CompileFailure(KernelFailure):
    kind = "compile"


class NumericalFailure(KernelFailure):
    kind = "numeric"


class InjectedFault(RuntimeError):
    """Raised by ``runtime/faultinject.check`` at an armed injection point;
    classified like the failure its point stands for (``lowering:*`` as a
    :class:`LoweringFailure`, ``compile:*`` as a :class:`CompileFailure`)."""

    def __init__(self, message: str, *, point: str):
        super().__init__(message)
        self.point = point


def is_sticky(exc: BaseException) -> bool:
    """Whether ``exc`` is a launch error that lost the CUDA context."""
    return isinstance(exc, KernelLaunchError) and exc.code in STICKY_CODES


def _note_context_lost(exc: KernelLaunchError) -> None:
    note = _CONTEXT_LOST.format(code=exc.code,
                                name=CUDA_ERRORS.get(exc.code, "?"))
    if note not in getattr(exc, "__notes__", ()):
        exc.add_note(note)


def classify(exc: BaseException, *,
             segment_kind: Optional[str] = None,
             segment_index: Optional[int] = None,
             stage_indices: Optional[Sequence[int]] = None,
             ) -> Optional[KernelFailure]:
    """Map a raised exception onto the taxonomy, or ``None`` when it is not
    on the whitelist (the caller must then re-raise it as it is).

    An already-classified :class:`KernelFailure` passes through, gaining
    segment tags it lacks (the lowering tags at segment scope; outer layers
    only add context, never overwrite it).
    """
    if isinstance(exc, KernelFailure):
        if exc.segment_kind is None and segment_kind is not None:
            exc.segment_kind = segment_kind
            exc.segment_index = segment_index
            exc.stage_indices = (tuple(int(i) for i in stage_indices)
                                 if stage_indices is not None else None)
        return exc
    ctx = dict(segment_kind=segment_kind, segment_index=segment_index,
               stage_indices=stage_indices, original=exc)
    if isinstance(exc, InjectedFault):
        cls = (LoweringFailure if exc.point.startswith("lowering:")
               else CompileFailure)
        return cls(str(exc), injected=True, **ctx)
    if isinstance(exc, KernelLaunchError):
        if exc.code in STICKY_CODES:
            _note_context_lost(exc)
            return None
        if exc.code in LOWERING_CODES:
            return LoweringFailure(str(exc), **ctx)
        if exc.code in COMPILE_CODES:
            return CompileFailure(str(exc), **ctx)
        return None
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return CompileFailure(str(exc), **ctx)
    return None
