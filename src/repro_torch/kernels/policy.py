"""Execution policy for the port's ops, and the one backend-resolution rule.

Counterpart of ``repro/kernels/policy.py``.  The backend follows the
TENSOR, not the host: a CUDA tensor runs the hand-written kernels, a CPU
tensor runs the plain PyTorch versions.  Nothing falls back: a kernel that
fails to build or launch raises, and ``impl="cuda"`` on a CPU tensor raises.

``KernelPolicy`` keeps the reference's fields: ``impl``, the ``fused``
opt-out, the ``dtype_policy``, the GEMM tile overrides, the per-CTA
shared-memory budget the planner sizes fused tiles against (in place of the
reference's VMEM budget), the measured autotuner's ``autotune`` /
``tune_cache``, the runtime ladder's ``on_failure`` / ``numeric_guard``,
and the static verifier's ``verify``.

``on_failure`` is where the port departs from the reference's default: the
reference degrades (``"degrade"``), the port raises (``"raise"``), so that
no fallback can hide a kernel failure on the main path.  The ladder
(``runtime/``) is an explicit opt-in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.blocking import DEFAULT_SMEM_BUDGET

#: dtype names a DtypePolicy may stream/store at, and their torch dtypes.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
STREAMABLE_DTYPES = tuple(DTYPES)

IMPLS = ("auto", "cuda", "torch")

#: What a classified kernel failure does (``runtime/executor.py``).
ON_FAILURE = ("raise", "degrade")


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Mixed-precision streaming policy (the reference's DESIGN.md §7).

    ``stream``: dtype name every segment's streamed operands move at
    (``None`` keeps the input's dtype).  ``out``: dtype name of the final
    output (``None`` stores at the stream width).  Accumulation is fp32 in
    every kernel regardless.
    """
    stream: Optional[str] = None
    out: Optional[str] = None

    def __post_init__(self):
        for name in (self.stream, self.out):
            if name is not None and name not in DTYPES:
                raise ValueError(f"unknown dtype {name!r}; "
                                 f"want one of {STREAMABLE_DTYPES}")

    def stream_dtype(self, native: torch.dtype) -> torch.dtype:
        return DTYPES[self.stream] if self.stream else native

    def out_dtype(self, native: torch.dtype) -> torch.dtype:
        return DTYPES[self.out] if self.out else self.stream_dtype(native)

    def signature(self) -> dict:
        """Serialized identity for the autotune cache key: a bf16-streamed
        measured plan must never replay onto a native run."""
        return {"stream": self.stream, "out": self.out}


#: Stream at the input's native dtype.
NATIVE = DtypePolicy()

#: Stream activations and weights as bf16, accumulate fp32, store bf16.
BF16_STREAM = DtypePolicy(stream="bfloat16")


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` for a tensor on a CUDA device, else
    ``"torch"`` (the plain version).  ``"cuda"`` for a tensor that is not on
    a CUDA device raises; there is no fallback either way."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want {'|'.join(IMPLS)})")
    dev = torch.device(device)
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {dev}")
    return impl


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Execution policy for the port's ops.

    impl: ``"auto"`` (follow the tensor's device) | ``"cuda"`` (the
    hand-written kernels; CUDA tensors only) | ``"torch"`` (the plain
    versions, on any device — the yardstick ``chip_smoke.py`` compares
    against).
    smem_budget: dynamic shared memory one fused-kernel CTA may claim; the
    chain planner sizes tiles against it (at most 227 KB on Hopper).
    block_g/co/ci: explicit pwconv tile overrides; ``None`` defers to
    ``blocking.plan_pwconv``.
    fused: ``False`` forces the unfused composition; ``None``/``True`` let
    the planner fuse whatever fits.
    dtype_policy: mixed-precision streaming (:class:`DtypePolicy`).
    autotune: measured plan selection (``kernels/autotune.py``).  ``True``
    makes ``core/chain.plan`` / ``execute`` and ``core/network.plan_network``
    / ``execute_network`` consult the persistent tune cache and, on a miss,
    ``execute`` and ``execute_network`` measure the candidate ladder on
    their first call (the winner is persisted, so later runs replay it
    without measuring).  ``False`` (default) keeps the analytic planner.
    tune_cache: path of the JSON tune cache; ``None`` uses
    ``kernels/autotune.default_cache_path()``.  A pinned cache also pins
    the quarantine store beside it (``runtime/quarantine.py``).
    on_failure: ``"raise"`` (default) — a kernel failure raises, as it
    is; no plan consults the quarantine.  ``"degrade"`` — the runtime
    ladder (``runtime/executor.py``): a classified failure
    (``runtime/failures.classify``) quarantines the failing rung in a
    persistent store, recovers by running the failing blocks again one by
    one at lower rungs (the plain version last), and the next call re-plans
    around the ban.  The reference defaults to ``"degrade"``; the port
    does not, so that no fallback hides a kernel failure unless asked to.
    numeric_guard: check that every chain and network output is finite
    (a host sync after the call, never inside a captured graph); a
    non-finite output is a ``NumericalFailure``.
    verify: run the static verifier (``repro_torch.analysis``: planlint and
    the launch limits, no trace) on every plan where it is made, in
    ``core/chain.plan`` / ``resolve_plan`` and ``core/network.plan_network``
    / ``execute_network``, before any warm-up or capture; a plan with an
    error raises ``analysis.PlanVerificationError``, under either
    ``on_failure`` (it never degrades).  It changes no plan and no launch.
    """
    impl: str = "auto"
    smem_budget: int = DEFAULT_SMEM_BUDGET
    fused: Optional[bool] = None
    block_g: Optional[int] = None
    block_co: Optional[int] = None
    block_ci: Optional[int] = None
    dtype_policy: DtypePolicy = NATIVE
    autotune: bool = False
    tune_cache: Optional[str] = None
    on_failure: str = "raise"
    numeric_guard: bool = False
    verify: bool = False

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.on_failure not in ON_FAILURE:
            raise ValueError(f"unknown on_failure {self.on_failure!r} (want "
                             f"{'|'.join(ON_FAILURE)})")

    def resolved(self, device: torch.device) -> str:
        return resolve_impl(self.impl, device)

    @property
    def fusion_allowed(self) -> bool:
        return self.fused is not False


DEFAULT_POLICY = KernelPolicy()
