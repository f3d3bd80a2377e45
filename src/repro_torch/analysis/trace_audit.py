"""trace_audit — trace a planned chain and audit its fusion and cast claims.

Counterpart of ``repro/analysis/jaxpr_audit.py``, with its rule ids and
meanings.  ``ChainPlan.fully_fused`` and the fused segments are the point
of the fused lowering (no intermediate in device memory); the dtype
policy's contract is that every cast is owned by the lowering boundary and
that products accumulate in fp32.  Parity tests check values, not these
structural claims; this pass checks them on a trace of the lowered runner:

* JX301 (error) — pass-count mismatch: the trace runs a different number of
  kernel passes than the plan's (``ChainPlan.n_kernel_passes`` less its
  plain ``mb`` convs and its separate residual add, which are passes over
  device memory but no kernel of the port: :func:`expected_kernel_passes`).
* JX302 (error) — device-memory intermediate: a ``fully_fused`` chain runs
  a compute op outside the kernel.  Data movement (:data:`ALLOWED_OUTSIDE`:
  casts, views, copies, padding) feeds the one kernel and is allowed.
* JX310 (error) — rogue cast: a cast outside the kernels to a dtype the
  ``DtypePolicy`` does not own (the stream dtype, the out dtype, and fp32,
  the accumulation width).
* JX311 (error) — accumulation not fp32: a product or convolution inside a
  kernel whose operands are not fp32 (the plain versions upcast every
  operand, ``ref._dw_fp32`` and ``ref._conv_fp32``, as the kernels
  accumulate in fp32 registers).

The trace is a ``TorchDispatchMode`` over the lowered runner at a small
shape (batch 1, at most 16x16 where every conv pads SAME) on the CPU, on
seeded weights (on the card, at the planned shape): on the CPU the
lowering takes the plain versions, whose calls
it and each kernel wrapper mark as spans (``kernels/spans.py``), so ops
inside a span count as in-kernel.  On the card the kernels are ctypes
launches the dispatch mode cannot see; there JX301 is counted from the
wrappers' launch counters (``graphs._COUNTERS``) instead.  The audits are
granular (each takes a :class:`Trace`) so that tests can corrupt a runner
and audit its trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.diagnostics import ERROR, Diagnostic
from repro_torch.kernels import lowering, spans
from repro_torch.kernels.blocking import ChainPlan
from repro_torch.kernels.policy import KernelPolicy

#: aten ops a fully fused chain may run outside its kernel: data movement
#: and layout for the one kernel pass (casts, views, copies, padding,
#: allocation), never compute.
ALLOWED_OUTSIDE = frozenset({
    "_to_copy", "to", "copy_", "copy", "clone", "contiguous", "detach",
    "alias", "lift_fresh", "view", "_unsafe_view", "_reshape_alias",
    "reshape", "as_strided", "permute", "transpose", "t", "expand",
    "unsqueeze", "squeeze", "flatten", "slice", "select", "narrow", "split",
    "split_with_sizes", "unbind", "cat", "stack", "constant_pad_nd", "pad",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like",
})

#: aten products and convolutions (JX311 holds their operands to fp32).
PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "matmul", "dot",
                      "linear", "convolution", "_convolution", "conv2d"})

#: The launch counters of the CNN chains' kernels (``graphs._COUNTERS``).
KERNEL_COUNTERS = ("dwconv2d", "pwconv", "separable_fused2",
                   "separable_fused3", "fused_mbconv", "dw_se")

#: Largest height and width a chain is traced at.
TRACE_SIZE = 16


@dataclasses.dataclass
class Op:
    """One dispatched op: its aten name, whether it ran inside a kernel
    span, its tensor operands' dtypes and, for a cast, the target."""
    name: str
    in_kernel: bool
    dtypes: tuple
    to: Optional[torch.dtype] = None


@dataclasses.dataclass
class Trace:
    """A traced call: its ops in order, and its kernel passes (outermost
    spans, or on the card the kernels the wrappers launched)."""
    ops: List[Op] = dataclasses.field(default_factory=list)
    passes: int = 0
    depth: int = 0

    # the span listener (kernels/spans.py)
    def enter(self, name: str) -> None:
        if self.depth == 0:
            self.passes += 1
        self.depth += 1

    def exit(self) -> None:
        self.depth -= 1


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtypes = tuple(a.dtype for a in (*args, *kwargs.values())
                       if isinstance(a, torch.Tensor))
        name = func.overloadpacket.__name__
        self.trace.ops.append(Op(name, self.trace.depth > 0, dtypes,
                                 kwargs.get("dtype") if name == "_to_copy"
                                 else None))
        return func(*args, **kwargs)


def trace_call(fn, *args) -> Trace:
    """Run ``fn(*args)`` under the recorder; kernel passes from the spans,
    or, where the call launched kernels on the card, from the counters."""
    from repro_torch import graphs  # graphs imports every kernel wrapper
    trace = Trace()
    before = graphs.snapshot()
    with torch.no_grad(), spans.listening(trace), _Recorder(trace):
        fn(*args)
    launched = sum(graphs.snapshot()[k] - before[k] for k in KERNEL_COUNTERS)
    if launched:
        trace.passes = launched
    return trace


def trace_shape(spec, x_shape: Sequence[int], device="cpu") -> tuple:
    """On the CPU (the plain versions, which take no plan fields), batch 1
    and at most :data:`TRACE_SIZE` rows and columns where every conv stage
    pads SAME; on the card, whose kernels run the plan's tiles, the
    planned shape itself."""
    b, h, w, c = (int(v) for v in x_shape)
    if torch.device(device).type != "cpu":
        return b, h, w, c
    if all(getattr(s, "padding", "same").lower() == "same"
           for s in spec.stages):
        h, w = min(h, TRACE_SIZE), min(w, TRACE_SIZE)
    return 1, h, w, c


def trace_chain(spec, chain_plan: ChainPlan, x_shape: Sequence[int],
                dtype: torch.dtype, policy: KernelPolicy,
                device="cpu") -> Trace:
    """The trace of the lowered chain at :func:`trace_shape` on
    ``device``, on weights seeded 0 in ``dtype``."""
    from repro_torch.core import chain  # core sits above the analysis
    shape = trace_shape(spec, x_shape, device)
    gen = torch.Generator().manual_seed(0)
    params = chain.init_chain(gen, spec, shape[-1], dtype, device)
    x = torch.randn(shape, generator=gen).to(device=device, dtype=dtype)
    return trace_call(lowering.lower(spec, chain_plan, policy), params, x)


def expected_kernel_passes(chain_plan: ChainPlan) -> int:
    """The kernel passes a run of the plan makes: ``n_kernel_passes`` less
    the plain ``mb`` convs and the separate residual add."""
    n = chain_plan.n_kernel_passes
    n -= sum(1 for s in chain_plan.segments if s.kind == "mb")
    return n - (1 if chain_plan.residual and not chain_plan.residual_fused
                else 0)


# ---------------------------------------------------------------------------
# Granular audits (each over one trace)
# ---------------------------------------------------------------------------

def audit_passes(trace: Trace, n_expected: int, fully_fused: bool,
                 segment: str = "") -> List[Diagnostic]:
    """JX301 (pass count) and JX302 (intermediates of a fused chain)."""
    diags: List[Diagnostic] = []
    if trace.passes != n_expected:
        diags.append(Diagnostic(
            "JX301", ERROR,
            f"traced chain runs {trace.passes} kernel pass(es) but the plan "
            f"has {n_expected}", segment,
            hint="the lowering re-planned or a fused segment silently "
                 "split"))
    outside = sorted({op.name for op in trace.ops
                      if not op.in_kernel and op.name not in ALLOWED_OUTSIDE})
    if fully_fused and outside:
        diags.append(Diagnostic(
            "JX302", ERROR,
            f"fully_fused chain runs compute outside the kernel: "
            f"{', '.join(outside)}: an intermediate reaches device memory",
            segment,
            hint="every stage of a fused segment must execute inside the "
                 "single kernel pass"))
    return diags


def audit_casts(trace: Trace, allowed_dtypes: Set[str],
                segment: str = "") -> List[Diagnostic]:
    """JX310: every cast outside the kernels targets a dtype the policy
    owns (stream, out, or the fp32 accumulation width)."""
    diags: List[Diagnostic] = []
    flagged = set()
    for op in trace.ops:
        if op.in_kernel or op.to is None:
            continue
        new = str(op.to).removeprefix("torch.")
        if new not in allowed_dtypes and new not in flagged:
            flagged.add(new)
            diags.append(Diagnostic(
                "JX310", ERROR,
                f"cast to {new} outside any kernel, not attributable to "
                f"the dtype policy (owns: {sorted(allowed_dtypes)})",
                segment,
                hint="all casts belong to the lowering boundary "
                     "(kernels/lowering.py)"))
    return diags


def audit_accumulation(trace: Trace, segment: str = "") -> List[Diagnostic]:
    """JX311: products and convolutions inside a kernel take fp32
    operands (the fp32 accumulation the kernels keep in registers)."""
    for op in trace.ops:
        if not op.in_kernel or op.name not in PRODUCTS:
            continue
        narrow = sorted({str(d).removeprefix("torch.") for d in op.dtypes
                         if d != torch.float32})
        if narrow:
            return [Diagnostic(
                "JX311", ERROR,
                f"in-kernel {op.name} multiplies {', '.join(narrow)} "
                "operands: it does not accumulate in float32", segment,
                hint="upcast the operands first (ref._dw_fp32, "
                     "ref._conv_fp32; blocking.ACC_BYTES is the fp32 "
                     "contract)")]
    return []


# ---------------------------------------------------------------------------
# The whole pass over one planned chain
# ---------------------------------------------------------------------------

def lint_chain_trace(spec, chain_plan: ChainPlan, x_shape: Sequence[int],
                     *, dtype: torch.dtype, policy: KernelPolicy,
                     label: str = "chain", device="cpu") -> List[Diagnostic]:
    """Trace the lowered chain (on ``device``) and run every audit."""
    trace = trace_chain(spec, chain_plan, x_shape, dtype, policy, device)
    dp = policy.dtype_policy
    allowed = {str(dp.stream_dtype(dtype)).removeprefix("torch."),
               str(dp.out_dtype(dtype)).removeprefix("torch."), "float32"}
    diags = audit_casts(trace, allowed, label)
    diags.extend(audit_accumulation(trace, label))
    diags.extend(audit_passes(trace, expected_kernel_passes(chain_plan),
                              chain_plan.fully_fused, label))
    return diags
