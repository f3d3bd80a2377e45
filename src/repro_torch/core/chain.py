"""Declarative separable-chain API: spec -> plan -> lower -> execute.

Counterpart of ``repro/core/chain.py`` (:46-262, :269-450, :497) for the
stages ``PW``, ``DW``, ``SE`` and ``FusedMB``.  A ``SeparableSpec``
declares an ordered chain of stages and a residual; :func:`plan` budgets
the chain against one CTA's shared memory (or one cluster's, for
``dw_se``) and answers with a ``ChainPlan`` naming which contiguous stages
fuse; ``kernels/lowering.lower`` maps that onto kernel passes;
:func:`execute` runs it.

    spec = inverted_residual_spec(c_in=32, c_out=32, expand=6)
    params = init_chain(torch.Generator().manual_seed(0), spec, 32,
                        device="cuda")
    y = execute(spec, params, x)        # x (B, H, W, 32) on the card

With ``policy.autotune`` the measured autotuner (``kernels/autotune.py``)
answers as in the reference (``chain.py:336-339``, ``:474-522``):
:func:`plan` consults the tune cache, :func:`execute` tunes on its first
call and replays the cached winner afterwards.

Under an explicit ``KernelPolicy(on_failure="degrade")`` (the reference's
default, the port's opt-in) :func:`plan` consults the persistent plan
quarantine (``runtime/quarantine.py``) and skips the windows a previous run
failed at, and :func:`execute` runs through the runtime ladder
(``runtime/executor.execute_chain``), as it also does with
``numeric_guard``.  Under the default ``"raise"`` neither happens.

Under ``KernelPolicy(verify=True)`` every plan :func:`plan` and
:func:`resolve_plan` answer (a supplied one too) is held to the static
verifier (``repro_torch.analysis``) first, and a plan with an error
raises ``analysis.PlanVerificationError``.  :func:`chain_traffic` is the
reference's traffic model of a planned chain (``core/intensity.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import intensity as it
from repro_torch.kernels import autotune, blocking, lowering
from repro_torch.kernels.blocking import ChainPlan, ChainSegment
from repro_torch.kernels.epilogue import ACTIVATIONS
from repro_torch.kernels.policy import DEFAULT_POLICY, KernelPolicy


def _check_activation(a: Optional[str]) -> None:
    if a is not None and a not in ACTIVATIONS:
        raise ValueError(f"unknown activation {a!r}")


@dataclasses.dataclass(frozen=True)
class PW:
    """Pointwise stage: 1x1 conv / GEMM to ``features`` channels.  A
    bias-free expansion PW is what makes a 3-stage window fusable."""
    features: int
    activation: Optional[str] = None
    bias: bool = False

    def __post_init__(self):
        _check_activation(self.activation)


@dataclasses.dataclass(frozen=True)
class DW:
    """Depthwise stage: ``hf x wf`` spatial conv at the incoming width."""
    stride: int = 1
    activation: Optional[str] = "relu6"
    hf: int = 3
    wf: int = 3
    padding: str = "same"
    bias: bool = False

    def __post_init__(self):
        _check_activation(self.activation)
        if self.padding.lower() not in ("same", "valid"):
            raise ValueError(self.padding)

    def out_dims(self, h: int, w: int) -> Tuple[int, int]:
        if self.padding.lower() == "same":
            return -(-h // self.stride), -(-w // self.stride)
        return ((h - self.hf) // self.stride + 1,
                (w - self.wf) // self.stride + 1)


@dataclasses.dataclass(frozen=True)
class SE:
    """Squeeze-excite stage: global average pool -> FC-reduce to ``reduce``
    units (``activation``) -> FC-expand back to the incoming width ->
    sigmoid -> channel scale of the stage input.  Both FCs carry a bias.

    The builders compute ``reduce`` from the BLOCK input width (MnasNet's
    ``se_ratio`` convention), not from the expanded width.  The sigmoid
    does not map 0 to 0, so it never joins ``kernels/epilogue.ACTIVATIONS``:
    SE runs as the ``dw_se`` kernel's epilogue, whose gate scales the DW
    output and nothing padded, or as the standalone ``se`` segment.
    """
    reduce: int
    activation: str = "relu"

    def __post_init__(self):
        if self.reduce < 1:
            raise ValueError(f"SE reduce {self.reduce} < 1")
        _check_activation(self.activation)


@dataclasses.dataclass(frozen=True)
class FusedMB:
    """Fused-MBConv stage: a dense ``hf x wf`` conv straight to ``features``
    channels (the EfficientNet-Lite edge block, in place of PW-expand + DW).
    Followed by a PW projection it plans as one ``fusedmb`` kernel pass."""
    features: int
    stride: int = 1
    hf: int = 3
    wf: int = 3
    activation: Optional[str] = "relu6"
    padding: str = "same"
    bias: bool = False

    def __post_init__(self):
        _check_activation(self.activation)
        if self.padding.lower() not in ("same", "valid"):
            raise ValueError(self.padding)

    out_dims = DW.out_dims


Stage = Union[PW, DW, SE, FusedMB]


@dataclasses.dataclass(frozen=True)
class SeparableSpec:
    """An ordered chain of stages and a residual: ``False``, ``True``
    or ``"auto"`` (add the input exactly when the total stride is 1 and the
    widths match — the MobileNetV2 rule)."""
    stages: Tuple[Stage, ...]
    residual: Union[bool, str] = False

    def __post_init__(self):
        if not self.stages:
            raise ValueError("empty chain")
        if self.residual not in (True, False, "auto"):
            raise ValueError(self.residual)
        for s in self.stages:
            if not isinstance(s, (PW, DW, SE, FusedMB)):
                raise TypeError(f"unknown stage {s!r}")

    def out_channels(self, c_in: int) -> int:
        c = c_in
        for s in self.stages:
            if isinstance(s, (PW, FusedMB)):
                c = s.features
        return c

    def stride_product(self) -> int:
        return math.prod(s.stride for s in self.stages
                         if isinstance(s, (DW, FusedMB)))

    def residual_active(self, c_in: int) -> bool:
        if self.residual == "auto":
            return (self.stride_product() == 1
                    and self.out_channels(c_in) == c_in)
        return bool(self.residual)


def separable_block_spec(c_out: int, *, stride: int = 1,
                         activation: str = "relu6",
                         hf: int = 3) -> SeparableSpec:
    """MobileNetV1 separable block: DW(+bias) -> PW(+bias), both activated."""
    return SeparableSpec(stages=(
        DW(stride=stride, activation=activation, hf=hf, wf=hf, bias=True),
        PW(c_out, activation=activation, bias=True),
    ))


def inverted_residual_spec(c_in: int, c_out: int, *, expand: int = 6,
                           stride: int = 1, hf: int = 3) -> SeparableSpec:
    """MobileNetV2 inverted residual: bias-free PW-expand (relu6) -> DW
    (relu6) -> linear PW-project, residual when shapes allow."""
    return SeparableSpec(stages=(
        PW(c_in * expand, activation="relu6"),
        DW(stride=stride, activation="relu6", hf=hf, wf=hf),
        PW(c_out),
    ), residual="auto")


def mbconv_se_spec(c_in: int, c_out: int, *, expand: int = 6,
                   stride: int = 1, hf: int = 3, se_ratio: float = 0.25,
                   activation: str = "relu") -> SeparableSpec:
    """MnasNet-A1 MBConv block with squeeze-excite: bias-free PW-expand ->
    DW -> SE -> linear PW-project, residual when shapes allow.  The SE
    width is ``se_ratio`` of the block INPUT width."""
    return SeparableSpec(stages=(
        PW(c_in * expand, activation=activation),
        DW(stride=stride, activation=activation, hf=hf, wf=hf),
        SE(max(1, int(c_in * se_ratio))),
        PW(c_out),
    ), residual="auto")


def fused_mbconv_spec(c_in: int, c_out: int, *, expand: int = 6,
                      stride: int = 1, hf: int = 3,
                      activation: str = "relu6") -> SeparableSpec:
    """EfficientNet-Lite fused-MBConv block: a dense ``hf x hf`` conv to
    the expanded width -> linear PW-project, residual when shapes allow."""
    return SeparableSpec(stages=(
        FusedMB(c_in * expand, stride=stride, hf=hf, wf=hf,
                activation=activation),
        PW(c_out),
    ), residual="auto")


def init_chain(generator: torch.Generator, spec: SeparableSpec, c_in: int,
               dtype: torch.dtype = torch.float32,
               device="cuda") -> list:
    """He-style init, one params dict per stage (``lowering.PARAM_KEYS``);
    biases start at zero, as in the reference.  The draws are made on the
    CPU from ``generator`` and then moved, so a seed gives the same weights
    on every device."""
    params = []
    c = c_in
    for s in spec.stages:
        if isinstance(s, PW):
            w = torch.randn((c, s.features), generator=generator) / math.sqrt(c)
            p = {"w": w}
            if s.bias:
                p["b"] = torch.zeros(s.features)
            c = s.features
        elif isinstance(s, SE):
            p = {"w1": torch.randn((c, s.reduce), generator=generator)
                 / math.sqrt(c),
                 "b1": torch.zeros(s.reduce),
                 "w2": torch.randn((s.reduce, c), generator=generator)
                 / math.sqrt(s.reduce),
                 "b2": torch.zeros(c)}
        elif isinstance(s, FusedMB):
            f = torch.randn((s.hf, s.wf, c, s.features), generator=generator)
            p = {"f": f / math.sqrt(s.hf * s.wf * c)}
            if s.bias:
                p["b"] = torch.zeros(s.features)
            c = s.features
        else:
            f = torch.randn((s.hf, s.wf, c), generator=generator)
            p = {"f": f / math.sqrt(s.hf * s.wf)}
            if s.bias:
                p["b"] = torch.zeros(c)
        params.append({k: v.to(device=device, dtype=dtype)
                       for k, v in p.items()})
    return params


def _fusable3(stages, i: int) -> bool:
    return (i + 2 < len(stages)
            and isinstance(stages[i], PW) and not stages[i].bias
            and isinstance(stages[i + 1], DW)
            and isinstance(stages[i + 2], PW))


def _fusable2(stages, i: int) -> bool:
    return (i + 1 < len(stages)
            and isinstance(stages[i], DW) and isinstance(stages[i + 1], PW))


def _fusable_mb(stages, i: int) -> bool:
    return (i + 1 < len(stages)
            and isinstance(stages[i], FusedMB)
            and isinstance(stages[i + 1], PW))


def _fusable_dw_se(stages, i: int) -> bool:
    return (i + 1 < len(stages)
            and isinstance(stages[i], DW) and isinstance(stages[i + 1], SE))


def _valid_window(s, ho: int, wo: int) -> Tuple[int, int]:
    """Input rows and columns a VALID conv reads for an ho x wo output."""
    return (ho - 1) * s.stride + s.hf, (wo - 1) * s.stride + s.wf


def plan(spec: SeparableSpec, x_shape: Sequence[int], *,
         dtype: torch.dtype = torch.float32,
         policy: KernelPolicy = DEFAULT_POLICY, device=None) -> ChainPlan:
    """Budget the chain at ``x_shape`` and decide which stages fuse.

    With ``policy.autotune`` the persistent tune cache is consulted first:
    a measured winner for this problem on ``device`` (the device the input
    will be on; default the card where there is one) wins over the
    analytic walk.  On a miss this still answers analytically:
    measurement needs data, and happens in :func:`execute`.

    Greedy longest-run-first, in the reference's window order: at each
    position try the (bias-free PW-expand, DW, PW) window
    (``plan_separable3``), the (FusedMB, PW) window (``plan_fused_mb``),
    the (DW, PW) window (``plan_separable``) and the (DW, SE) window
    (``plan_dw_se``), else lower a standalone ``pw`` / ``se`` / ``mb`` /
    ``dw`` stage.  Budgets are taken at the policy's
    stream dtype.  The residual folds into the final segment when that
    segment is fused, else it is a separate add.

    Under ``policy.on_failure == "degrade"`` the persistent plan quarantine
    is consulted (keyed like the tune cache, on the native input dtype and
    ``device``) and the windows a previous run failed at on this backend
    are left out of the walk: the plan degrades at plan time, with zero
    retries.  Under the default ``"raise"`` the quarantine is never read.
    """
    if policy.autotune:
        analytic = plan(spec, x_shape, dtype=dtype,
                        policy=dataclasses.replace(policy, autotune=False,
                                                   verify=False),
                        device=device)
        cached = autotune.lookup_cached_plan(spec, x_shape, dtype, policy,
                                             base_plan=analytic,
                                             device=device)
        return _maybe_verify(spec, analytic if cached is None else cached,
                             x_shape, dtype, policy)
    banned: frozenset = frozenset()
    if policy.on_failure == "degrade":
        from repro_torch.runtime import quarantine  # runtime sits above core
        banned = quarantine.banned_kinds(spec, x_shape, dtype, policy, device)
    b, h, w, c = x_shape
    native, dtype = dtype, policy.dtype_policy.stream_dtype(dtype)
    stages = spec.stages
    n = len(stages)
    ho_f, wo_f = h, w
    for s in stages:
        if isinstance(s, (DW, FusedMB)):
            ho_f, wo_f = s.out_dims(ho_f, wo_f)
    spatial_ok = (ho_f, wo_f) == (h, w)
    if spec.residual is True and not spatial_ok:
        raise ValueError(
            f"residual=True but the chain maps {h}x{w} -> {ho_f}x{wo_f}")
    res_active = spec.residual_active(c) and spatial_ok
    allowed = policy.fusion_allowed
    budget = policy.smem_budget

    segments: list = []
    i = 0
    while i < n:
        s = stages[i]
        if allowed and "fused3" not in banned and _fusable3(stages, i):
            d, proj = stages[i + 1], stages[i + 2]
            ho, wo = d.out_dims(h, w)
            p3 = blocking.plan_separable3(
                ho, wo, c, stages[i].features, proj.features,
                stride=d.stride, hf=d.hf, wf=d.wf, dtype=dtype,
                smem_budget=budget, residual=res_active and i + 3 == n,
                batch=b, hi=h, wi=w)
            if p3 is not None:
                segments.append(ChainSegment("fused3", (i, i + 1, i + 2), p3))
                h, w, c = ho, wo, proj.features
                i += 3
                continue
        if allowed and "fusedmb" not in banned and _fusable_mb(stages, i):
            mb, proj = stages[i], stages[i + 1]
            ho, wo = mb.out_dims(h, w)
            pmb = blocking.plan_fused_mb(
                ho, wo, c, mb.features, proj.features, stride=mb.stride,
                hf=mb.hf, wf=mb.wf, dtype=dtype, smem_budget=budget,
                residual=res_active and i + 2 == n, batch=b)
            if pmb is not None:
                segments.append(ChainSegment("fusedmb", (i, i + 1), pmb))
                h, w, c = ho, wo, proj.features
                i += 2
                continue
        if allowed and "fused2" not in banned and _fusable2(stages, i):
            d, proj = stages[i], stages[i + 1]
            ho, wo = d.out_dims(h, w)
            p2 = blocking.plan_separable(
                ho, wo, c, proj.features, stride=d.stride, hf=d.hf,
                wf=d.wf, dtype=dtype, smem_budget=budget,
                residual=res_active and i + 2 == n, batch=b, hi=h, wi=w)
            if p2 is not None:
                segments.append(ChainSegment("fused2", (i, i + 1), p2))
                h, w, c = ho, wo, proj.features
                i += 2
                continue
        if allowed and "dw_se" not in banned and _fusable_dw_se(stages, i):
            d, se = stages[i], stages[i + 1]
            ho, wo = d.out_dims(h, w)
            pse = blocking.plan_dw_se(
                *_valid_window(d, ho, wo), ho, wo, c, se.reduce, d.hf, d.wf,
                stride=d.stride, dtype=dtype, batch=b, smem_budget=budget)
            if pse is not None:
                segments.append(ChainSegment("dw_se", (i, i + 1), pse))
                h, w = ho, wo
                i += 2
                continue
        if isinstance(s, PW):
            segments.append(ChainSegment("pw", (i,), blocking.plan_pwconv(
                b * h * w, c, s.features, dtype=dtype, smem_budget=budget)))
            c = s.features
        elif isinstance(s, SE):
            segments.append(ChainSegment("se", (i,), blocking.plan_se(
                b, c, s.reduce, dtype=dtype, smem_budget=budget)))
        elif isinstance(s, FusedMB):
            ho, wo = s.out_dims(h, w)
            segments.append(ChainSegment("mb", (i,), blocking.plan_mb(
                ho, wo, c, s.features, s.hf, s.wf, stride=s.stride,
                dtype=dtype, smem_budget=budget)))
            h, w, c = ho, wo, s.features
        else:
            ho, wo = s.out_dims(h, w)
            segments.append(ChainSegment("dw", (i,), blocking.plan_dwconv2d(
                *_valid_window(s, ho, wo), ho, wo, c, s.hf, s.wf,
                stride=s.stride, dtype=dtype)))
            h, w = ho, wo
        i += 1

    return _maybe_verify(spec, ChainPlan(
        segments=tuple(segments),
        residual=res_active,
        residual_fused=bool(res_active and segments
                            and segments[-1].kind in blocking.FUSED_KINDS),
        dtype_bytes=blocking.dtype_bytes(dtype),
        smem_budget=budget,
    ), x_shape, native, policy)


def _maybe_verify(spec: SeparableSpec, cp: ChainPlan, x_shape,
                  dtype: torch.dtype, policy: KernelPolicy) -> ChainPlan:
    """``policy.verify``: the static verifier's planlint and launch
    passes (no trace) over ``cp`` for an input of ``dtype``, raising
    ``analysis.PlanVerificationError`` on an error; ``cp`` unchanged
    otherwise (the reference's ``chain.py:453-463``)."""
    if policy.verify:
        from repro_torch import analysis  # the analysis sits above core
        analysis.verify_or_raise(analysis.analyze_chain(
            spec, cp, x_shape, dtype=dtype, policy=policy, trace=False))
    return cp


#: Re-export: lowering lives at the kernel layer.
lower = lowering.lower


def resolve_plan(spec: SeparableSpec, params: Sequence[dict],
                 x: torch.Tensor, *, policy: KernelPolicy = DEFAULT_POLICY,
                 chain_plan: Optional[ChainPlan] = None) -> ChainPlan:
    """The plan :func:`execute` runs: the one supplied, else the measured
    winner when ``policy.autotune`` (tuned on a cache miss), else the
    analytic :func:`plan`; under ``policy.verify`` verified before it is
    returned (a supplied plan too)."""
    if chain_plan is not None:
        return _maybe_verify(spec, chain_plan, x.shape, x.dtype, policy)
    if policy.autotune:
        base = plan(spec, x.shape, dtype=x.dtype,
                    policy=dataclasses.replace(policy, autotune=False,
                                               verify=False))
        return _maybe_verify(spec, autotune.autotune_chain(
            spec, params, x, policy=policy, base_plan=base).plan,
            x.shape, x.dtype, policy)
    return plan(spec, x.shape, dtype=x.dtype, policy=policy)


def execute(spec: SeparableSpec, params: Sequence[dict], x: torch.Tensor, *,
            policy: KernelPolicy = DEFAULT_POLICY,
            chain_plan: Optional[ChainPlan] = None) -> torch.Tensor:
    """Run the chain: resolve the plan (:func:`resolve_plan`: with
    ``policy.autotune`` the first call for a problem measures the
    candidates and persists the winner, later calls and processes replay
    it), lower, execute.  A kernel failure raises, unless
    ``policy.on_failure == "degrade"``: then (and with
    ``policy.numeric_guard``) the call runs through the runtime ladder
    (``runtime/executor.execute_chain``), whose steady state is this same
    plan, lowering and output plus one ``try``."""
    if policy.on_failure == "degrade" or policy.numeric_guard:
        from repro_torch.runtime import executor  # runtime sits above core
        return executor.execute_chain(spec, params, x, policy=policy,
                                      chain_plan=chain_plan)
    cp = resolve_plan(spec, params, x, policy=policy, chain_plan=chain_plan)
    return lower(spec, cp, policy)(params, x)


# ---------------------------------------------------------------------------
# ChainPlan traffic model (core/intensity.py per-segment terms)
# ---------------------------------------------------------------------------

def chain_traffic(spec: SeparableSpec, chain_plan: ChainPlan,
                  x_shape: Sequence[int], *,
                  dtype_bytes: Optional[int] = None) -> it.Traffic:
    """Modeled HBM traffic + FLOPs of the planned chain: the sum of each
    segment's kernel-level model (``core/intensity.py``), plus the separate
    residual add when it is not folded into a fused pass, plus the
    standalone-DW bias/activation epilogue (``apply_epilogue`` in
    ``kernels/lowering.py`` is a separate elementwise op that reads and
    re-writes the whole ``(B,Ho,Wo,C)`` tensor — fused segments apply it
    inside the kernel for free).  The reference's walk
    (``repro/core/chain.py:528-626``) over the port's plans;
    ``core/intensity.py`` says which plan fields it reads."""
    nb = dtype_bytes or chain_plan.dtype_bytes
    b, h, w, c = x_shape
    stages = spec.stages
    flops = 0.0
    bytes_ = 0.0
    for seg in chain_plan.segments:
        if seg.kind == "fused3":
            d, proj = stages[seg.stages[1]], stages[seg.stages[2]]
            ho, wo = d.out_dims(h, w)
            hi_v = (ho - 1) * d.stride + d.hf
            wi_v = (wo - 1) * d.stride + d.wf
            t = it.separable_traffic_fused3(
                b, hi_v, wi_v, c, stages[seg.stages[0]].features,
                proj.features, d.hf, d.wf, d.stride,
                block_co=seg.plan.block_co, slab_h=seg.plan.slab_h,
                dtype_bytes=nb)
            h, w, c = ho, wo, proj.features
        elif seg.kind == "fused2":
            d, proj = stages[seg.stages[0]], stages[seg.stages[1]]
            ho, wo = d.out_dims(h, w)
            hi_v = (ho - 1) * d.stride + d.hf
            wi_v = (wo - 1) * d.stride + d.wf
            t = it.separable_traffic_fused(
                b, hi_v, wi_v, c, proj.features, d.hf, d.wf, d.stride,
                block_co=seg.plan.block_co, slab_h=seg.plan.slab_h,
                dtype_bytes=nb)
            h, w, c = ho, wo, proj.features
        elif seg.kind == "fusedmb":
            mb, proj = stages[seg.stages[0]], stages[seg.stages[1]]
            ho, wo = mb.out_dims(h, w)
            hi_v = (ho - 1) * mb.stride + mb.hf
            wi_v = (wo - 1) * mb.stride + mb.wf
            t = it.fused_mb_traffic(
                b, hi_v, wi_v, c, mb.features, proj.features, mb.hf,
                mb.wf, mb.stride, block_co=seg.plan.block_co,
                slab_h=seg.plan.slab_h, dtype_bytes=nb)
            h, w, c = ho, wo, proj.features
        elif seg.kind == "dw_se":
            d, se = stages[seg.stages[0]], stages[seg.stages[1]]
            ho, wo = d.out_dims(h, w)
            hi_v = (ho - 1) * d.stride + d.hf
            wi_v = (wo - 1) * d.stride + d.wf
            t = it.dw_se_traffic(b, hi_v, wi_v, c, se.reduce, d.hf, d.wf,
                                 d.stride, dtype_bytes=nb)
            h, w = ho, wo
        elif seg.kind == "se":
            se = stages[seg.stages[0]]
            t = it.se_traffic(b, h, w, c, se.reduce, dtype_bytes=nb)
        elif seg.kind == "mb":
            mb = stages[seg.stages[0]]
            ho, wo = mb.out_dims(h, w)
            t = it.mb_traffic(b, h, w, c, mb.features, mb.hf, mb.wf,
                              mb.stride, dtype_bytes=nb)
            h, w, c = ho, wo, mb.features
        elif seg.kind == "pw":
            st = stages[seg.stages[0]]
            t = it.pwconv_traffic_rtrd(
                b * h * w, c, st.features, seg.plan.block_g,
                seg.plan.block_c, seg.plan.block_co, dtype_bytes=nb)
            c = st.features
        else:
            st = stages[seg.stages[0]]
            ho, wo = st.out_dims(h, w)
            hi_v = (ho - 1) * st.stride + st.hf
            wi_v = (wo - 1) * st.stride + st.wf
            t = it.dwconv2d_traffic(b, hi_v, wi_v, c, st.hf, st.wf,
                                    st.stride, dtype_bytes=nb)
            if st.bias or st.activation is not None:
                # standalone-DW epilogue: a separate elementwise op in the
                # lowering that re-reads and re-writes the whole output
                # tensor (+ the bias vector); with neither bias nor
                # activation it is a no-op, so only count it then
                epi = nb * (2 * b * ho * wo * c + (c if st.bias else 0))
                t = it.Traffic(t.flops + b * ho * wo * c,
                               t.bytes_hbm + epi)
            h, w = ho, wo
        flops += t.flops
        bytes_ += t.bytes_hbm
    if chain_plan.residual:
        if chain_plan.residual_fused:
            # the kernel streams the residual operand once; the accumulate
            # and store are already inside the fused pass
            bytes_ += nb * b * h * w * c
        else:
            # separate elementwise add: read both operands, write the sum
            bytes_ += nb * 3 * b * h * w * c
        flops += b * h * w * c
    return it.Traffic(flops, bytes_)
