"""Whole-network chain engine: NetworkSpec -> NetworkPlan -> execute_network.

Counterpart of ``repro/core/network.py`` for the MobileNet V1 and V2,
MnasNet-A1 and EfficientNet-Lite0 bodies:

* :class:`NetworkSpec` — an ordered tuple of ``SeparableSpec`` blocks and
  the stem width; frozen and hashable.
* :func:`plan_network` -> :class:`NetworkPlan` — every block's
  ``ChainPlan`` resolved once by walking shapes and dtypes through the
  network.
* :func:`build_network_fn` — the per-block runners composed into one
  eager ``run(params, x)`` that launches the blocks' kernels one after the
  other on the current stream.
* :func:`execute_network` — the whole body.  On the card it is one CUDA
  graph per memoized plan (the counterpart of the reference's one jitted
  call): the first call for a (spec, shape, dtype, policy, device, params)
  plans, captures the eager runner and replays it; later calls copy ``x``
  in and replay.  On the CPU the eager runner runs.  A kernel or capture
  failure raises, unless the policy opts into the runtime ladder
  (``KernelPolicy(on_failure="degrade")``, ``runtime/executor.run_network``):
  then a classified failure quarantines the failing rungs, the failing
  blocks recover one by one, and the next call re-plans and captures a new
  graph.  A plan is memoized only after its first call returned.
* :class:`NetworkModule` — an ``nn.Module`` holding the parameters whose
  ``forward`` is :func:`execute_network`.
* under ``KernelPolicy(verify=True)``, :func:`plan_network` (and
  :func:`execute_network` with an explicit plan) holds every block's plan
  to the static verifier (``repro_torch.analysis``) before anything is
  captured;
* :func:`tune_network` — the measured autotuner over a whole body: each
  block tuned on its real input (``kernels/autotune.py``), the assembled
  plan persisted under :func:`network_key`.  With ``policy.autotune``,
  :func:`plan_network` consults that entry and :func:`execute_network`
  tunes on a memo miss before it captures its graph.

    net = mobilenet_v2_spec()
    params = init_network(net, seed=0)                # on the card
    y = execute_network(net, params, x,
                        policy=KernelPolicy(dtype_policy=BF16_STREAM))
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import graphs
from repro_torch.core import chain
from repro_torch.kernels import autotune, lowering
from repro_torch.kernels.blocking import ChainPlan
from repro_torch.kernels.policy import (DEFAULT_POLICY, DTYPES, DtypePolicy,
                                        KernelPolicy)
from repro_torch.runtime import faultinject


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """An ordered chain of separable blocks; ``c_in`` is the width the
    first block consumes (the stem output)."""
    name: str
    c_in: int
    blocks: Tuple[chain.SeparableSpec, ...]

    def __post_init__(self):
        if not self.blocks:
            raise ValueError("empty network")

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def out_channels(self) -> int:
        c = self.c_in
        for b in self.blocks:
            c = b.out_channels(c)
        return c


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round to the nearest multiple of ``divisor``, never below 90% of v."""
    new = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new < 0.9 * v:
        new += divisor
    return new


#: MobileNetV1 body after the 32-channel stem: (c_out, stride) per block
#: (Howard et al. 2017, Table 1).
MOBILENET_V1_BODY: Tuple[Tuple[int, int], ...] = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)

#: MobileNetV2 body after the 32-channel stem: (t, c, n, s) rows
#: (Sandler et al. 2018, Table 2).
MOBILENET_V2_BODY: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
)


#: MnasNet-A1 body after the 32-channel stem: (t, c, n, s, k, se) rows
#: (Tan et al. 2019, Fig. 7: expansion, channels, repeats, stride, DW
#: kernel, squeeze-excite).  The t=1 first row is the SepConv block.
MNASNET_A1_BODY: Tuple[Tuple[int, int, int, int, int, bool], ...] = (
    (1, 16, 1, 1, 3, False), (6, 24, 2, 2, 3, False),
    (3, 40, 3, 2, 5, True), (6, 80, 4, 2, 3, False),
    (6, 112, 2, 1, 3, True), (6, 160, 3, 2, 5, True),
    (6, 320, 1, 1, 3, False),
)

#: EfficientNet-Lite0 body after the 32-channel stem: (t, c, n, s, k,
#: fused) rows: the B0 table (Tan & Le 2019) with the Lite edits (no SE,
#: relu6) and the two early stages as fused-MBConv blocks.
EFFICIENTNET_LITE0_BODY: Tuple[Tuple[int, int, int, int, int, bool], ...] = (
    (1, 16, 1, 1, 3, False), (6, 24, 2, 2, 3, True),
    (6, 40, 2, 2, 3, True), (6, 80, 3, 2, 3, False),
    (6, 112, 3, 1, 5, False), (6, 192, 4, 2, 5, False),
    (6, 320, 1, 1, 3, False),
)


def mobilenet_v1_spec(width_mult: float = 1.0) -> NetworkSpec:
    """The 13-block MobileNetV1 body: DW(+bias) -> PW(+bias) per block."""
    blocks = tuple(
        chain.separable_block_spec(make_divisible(c * width_mult), stride=s)
        for c, s in MOBILENET_V1_BODY)
    return NetworkSpec(name=f"mobilenet_v1_{width_mult:g}",
                       c_in=make_divisible(32 * width_mult), blocks=blocks)


def mobilenet_v2_spec(width_mult: float = 1.0) -> NetworkSpec:
    """The 17-block MobileNetV2 body: a (DW, PW) first block, then 16 t=6
    inverted residuals."""
    c = make_divisible(32 * width_mult)
    c_in = c
    blocks = []
    for t, co, n, s in MOBILENET_V2_BODY:
        co = make_divisible(co * width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            if t == 1:
                blocks.append(chain.SeparableSpec(stages=(
                    chain.DW(stride=stride, activation="relu6"),
                    chain.PW(co),
                ), residual="auto"))
            else:
                blocks.append(chain.inverted_residual_spec(
                    c, co, expand=t, stride=stride))
            c = co
    return NetworkSpec(name=f"mobilenet_v2_{width_mult:g}",
                       c_in=c_in, blocks=tuple(blocks))


def _mbconv_body(name: str, table, width_mult: float, activation: str,
                 flagged) -> NetworkSpec:
    """A (t, c, n, s, k, flag) body: a (DW, PW) first row, then per row
    ``flagged(c_in, c_out, t, stride, k)`` when the flag is set, else an
    inverted residual."""
    c = make_divisible(32 * width_mult)
    c_in = c
    blocks = []
    for t, co, n, s, k, flag in table:
        co = make_divisible(co * width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            if t == 1:
                blocks.append(chain.SeparableSpec(stages=(
                    chain.DW(stride=stride, activation=activation),
                    chain.PW(co),
                ), residual="auto"))
            elif flag:
                blocks.append(flagged(c, co, t, stride, k))
            else:
                blocks.append(chain.inverted_residual_spec(
                    c, co, expand=t, stride=stride, hf=k))
            c = co
    return NetworkSpec(name=f"{name}_{width_mult:g}", c_in=c_in,
                       blocks=tuple(blocks))


def mnasnet_a1_spec(width_mult: float = 1.0) -> NetworkSpec:
    """The 16-block MnasNet-A1 body.  Its three SE stages declare
    (PW, DW, SE, PW) chains, which plan as ``pw``, ``dw_se``, ``pw``."""
    return _mbconv_body(
        "mnasnet_a1", MNASNET_A1_BODY, width_mult, "relu",
        lambda c, co, t, stride, k: chain.mbconv_se_spec(
            c, co, expand=t, stride=stride, hf=k))


def efficientnet_lite0_spec(width_mult: float = 1.0) -> NetworkSpec:
    """The 16-block EfficientNet-Lite0 body.  Its fused-MBConv stages
    declare (FusedMB, PW) chains, which plan as one ``fusedmb`` pass."""
    return _mbconv_body(
        "efficientnet_lite0", EFFICIENTNET_LITE0_BODY, width_mult, "relu6",
        lambda c, co, t, stride, k: chain.fused_mbconv_spec(
            c, co, expand=t, stride=stride, hf=k))


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def init_network(net: NetworkSpec, generator: Optional[torch.Generator] = None,
                 *, seed: int = 0, dtype: torch.dtype = torch.float32,
                 device="cuda") -> list:
    """Per-block ``init_chain`` params from one seeded generator, on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = require_device(device)
    gen = generator or torch.Generator().manual_seed(seed)
    params = []
    c = net.c_in
    for spec in net.blocks:
        params.append(chain.init_chain(gen, spec, c, dtype, dev))
        c = spec.out_channels(c)
    return params


def cast_network_params(params, dtype: torch.dtype) -> list:
    """Cast every parameter once, up front (weights stored at the stream
    width make the lowering's per-call casts no-ops)."""
    return [[{k: v.to(dtype) for k, v in p.items()} for p in block]
            for block in params]


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Per-block ``ChainPlan``s, the shape/dtype walk they were planned at,
    and the :func:`network_key` of the problem (the unit the network-level
    tune-cache entry stores)."""
    plans: Tuple[ChainPlan, ...]
    block_shapes: Tuple[Tuple[int, int, int, int], ...]
    block_dtypes: Tuple[str, ...]
    out_shape: Tuple[int, int, int, int]
    key: str

    @property
    def n_blocks(self) -> int:
        return len(self.plans)

    @property
    def n_kernel_passes(self) -> int:
        return sum(p.n_kernel_passes for p in self.plans)

    @property
    def fully_fused(self) -> bool:
        return all(p.fully_fused for p in self.plans)

    def segment_histogram(self) -> dict:
        """{'fused3': n, 'fused2': m, ...} across all blocks."""
        return dict(collections.Counter(
            seg.kind for p in self.plans for seg in p.segments))


def resolve_block_policies(
    net: NetworkSpec, policy: KernelPolicy,
    block_dtype_policies: Optional[Sequence[DtypePolicy]] = None,
) -> Tuple[KernelPolicy, ...]:
    """The effective per-block policy.  Broadcasting one policy, inner
    blocks hand off at the stream width (their ``out`` is cleared; only the
    last block honours the pin).  Explicit ``block_dtype_policies`` are
    taken verbatim."""
    n = net.n_blocks
    if block_dtype_policies is None:
        dp = policy.dtype_policy
        inner = dataclasses.replace(dp, out=None)
        return tuple(
            dataclasses.replace(policy,
                                dtype_policy=dp if i == n - 1 else inner)
            for i in range(n))
    if len(block_dtype_policies) != n:
        raise ValueError(f"{len(block_dtype_policies)} block policies for "
                         f"{n} blocks")
    return tuple(dataclasses.replace(policy, dtype_policy=d)
                 for d in block_dtype_policies)


_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def _block_problems(net: NetworkSpec, x_shape, dtype: torch.dtype,
                    policies: Sequence[KernelPolicy]):
    """Walk (shape, dtype) through the network: block i+1's input dtype is
    block i's out dtype, exactly what the lowering emits."""
    b, h, w, c = (int(v) for v in x_shape)
    if c != net.c_in:
        raise ValueError(f"input has {c} channels, the network takes "
                         f"{net.c_in}")
    problems = []
    d = dtype
    for spec, pol in zip(net.blocks, policies):
        problems.append(((b, h, w, c), _DTYPE_NAMES[d]))
        for s in spec.stages:
            if isinstance(s, (chain.DW, chain.FusedMB)):
                h, w = s.out_dims(h, w)
        c = spec.out_channels(c)
        d = pol.dtype_policy.out_dtype(d)
    return problems, (b, h, w, c)


def network_signature(net: NetworkSpec, x_shape, dtype: torch.dtype,
                      policy: KernelPolicy, block_dtype_policies=None,
                      device=None) -> dict:
    """The whole-network identity a tuned NetworkPlan is valid for: the
    per-block problem signatures (``autotune.problem_signature``) on
    ``device``."""
    policies = resolve_block_policies(net, policy, block_dtype_policies)
    problems, _ = _block_problems(net, x_shape, dtype, policies)
    return {
        "name": net.name,
        "blocks": [
            autotune.problem_signature(spec, shape, DTYPES[dt], pol, device)
            for spec, (shape, dt), pol in zip(net.blocks, problems, policies)
        ],
    }


def network_key(net: NetworkSpec, x_shape, dtype: torch.dtype,
                policy: KernelPolicy, block_dtype_policies=None,
                device=None) -> str:
    return "net:" + autotune.signature_digest(network_signature(
        net, x_shape, dtype, policy, block_dtype_policies, device))


def plan_network(net: NetworkSpec, x_shape, *,
                 dtype: torch.dtype = torch.float32,
                 policy: KernelPolicy = DEFAULT_POLICY,
                 block_dtype_policies: Optional[Sequence[DtypePolicy]] = None,
                 device=None) -> NetworkPlan:
    """Resolve every block's ChainPlan once.

    With ``policy.autotune`` the network-level tune-cache entry for this
    problem on ``device`` (default the card where there is one) wins when
    it is valid; otherwise each block's ``chain.plan`` answers, itself
    consulting the per-block entries, so a partly tuned cache still helps.
    Nothing is measured here: :func:`tune_network` does that.  Under
    ``policy.verify`` the plan, cached or fresh, is verified once, block by
    block (:func:`_maybe_verify_network`), before it is returned."""
    key = network_key(net, x_shape, dtype, policy, block_dtype_policies,
                      device)
    if policy.autotune:
        found = _lookup_network_entry(net, key, x_shape, dtype, policy,
                                      block_dtype_policies, device)
        if found is not None:
            return _maybe_verify_network(net, found[0], policy,
                                         block_dtype_policies)
    policies = resolve_block_policies(
        net, dataclasses.replace(policy, verify=False), block_dtype_policies)
    problems, out_shape = _block_problems(net, x_shape, dtype, policies)
    return _maybe_verify_network(net, NetworkPlan(
        plans=tuple(
            chain.plan(spec, shape, dtype=DTYPES[dt], policy=pol,
                       device=device)
            for spec, (shape, dt), pol in zip(net.blocks, problems,
                                              policies)),
        block_shapes=tuple(shape for shape, _ in problems),
        block_dtypes=tuple(dt for _, dt in problems),
        out_shape=out_shape,
        key=key,
    ), policy, block_dtype_policies)


def _maybe_verify_network(net: NetworkSpec, nplan: NetworkPlan,
                          policy: KernelPolicy,
                          block_dtype_policies=None) -> NetworkPlan:
    """``policy.verify`` at network scope: the static verifier (no trace)
    over every block's plan, raising ``analysis.PlanVerificationError`` on
    an error; ``nplan`` unchanged otherwise (the reference's
    ``network.py:419-427``)."""
    if policy.verify:
        from repro_torch import analysis  # the analysis sits above core
        analysis.verify_or_raise(analysis.analyze_network(
            net, nplan, policy=policy,
            block_dtype_policies=block_dtype_policies, trace=False))
    return nplan


def _network_mismatch(net: NetworkSpec, nplan: NetworkPlan, x_shape,
                      dtype: torch.dtype, policy: KernelPolicy,
                      block_dtype_policies=None) -> Optional[str]:
    """Why a replayed network entry is not one the tuner could have
    written for this problem, or None: it must walk the network's shapes
    and dtypes, and each block's plan must pass planlint and
    ``autotune.plan_mismatch`` against the block's analytic plan
    (``autotune.cached_plan_problem``)."""
    policies = resolve_block_policies(net, policy, block_dtype_policies)
    problems, out_shape = _block_problems(net, x_shape, dtype, policies)
    if (len(nplan.plans) != net.n_blocks
            or nplan.block_shapes != tuple(sh for sh, _ in problems)
            or nplan.block_dtypes != tuple(dt for _, dt in problems)
            or nplan.out_shape != out_shape):
        return "its shapes and dtypes are not the network's walk"
    for i, (spec, cp, (shape, dt), pol) in enumerate(zip(
            net.blocks, nplan.plans, problems, policies)):
        base = chain.plan(spec, shape, dtype=DTYPES[dt],
                          policy=dataclasses.replace(pol, autotune=False,
                                                     verify=False))
        why = autotune.cached_plan_problem(
            spec, cp, shape, base, pol.dtype_policy.stream_dtype(DTYPES[dt]))
        if why is not None:
            return f"block {i}: {why}"
    return None


def _serialize_network_plan(nplan: NetworkPlan) -> dict:
    return {
        "plans": [autotune.serialize_chain_plan(p) for p in nplan.plans],
        "block_shapes": [list(s) for s in nplan.block_shapes],
        "block_dtypes": list(nplan.block_dtypes),
        "out_shape": list(nplan.out_shape),
    }


def _deserialize_network_plan(key: str, d: dict) -> NetworkPlan:
    return NetworkPlan(
        plans=tuple(autotune.deserialize_chain_plan(p) for p in d["plans"]),
        block_shapes=tuple(tuple(int(v) for v in s)
                           for s in d["block_shapes"]),
        block_dtypes=tuple(str(v) for v in d["block_dtypes"]),
        out_shape=tuple(int(v) for v in d["out_shape"]),
        key=key,
    )


def _block_bans(net: NetworkSpec, nplan: NetworkPlan, policy: KernelPolicy,
                block_dtype_policies=None, device=None) -> tuple:
    """The rungs quarantined for each block's problem on ``device``
    (default: ``autotune.default_device()``) under
    ``on_failure="degrade"``; none under ``"raise"``, which never reads the
    quarantine."""
    if policy.on_failure != "degrade":
        return (frozenset(),) * net.n_blocks
    from repro_torch.runtime import quarantine  # runtime sits above core
    policies = resolve_block_policies(net, policy, block_dtype_policies)
    return tuple(
        quarantine.banned_kinds(spec, shape, DTYPES[dt], pol, device)
        for spec, pol, shape, dt in zip(net.blocks, policies,
                                        nplan.block_shapes,
                                        nplan.block_dtypes))


def _lookup_network_entry(net: NetworkSpec, key: str, x_shape,
                          dtype: torch.dtype, policy: KernelPolicy,
                          block_dtype_policies=None, device=None):
    """(the valid NetworkPlan, its raw entry) stored under ``key``, or
    None on a miss, an undecodable or stale entry, or (under
    ``on_failure="degrade"``) an entry whose plan uses a quarantined rung
    on ``device``."""
    entry = autotune.TuneCache.load(autotune.cache_path(policy)).get(key)
    if entry is None:
        return None
    try:
        nplan = _deserialize_network_plan(key, entry["network_plan"])
    except (KeyError, TypeError, ValueError):
        return None
    from repro_torch.runtime.quarantine import uses_banned
    bad = [i for i, (cp, banned) in enumerate(zip(
        nplan.plans, _block_bans(net, nplan, policy, block_dtype_policies,
                                 device))) if uses_banned(cp, banned)]
    if bad:
        warnings.warn(f"dropping network tune-cache entry {key} from "
                      f"{autotune.cache_path(policy)}: blocks {bad} use "
                      "quarantined rungs; re-planning around them",
                      stacklevel=3)
        return None
    why = _network_mismatch(net, nplan, x_shape, dtype, policy,
                            block_dtype_policies)
    if why is not None:
        # a stale entry is a performance artifact: drop it and re-plan
        warnings.warn(f"dropping network tune-cache entry {key} from "
                      f"{autotune.cache_path(policy)}: {why}; re-planning "
                      "(the entry is stale: delete the cache or re-tune)",
                      stacklevel=3)
        return None
    return nplan, entry


@dataclasses.dataclass(frozen=True)
class NetworkTuneResult:
    """What :func:`tune_network` answered: the plan, whether the network
    entry replayed (``n_measured == 0`` then), the sums over blocks of the
    winners' and the analytic plans' measured microseconds (on a hit, as
    recorded at tune time) and, on a miss, every chain plan measured as
    ``(block, ChainPlan, seconds)`` and every candidate that failed as
    ``(block, {"candidate", "error"})``."""
    plan: NetworkPlan
    cache_hit: bool
    n_measured: int
    key: str
    cache_path: str
    measured_us: float
    analytic_us: float
    measured: tuple = ()
    failed: tuple = ()


def tune_network(net: NetworkSpec, params, x: torch.Tensor, *,
                 policy: KernelPolicy,
                 block_dtype_policies: Optional[Sequence[DtypePolicy]] = None,
                 warmup: int = 1, repeats: int = 5) -> NetworkTuneResult:
    """Measured whole-network plan: tune each block
    (``autotune.autotune_chain``) on its real input, produced by running the
    blocks before it at their tuned plans, then persist the assembled plan
    under :func:`network_key`.

    A valid network entry replays with ZERO measurements and no launch;
    per-block entries (from another network that shares a block) skip
    measurement block by block.  A candidate whose failure is classified
    loses (``autotune.autotune_chain``) and is listed in the block's entry
    and in the network entry's ``failed``; when every candidate of a block
    failed, the network entry is not written.  Any other candidate failure
    raises and the network entry is not written; so does a miss inside a
    CUDA-graph capture."""
    path = autotune.cache_path(policy)
    key = network_key(net, x.shape, x.dtype, policy, block_dtype_policies,
                      x.device)
    found = _lookup_network_entry(net, key, x.shape, x.dtype, policy,
                                  block_dtype_policies, x.device)
    if found is not None:
        nplan, entry = found
        return NetworkTuneResult(
            plan=nplan, cache_hit=True, n_measured=0, key=key,
            cache_path=path,
            measured_us=float(entry.get("measured_us", 0.0)),
            analytic_us=float(entry.get("analytic_us", 0.0)))
    if autotune.capturing():
        raise RuntimeError(f"tune_network: tune-cache miss for {key} inside "
                           "a CUDA-graph capture (tune before capturing)")
    if len(params) != net.n_blocks:
        raise ValueError(f"{len(params)} param blocks for {net.n_blocks} "
                         "blocks")
    policies = resolve_block_policies(net, policy, block_dtype_policies)
    problems, out_shape = _block_problems(net, x.shape, x.dtype, policies)
    plans, measured, failed = [], [], []
    n_measured, measured_us, analytic_us = 0, 0.0, 0.0
    y = x
    with torch.inference_mode():
        for i, (spec, p, pol) in enumerate(zip(net.blocks, params,
                                               policies)):
            base = chain.plan(spec, y.shape, dtype=y.dtype,
                              policy=dataclasses.replace(pol,
                                                         autotune=False))
            r = autotune.autotune_chain(spec, p, y, policy=pol,
                                        base_plan=base, warmup=warmup,
                                        repeats=repeats)
            plans.append(r.plan)
            n_measured += r.n_measured
            measured_us += r.measured_us
            analytic_us += r.analytic_us
            measured.extend((i, cp, t) for cp, t in r.measured)
            failed.extend((i, f) for f in r.failed)
            y = lowering.lower(spec, r.plan, pol)(p, y)
    nplan = NetworkPlan(
        plans=tuple(plans),
        block_shapes=tuple(shape for shape, _ in problems),
        block_dtypes=tuple(dt for _, dt in problems),
        out_shape=out_shape,
        key=key,
    )
    if measured_us != float("inf"):
        # a block whose every candidate failed is not persisted; neither
        # is the network that holds it
        cache = autotune.TuneCache.load(path)
        cache.put(key, {
            "signature": network_signature(net, x.shape, x.dtype, policy,
                                           block_dtype_policies, x.device),
            "network_plan": _serialize_network_plan(nplan),
            "n_measured": n_measured,
            "measured_us": measured_us,
            "analytic_us": analytic_us,
            "failed": [dict(f, block=b) for b, f in failed],
        })
        cache.save()
    return NetworkTuneResult(plan=nplan, cache_hit=False,
                             n_measured=n_measured, key=key, cache_path=path,
                             measured_us=measured_us,
                             analytic_us=analytic_us,
                             measured=tuple(measured), failed=tuple(failed))


def _plain_rung(run):
    """A block's plain runner with fault injection suppressed: the ladder's
    last rung must not be injectable."""
    def plain(params, x):
        with faultinject.suppressed():
            return run(params, x)
    return plain


def plain_blocks(net: NetworkSpec, nplan: NetworkPlan, policy: KernelPolicy,
                 block_dtype_policies=None, device=None) -> Tuple[bool, ...]:
    """For each block, whether it runs at the ladder's ``ref`` rung: under
    ``policy.on_failure == "degrade"``, whether its problem on ``device``
    has ``unfused`` quarantined.  All False under ``"raise"``."""
    return tuple("unfused" in banned for banned in _block_bans(
        net, nplan, policy, block_dtype_policies, device))


def build_network_fn(net: NetworkSpec, nplan: NetworkPlan,
                     policy: KernelPolicy = DEFAULT_POLICY,
                     block_dtype_policies=None, device=None):
    """Compose the per-block lowered runners into one eager ``run(params,
    x)``; every block runs its planned blocks verbatim.  This is what
    :func:`execute_network` captures on the card, and the eager path to
    hold the captured one against.  The runner passes the
    ``compile:network`` fault-injection point before its first block: on
    the card that is the graph's warm-up and capture, never a replay.

    Under ``policy.on_failure == "degrade"`` a block whose problem on
    ``device`` has ``unfused`` quarantined (:func:`plain_blocks`) — its
    standalone kernels failed too, which a ChainPlan cannot express — runs
    its plain version (``impl="torch"``) on the same
    tensors, with fault injection suppressed: the ladder's ``ref`` rung,
    inside the same captured graph as the other blocks' kernels."""
    policies = resolve_block_policies(net, policy, block_dtype_policies)
    plain = plain_blocks(net, nplan, policy, block_dtype_policies, device)
    runners = [
        _plain_rung(lowering.lower(spec, cp,
                                   dataclasses.replace(pol, impl="torch")))
        if ref else lowering.lower(spec, cp, pol)
        for spec, cp, pol, ref in zip(net.blocks, nplan.plans, policies,
                                      plain)]

    def run(params, x):
        if len(params) != len(runners):
            raise ValueError(f"{len(params)} param blocks for "
                             f"{len(runners)} blocks")
        faultinject.check("compile:network")
        for r, p in zip(runners, params):
            x = r(p, x)
        return x

    return run


@dataclasses.dataclass
class _Memo:
    """One memoized problem: its plan, the eager runner, the parameter
    tensors (held, so that no address a graph reads is freed and reused),
    and on the card the captured forward and the input buffer it reads."""
    plan: NetworkPlan
    run: Callable
    tensors: tuple
    graph: Optional[graphs.Captured] = None
    x: Optional[torch.Tensor] = None


#: (net, shape, dtype, policy, device, block policies, explicit plan,
#: parameter addresses) -> _Memo.
_NETWORK_CACHE: dict = {}


def clear_network_cache() -> None:
    """Forget every memoized plan, and release the CUDA graphs and the
    memory of their pools."""
    _NETWORK_CACHE.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _memo_key(net, params, x, policy, network_plan, block_dtype_policies):
    return (net, tuple(x.shape), x.dtype, policy, x.device,
            block_dtype_policies, network_plan,
            tuple(v.data_ptr() for block in params for p in block
                  for v in p.values()))


def execute_network(net: NetworkSpec, params, x: torch.Tensor, *,
                    policy: KernelPolicy = DEFAULT_POLICY,
                    network_plan: Optional[NetworkPlan] = None,
                    block_dtype_policies: Optional[Tuple[DtypePolicy, ...]]
                    = None) -> torch.Tensor:
    """Run the whole body.  The first call for a given (net, input shape,
    dtype, policy, device, parameter tensors) plans and builds the eager
    runner (:func:`build_network_fn`); later calls reuse them.  The backend
    follows ``x``'s device (``policy.impl="auto"``).  With
    ``policy.autotune`` the first call's plan comes from
    :func:`tune_network` (which replays the tune cache when it can), before
    any graph is captured; inside an outer capture it comes from
    :func:`plan_network`, which never measures.

    On a CUDA tensor the forward is one CUDA graph, the counterpart of the
    reference's one jitted call: the first call captures the eager runner
    (:func:`graphs.capture`) on a copy of ``x`` and memoizes the graph once
    its first replay has run; every later call copies ``x`` into that input
    buffer and replays.  Each call returns a copy of the graph's output
    buffer, so a later call never overwrites an earlier result.  The
    parameters are part of the key by their addresses: the graph reads them
    where they lay when it was captured, and the memo holds them.  Weights
    updated in place are therefore seen by the next replay, and another set
    of tensors gets a graph of its own.  Called while a capture is under way,
    it runs the eager runner, which the outer capture records.  On a CPU
    tensor the eager runner runs.  A plan is memoized only after its first
    call returned (its capture and first replay on the card), so a plan
    that failed is planned again on the next call.

    Under ``policy.on_failure == "degrade"`` (and with
    ``policy.numeric_guard``) the call runs through the runtime ladder
    (``runtime/executor.run_network``): the steady state is this same graph
    plus one ``try``; a classified failure quarantines the failing rungs
    and recovers block by block, eagerly, and the next call re-plans around
    the bans and captures a new graph.  Inside an outer capture nothing
    can recover: a failure there propagates.
    """
    return execute_network_graph(
        net, params, x, policy=policy, network_plan=network_plan,
        block_dtype_policies=block_dtype_policies)[0]


def execute_network_graph(net: NetworkSpec, params, x: torch.Tensor, *,
                          policy: KernelPolicy = DEFAULT_POLICY,
                          network_plan: Optional[NetworkPlan] = None,
                          block_dtype_policies=None):
    """:func:`execute_network`, returning ``(output, graph)``: the
    :class:`graphs.Captured` that gave the output (its capture time and the
    launches it recorded), or None where the eager runner ran (or the
    runtime ladder recovered block by block)."""
    if policy.on_failure == "degrade" or policy.numeric_guard:
        from repro_torch.runtime import executor  # runtime sits above core
        return executor.run_network(
            net, params, x, policy=policy, network_plan=network_plan,
            block_dtype_policies=block_dtype_policies)
    return _execute_network_raw(net, params, x, policy=policy,
                                network_plan=network_plan,
                                block_dtype_policies=block_dtype_policies)


def _execute_network_raw(net: NetworkSpec, params, x: torch.Tensor, *,
                         policy: KernelPolicy = DEFAULT_POLICY,
                         network_plan: Optional[NetworkPlan] = None,
                         block_dtype_policies=None):
    """The unguarded engine behind :func:`execute_network_graph`: plan,
    capture, memoize, replay.  The memo is written only after the first
    call returned, on every branch: a plan whose call failed must not stay
    memoized, or the re-plan after a quarantine write could never happen."""
    key = _memo_key(net, params, x, policy, network_plan,
                    block_dtype_policies)
    memo = _NETWORK_CACHE.get(key)
    capturing = (x.device.type == "cuda"
                 and torch.cuda.is_current_stream_capturing())
    if memo is None:
        nplan = network_plan
        if nplan is not None:
            _maybe_verify_network(net, nplan, policy, block_dtype_policies)
        elif policy.autotune and not capturing:
            nplan = _maybe_verify_network(net, tune_network(
                net, params, x, policy=policy,
                block_dtype_policies=block_dtype_policies).plan, policy,
                block_dtype_policies)
        else:
            nplan = plan_network(
                net, x.shape, dtype=x.dtype, policy=policy,
                block_dtype_policies=block_dtype_policies, device=x.device)
        memo = _Memo(nplan, build_network_fn(net, nplan, policy,
                                             block_dtype_policies, x.device),
                     tuple(v for block in params for p in block
                           for v in p.values()))
    with torch.inference_mode():
        if x.device.type != "cuda" or capturing:
            y = memo.run(params, x)
            _NETWORK_CACHE[key] = memo
            return y, None
        if memo.graph is None:
            static_x = x.clone()
            graph = graphs.capture(lambda: memo.run(params, static_x),
                                   x.device)
            # memoized only once the capture and its first replay ran
            memo.graph, memo.x = graph, static_x
            _NETWORK_CACHE[key] = memo
        else:
            memo.x.copy_(x)
            memo.graph.replay()
        return memo.graph.output.clone(), memo.graph


class NetworkModule(nn.Module):
    """The parameters of a network body, with :func:`execute_network` as
    ``forward``.  Parameters are frozen (inference only)."""

    def __init__(self, net: NetworkSpec, params,
                 policy: KernelPolicy = DEFAULT_POLICY):
        super().__init__()
        self.net = net
        self.policy = policy
        self.blocks = nn.ModuleList(
            nn.ModuleList(
                nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                  for k, v in p.items()})
                for p in block)
            for block in params)

    def params(self) -> list:
        return [[dict(pd.items()) for pd in block] for block in self.blocks]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return execute_network(self.net, self.params(), x,
                               policy=self.policy)
