"""The paper's workload on the port: MobileNet V1/V2, MnasNet-A1 and
EfficientNet-Lite0 bodies end to end through ``execute_network``, on the
card by default.

    python -m repro_torch.mobilenet_inference
        [--arch v1|v2|mnasnet|lite0|all]
        [--dtype fp32|bf16] [--res N] [--batch B] [--device cuda|cpu]
        [--unfused] [--autotune [--tune-cache PATH]] [--verify]
        [--fault-inject POINTS [--numeric-guard]]

For each network it prints the plan histogram, the kernel launches of one
eager forward and (on the card) the kernels one replay of the graph ran,
counted in a profiler trace, and for ``execute_network`` (on the card one
CUDA graph of the forward) and for its eager runner (``build_network_fn``,
every block launched from the host) the ms per forward (CUDA events on the
card, median of 10), the device time and busy share, and the forward's own
peak device memory; then the capture time, the card memory the graph's
first call reserved and what the graph held until the cache was cleared,
whether the two paths give the same bits, and the error against the plain
path: the same network with ``impl="torch"`` in fp32 on the same device,
run eagerly.  Counterpart of ``examples/mobilenet_inference.py``.

For every network it also prints the reference's "modeled HBM" line
(``examples/mobilenet_inference.py:77-89``): the device-memory bytes of a
forward that ``core/intensity.network_traffic`` models for the plan run,
for the fp32 fused plan and for the per-block unfused plan, and the
plan's arithmetic intensity.  The model prices the reference's tiling at
the plans' fields (``core/intensity.py``), not the Hopper kernels' own
traffic.  ``--verify`` runs the static verifier (``repro_torch.analysis``:
planlint and the launch limits) on each network's plan before anything
runs, prints its summary and raises on an error.

``--autotune`` runs each network at its measured plans
(``KernelPolicy(autotune=True)``, ``core/network.tune_network``): the
first run of a problem measures every block's candidate plans and persists
the winners in the tune cache (``--tune-cache PATH``, default
``kernels/autotune.default_cache_path()``: ``$REPRO_TORCH_TUNE_CACHE``,
else ``build/repro_torch/autotune.json`` in the checkout); a later run
replays them with no measurement.  The tune runs before any counted or
timed call, and the script prints whether it was a cache hit, the plans
it measured and its seconds.

``--fault-inject POINTS`` arms the runtime's fault-injection points
(comma-separated ``point[:times]``, persistent without ``times``; the
catalog is ``runtime/faultinject.INJECTION_POINTS``) and, since the port's
default policy raises, runs each network under
``KernelPolicy(on_failure="degrade")`` for that run (:func:`run_recovery`):
the first forward meets the faults and recovers block by block, the
second plans around the quarantine (``runtime/quarantine.py``) and
captures a new graph.  The quarantine is the run's own: beside
``--tune-cache`` where given (delete that ``quarantine.json`` to clear the
bans), else in a temporary directory under ``build/repro_torch/`` that
goes at exit, so injected bans never reach the default store that real
``on_failure="degrade"`` runs read.  At the end it prints ``runtime_report()`` and
``fired_counts()``, and fails unless every fallback was injected.
``--numeric-guard`` adds the finite check on each output (the
``numeric:*`` points need it).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

from repro_torch import graphs
from repro_torch.core import intensity, network
from repro_torch.kernels import _build, pwconv
from repro_torch.kernels.policy import BF16_STREAM, NATIVE, KernelPolicy
from repro_torch.measure import profile_calls, rel_err, time_ms
from repro_torch.runtime import faultinject, quarantine, telemetry

#: bf16-streamed network vs the fp32 plain path: one bf16 rounding per
#: streamed operand per block, compounded over 13-17 blocks (the
#: reference's gate, ``examples/mobilenet_inference.py:43``).
BF16_REL_TOL = 5e-2
#: fp32 kernels vs the fp32 plain path: the same products summed in
#: another order than cuDNN and cuBLAS (or the CPU's) sum them.
FP32_REL_TOL = 1e-4

#: The networks ``--arch`` names.
ARCHS = {"v1": network.mobilenet_v1_spec, "v2": network.mobilenet_v2_spec,
         "mnasnet": network.mnasnet_a1_spec,
         "lite0": network.efficientnet_lite0_spec}

#: Launch counter name -> segment kinds it serves, with the launches one
#: segment makes (a standalone ``se`` runs its two FCs through ``pwconv``;
#: ``mb`` is the plain ``F.conv2d`` and launches none of ours).
KERNEL_SEGMENTS = {"dwconv2d": {"dw": 1}, "pwconv": {"pw": 1, "se": 2},
                   "separable_fused2": {"fused2": 1},
                   "separable_fused3": {"fused3": 1},
                   "fused_mbconv": {"fusedmb": 1}, "dw_se": {"dw_se": 1}}


def expected_launches(histogram: dict) -> dict:
    """Kernel launches one forward of a plan with this segment histogram
    makes, by kernel name."""
    return {name: sum(n * histogram.get(kind, 0) for kind, n in kinds.items())
            for name, kinds in KERNEL_SEGMENTS.items()}


def launch_counts() -> dict:
    """The launch counters of the kernels the CNN bodies run, by kernel
    name."""
    counts = graphs.snapshot()
    return {name: counts[name] for name in KERNEL_SEGMENTS}


def reset_launch_counts() -> None:
    graphs.reset()


def _counted(fn, dev):
    """``fn()`` with the launch counters zeroed just before and read just
    after, and the memory it allocated beyond what was allocated before it:
    (output, launches, ``pwconv`` launches by variant, own peak bytes or
    None on the CPU)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    reset_launch_counts()
    y = fn()
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before if cuda else None
    return y, launch_counts(), dict(pwconv.launches_by_variant), peak


def modeled_traffic(net: network.NetworkSpec, nplan: network.NetworkPlan,
                    policy: KernelPolicy) -> dict:
    """The modeled device-memory bytes of one forward
    (``intensity.network_traffic``) of ``nplan``, of the fp32 plan with
    the default fusion and of the fp32 per-block unfused plan at the same
    input, and ``nplan``'s FLOPs and arithmetic intensity (FLOPs a byte)."""
    x_shape = nplan.block_shapes[0]
    t = intensity.network_traffic(net, nplan)
    fp32, unfused = (
        intensity.network_traffic(net, network.plan_network(
            net, x_shape, device="cpu", policy=KernelPolicy(fused=fused)))
        for fused in (None, False))
    return {"bytes": t.bytes_hbm, "flops": t.flops,
            "intensity": t.intensity, "fp32_fused_bytes": fp32.bytes_hbm,
            "unfused_bytes": unfused.bytes_hbm}


def _reserved(dev):
    """Bytes the caching allocator holds on the card once every unused
    cached block is returned."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def run_network(net: network.NetworkSpec, *, res: int = 112, batch: int = 1,
                dtype: str = "fp32", fused=None, device="cuda",
                seed: int = 0, autotune: bool = False,
                tune_cache=None, verify: bool = False) -> dict:
    """Drive one network body, through ``execute_network`` (on the card,
    one CUDA graph of the forward) and through its eager runner
    (``build_network_fn``), time both and hold both against the fp32 plain
    path, run eagerly.  Returns the histogram; the launches the wrappers
    counted in ``execute_network``'s first call (on the card its warm-up
    and its capture, two forwards), in a later call (none on the card: a
    replay runs no wrapper) and in one eager forward; on the card the
    port's kernels one replay ran, counted in a profiler trace; for each
    path its ms per forward, its device time by kernel (card only,
    :func:`profile_calls`, which profiles again a trace that lost records;
    ``profile_retries`` counts those traces by path) and busy share,
    and its forward's own peak memory (bytes allocated above what was
    allocated before it; card only; for the graph path the first call's,
    which captures the graph); the
    card memory the first call reserved and what the graph held until the
    network cache was cleared; the capture time; whether the graph's output
    has the eager runner's bits; the ``pwconv`` launches by variant of an
    eager forward and of a replay, the CTA count and cluster of each
    ``fused_mbconv`` launch, the CTAs of each ``dw_se`` launch's passes and
    the error.  With ``autotune`` the network is first tuned
    (``network.tune_network``, into ``tune_cache``), outside every counted
    and timed call, and the paths run its measured plans; ``tune`` then
    holds the tune's cache hit, plans measured and seconds.  ``traffic``
    holds :func:`modeled_traffic`.  With ``verify`` the plan is first held
    to the static verifier (``analysis.analyze_network``, no trace):
    ``planlint`` holds its summary, and an error raises
    ``analysis.PlanVerificationError`` before anything runs.  Ends by
    clearing the network cache, which releases the graph and its memory
    pool."""
    dev = network.require_device(device)
    cuda = dev.type == "cuda"
    params32 = network.init_network(net, seed=seed, device=dev)
    x = torch.randn((batch, res, res, net.c_in),
                    generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    pol = KernelPolicy(fused=fused,
                       dtype_policy=BF16_STREAM if dtype == "bf16" else NATIVE,
                       autotune=autotune, tune_cache=tune_cache)
    params = (network.cast_network_params(params32, torch.bfloat16)
              if dtype == "bf16" else params32)
    tune = None
    if autotune:
        t0 = time.perf_counter()
        tuned = network.tune_network(net, params, x, policy=pol)
        if cuda:
            torch.cuda.synchronize(dev)
        tune = {"cache_hit": tuned.cache_hit, "n_measured": tuned.n_measured,
                "seconds": time.perf_counter() - t0,
                "cache_path": tuned.cache_path}
    nplan = network.plan_network(net, x.shape, dtype=x.dtype, policy=pol,
                                 device=dev)
    planlint = None
    if verify:
        from repro_torch import analysis
        report = analysis.analyze_network(net, nplan, policy=pol,
                                          trace=False)
        planlint = report.summary() + ("" if report.ok else " -> " + ",".join(
            report.rules(analysis.ERROR)))
        print(f"{net.name}: planlint {planlint}")
        analysis.verify_or_raise(report)
    traffic = modeled_traffic(net, nplan, pol)
    eager = network.build_network_fn(net, nplan, pol)

    def forward():
        return network.execute_network(net, params, x, policy=pol)

    def eager_forward():
        with torch.inference_mode():
            return eager(params, x)

    network.clear_network_cache()
    reserved0 = _reserved(dev) if cuda else None
    (y, graph), first, _, peak = _counted(
        lambda: network.execute_network_graph(net, params, x, policy=pol),
        dev)
    reserved = _reserved(dev) - reserved0 if cuda else None
    _, later, _, _ = _counted(forward, dev)
    y_eager, eager_launches, variants, eager_peak = _counted(eager_forward,
                                                             dev)
    ms = time_ms(forward, dev)
    eager_ms = time_ms(eager_forward, dev)
    retries = {}
    device, eager_device, replayed = {}, {}, None
    if cuda:
        device, replayed, retries["graph"] = profile_calls(forward,
                                                           eager_launches)
        eager_device, _, retries["eager"] = profile_calls(eager_forward,
                                                          eager_launches)

    plain = KernelPolicy(impl="torch", fused=fused)
    with torch.inference_mode():
        ref = network.build_network_fn(
            net, network.plan_network(net, x.shape, policy=plain),
            plain)(params32, x)
    err = rel_err(y, ref)
    ok = bool(torch.isfinite(y.float()).all()) and tuple(y.shape) == \
        nplan.out_shape
    held = _reserved(dev) if cuda else None
    capture_s = graph.capture_s if graph is not None else None
    del graph
    network.clear_network_cache()
    held = held - _reserved(dev) if cuda else None
    fused_ctas = [sg.plan.ctas for p in nplan.plans for sg in p.segments
                  if sg.kind in ("fused2", "fused3")]
    mb_plans = [(sg.plan.ctas, sg.plan.cluster) for p in nplan.plans
                for sg in p.segments if sg.kind == "fusedmb"]
    dw_se_ctas = [sg.plan.ctas for p in nplan.plans for sg in p.segments
                  if sg.kind == "dw_se"]
    busy = sum(device.values())
    eager_busy = sum(eager_device.values())
    return {"histogram": nplan.segment_histogram(), "tune": tune,
            "traffic": traffic, "planlint": planlint,
            "first_call_launches": first, "later_call_launches": later,
            "eager_launches": eager_launches,
            "replay_launches": None if replayed is None else {
                k: replayed.get(k, 0) for k in KERNEL_SEGMENTS},
            "fused_ctas": fused_ctas, "fused_mbconv_ctas_cluster": mb_plans,
            "dw_se_ctas": dw_se_ctas, "pwconv_variants": variants,
            "replay_pwconv_variants": None if replayed is None else {
                v: replayed.get(f"pwconv.{v}", 0) for v in variants},
            "ms": ms, "eager_ms": eager_ms,
            "device_ms": device, "eager_device_ms": eager_device,
            "busy": busy / ms if device else None,
            "eager_busy": eager_busy / eager_ms if eager_device else None,
            "peak_bytes": peak, "eager_peak_bytes": eager_peak,
            "reserved_bytes": reserved, "held_bytes": held,
            "profile_retries": retries,
            "capture_s": capture_s,
            "graph_equals_eager": bool(torch.equal(y, y_eager)),
            "graph_vs_eager_rel_err": rel_err(y, y_eager),
            "rel_err": err,
            "tol": BF16_REL_TOL if dtype == "bf16" else FP32_REL_TOL,
            "out_shape": tuple(y.shape), "out_dtype": str(y.dtype),
            "finite_and_shaped": ok}


def _plain_path(net, params32, x, fused):
    """The fp32 plain path, run eagerly, with fault injection suppressed."""
    plain = KernelPolicy(impl="torch", fused=fused)
    with torch.inference_mode(), faultinject.suppressed():
        return network.build_network_fn(
            net, network.plan_network(net, x.shape, policy=plain),
            plain)(params32, x)


def quarantine_bans(path: str) -> dict:
    """``{problem key: [banned rungs]}`` of the quarantine store at
    ``path`` (empty where there is no file)."""
    q = quarantine.Quarantine.load(path)
    return {k: sorted(q.banned(k)) for k in sorted(q.entries)}


def run_recovery(net: network.NetworkSpec, *, res: int = 112, batch: int = 8,
                 dtype: str = "fp32", fused=None, device="cuda",
                 seed: int = 0, tune_cache=None,
                 numeric_guard: bool = False) -> dict:
    """Drive one network body under ``KernelPolicy(on_failure="degrade")``
    with whatever fault-injection points are armed: two calls of
    ``execute_network_graph``.  The first meets the faults and recovers
    (block by block, eagerly) or, where no point fires, captures its graph;
    the second plans around the quarantine (``tune_cache`` pins the store
    beside it) and captures a new graph, in which a block with ``unfused``
    banned runs its plain version.  Both outputs are held against the fp32
    plain path (run eagerly with injection suppressed), the second graph's
    against its eager runner's bits.  The launch counters are zeroed
    around each call: the second call's must be its warm-up's and its
    capture's, two forwards of the new plan's kernel segments (a block at
    the plain rung launches none; on the CPU nothing launches).  The
    runtime telemetry is reset at the start and after the first call.
    Returns the runtime report and the
    points' fire counts after the first call, the quarantine's bans, and
    the second call's plan, launches, graph ms (CUDA events, median of 10,
    on the card) and errors."""
    dev = network.require_device(device)
    cuda = dev.type == "cuda"
    params32 = network.init_network(net, seed=seed, device=dev)
    x = torch.randn((batch, res, res, net.c_in),
                    generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    pol = KernelPolicy(fused=fused,
                       dtype_policy=BF16_STREAM if dtype == "bf16" else NATIVE,
                       tune_cache=tune_cache, on_failure="degrade",
                       numeric_guard=numeric_guard)
    params = (network.cast_network_params(params32, torch.bfloat16)
              if dtype == "bf16" else params32)
    ref = _plain_path(net, params32, x, fused)
    tol = BF16_REL_TOL if dtype == "bf16" else FP32_REL_TOL
    network.clear_network_cache()
    telemetry.reset_runtime_telemetry()
    fired0 = faultinject.fired_counts()
    t0 = time.perf_counter()
    (y1, graph1), first, _, _ = _counted(
        lambda: network.execute_network_graph(net, params, x, policy=pol),
        dev)
    first_s = time.perf_counter() - t0
    report = telemetry.runtime_report()
    fired = {p: n - fired0.get(p, 0)
             for p, n in faultinject.fired_counts().items()}
    telemetry.reset_runtime_telemetry()
    # the next call: a memo miss (a failing plan is never memoized), a
    # re-plan around the bans and a new capture
    nplan = network.plan_network(net, x.shape, dtype=x.dtype, policy=pol,
                                 device=dev)
    plain = network.plain_blocks(net, nplan, pol, device=dev)
    histogram = dict(collections.Counter(
        seg.kind for p, at_ref in zip(nplan.plans, plain) if not at_ref
        for seg in p.segments))
    want = (expected_launches(histogram) if cuda
            else dict.fromkeys(KERNEL_SEGMENTS, 0))
    t0 = time.perf_counter()
    (y2, graph2), second, _, _ = _counted(
        lambda: network.execute_network_graph(net, params, x, policy=pol),
        dev)
    second_s = time.perf_counter() - t0
    eager = network.build_network_fn(net, nplan, pol, device=dev)
    with torch.inference_mode():
        y_eager, eager_launches, _, _ = _counted(lambda: eager(params, x),
                                                 dev)
    replan = telemetry.runtime_report()

    def forward():
        return network.execute_network(net, params, x, policy=pol)

    ms = time_ms(forward, dev) if cuda else None
    network.clear_network_cache()
    return {
        "first_s": first_s, "first_rel_err": rel_err(y1, ref),
        "first_captured": graph1 is not None, "first_launches": first,
        "report": report, "fired": fired,
        "bans": quarantine_bans(quarantine.quarantine_path(pol)),
        "histogram": histogram, "plain_blocks": sum(plain),
        "second_s": second_s, "second_captured": graph2 is not None,
        "capture_s": graph2.capture_s if graph2 is not None else None,
        "second_launches": second, "eager_launches": eager_launches,
        "want_launches": want, "replan_report": replan,
        "graph_equals_eager": bool(torch.equal(y2, y_eager)),
        "rel_err": rel_err(y2, ref), "tol": tol, "ms": ms,
        "finite_and_shaped": bool(torch.isfinite(y2.float()).all())
        and tuple(y2.shape) == nplan.out_shape}


def recovery_ok(r: dict, cuda: bool) -> bool:
    """Whether a :func:`run_recovery` run recovered within tolerance with
    every fallback injected, and its second call captured the new plan
    (on the card: two forwards launched, one per eager call) and gave the
    eager runner's bits."""
    rep = r["report"]
    twice = {k: (2 if cuda else 1) * n for k, n in r["want_launches"].items()}
    return (r["first_rel_err"] <= r["tol"] and r["rel_err"] <= r["tol"]
            and r["finite_and_shaped"] and r["graph_equals_eager"]
            and rep["fallbacks"] == rep["injected_fallbacks"]
            == sum(r["fired"].values())
            and all(e["injected"] for e in rep["events"]
                    if e["event"] == "fallback")
            and r["replan_report"]["fallbacks"] == 0
            and r["second_captured"] == cuda
            and r["second_launches"] == twice
            and r["eager_launches"] == r["want_launches"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=(*ARCHS, "all"), default="all")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    ap.add_argument("--res", type=int, default=112,
                    help="body input resolution (112 = a 224 image after "
                         "the stem)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unfused", action="store_true",
                    help="plan with KernelPolicy(fused=False)")
    ap.add_argument("--autotune", action="store_true",
                    help="run the measured plans (tuned on a cache miss)")
    ap.add_argument("--tune-cache", metavar="PATH",
                    help="the tune cache (default: "
                         "kernels/autotune.default_cache_path()); the "
                         "quarantine store lives beside it")
    ap.add_argument("--verify", action="store_true",
                    help="hold each network's plan to the static verifier "
                         "(repro_torch.analysis) before running it; raises "
                         "on an error")
    ap.add_argument("--fault-inject", metavar="POINTS",
                    help="arm fault-injection points (comma-separated "
                         "point[:times], persistent without times) and run "
                         "under KernelPolicy(on_failure='degrade') for this "
                         "run (the port's default raises), with a quarantine "
                         "of its own (beside --tune-cache, else temporary); "
                         "prints the runtime report and the points' fire "
                         "counts")
    ap.add_argument("--numeric-guard", action="store_true",
                    help="with --fault-inject: check every output is finite")
    args = ap.parse_args(argv)
    if args.tune_cache and not (args.autotune or args.fault_inject):
        ap.error("--tune-cache needs --autotune or --fault-inject")
    if args.fault_inject and args.autotune:
        ap.error("--fault-inject runs the analytic plans; drop --autotune")
    if args.numeric_guard and not args.fault_inject:
        ap.error("--numeric-guard needs --fault-inject")
    if args.verify and args.fault_inject:
        ap.error("--verify holds the analytic run's plans; drop "
                 "--fault-inject")
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    nets = [spec() for name, spec in ARCHS.items()
            if args.arch in (name, "all")]
    if args.fault_inject:
        return _main_faulted(args, nets)
    failed = False
    for net in nets:
        r = run_network(net, res=args.res, batch=args.batch,
                        dtype=args.dtype,
                        fused=False if args.unfused else None,
                        device=args.device, autotune=args.autotune,
                        tune_cache=args.tune_cache, verify=args.verify)
        histo = ",".join(f"{k}:{v}" for k, v in sorted(r["histogram"].items()))
        cuda = torch.device(args.device).type == "cuda"
        if r["tune"] is not None:
            t = r["tune"]
            print(f"{net.name}: autotune cache "
                  f"{'hit' if t['cache_hit'] else 'miss'}, "
                  f"{t['n_measured']} plans measured in {t['seconds']:.1f} s "
                  f"(cache {t['cache_path']})")
        print(f"{net.name} @{args.res}x{args.res} batch {args.batch} "
              f"{args.dtype} on {args.device}: plan {histo}; launches of an "
              f"eager forward {r['eager_launches']}")
        t = r["traffic"]
        print(f"  modeled HBM: {t['bytes'] / 1e6:.2f} MB (fp32 fused "
              f"{t['fp32_fused_bytes'] / 1e6:.2f} MB, per-block unfused "
              f"{t['unfused_bytes'] / 1e6:.2f} MB); AI {t['intensity']:.1f} "
              "FLOPs/B")
        if cuda:
            print(f"  port kernels a replay ran (profiler trace): "
                  f"{r['replay_launches']}")
        paths = ((("graph", ""), ("eager", "eager_")) if cuda
                 else (("eager", ""),))
        for name, pre in paths:
            peak = ("" if r[pre + "peak_bytes"] is None else
                    f", own peak {r[pre + 'peak_bytes'] / 2**20:.1f} MiB")
            print(f"  {name}: {r[pre + 'ms']:.3f} ms/forward ("
                  f"{'CUDA events' if cuda else 'host clock'}, median of "
                  f"10){peak}")
            if r[pre + "device_ms"]:
                busy = sum(r[pre + "device_ms"].values())
                print(f"    device time {busy:.3f} ms/forward "
                      f"({r[pre + 'busy']:.0%} busy): " + ", ".join(
                          f"{k} {v:.3f} ms" for k, v in
                          sorted(r[pre + "device_ms"].items())))
        if cuda:
            print(f"  graph captured in {r['capture_s'] * 1e3:.1f} ms; "
                  f"the first call reserved "
                  f"{r['reserved_bytes'] / 2**20:.1f} MiB, the graph held "
                  f"{r['held_bytes'] / 2**20:.1f} MiB until the cache was "
                  f"cleared; graph output equals the eager runner's: "
                  f"{r['graph_equals_eager']}")
        print(f"  out {r['out_shape']} {r['out_dtype']}")
        print(f"  vs fp32 plain path: max rel err {r['rel_err']:.2e} "
              f"(tol {r['tol']:g})")
        if cuda:
            counts_ok = (r["replay_launches"] == r["eager_launches"]
                         and not any(r["later_call_launches"].values()))
        else:
            counts_ok = r["first_call_launches"] == r["eager_launches"]
        failed |= not (r["rel_err"] <= r["tol"] and r["finite_and_shaped"]
                       and r["graph_equals_eager"] and counts_ok)
    return 1 if failed else 0


def _main_faulted(args, nets) -> int:
    with contextlib.ExitStack() as stack:
        tune_cache = args.tune_cache
        if tune_cache is None:
            # the run's own store: injected bans must not reach the default
            # quarantine, which every real degrade run reads
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            tune_cache = os.path.join(stack.enter_context(
                tempfile.TemporaryDirectory(prefix="fault_inject_",
                                            dir=_build.BUILD_DIR)),
                "autotune.json")
        try:
            return _run_faulted(args, nets, tune_cache)
        finally:
            faultinject.disarm_all()


def _run_faulted(args, nets, tune_cache) -> int:
    points = faultinject.arm_from_spec(args.fault_inject)
    print(f"fault injection armed: {', '.join(points)}; on_failure='degrade'"
          " for this run, quarantine "
          f"{quarantine.quarantine_path(KernelPolicy(tune_cache=tune_cache))}"
          + ("" if args.tune_cache else " (removed at exit)"))
    cuda = torch.device(args.device).type == "cuda"
    failed = False
    for net in nets:
        r = run_recovery(net, res=args.res, batch=args.batch,
                         dtype=args.dtype,
                         fused=False if args.unfused else None,
                         device=args.device, tune_cache=tune_cache,
                         numeric_guard=args.numeric_guard)
        rep = r["report"]
        histo = ",".join(f"{k}:{v}" for k, v in sorted(r["histogram"].items()))
        print(f"{net.name} @{args.res}x{args.res} batch {args.batch} "
              f"{args.dtype} on {args.device}: first call {r['first_s']:.3f}"
              f" s, {rep['fallbacks']} fallbacks ({rep['injected_fallbacks']}"
              f" injected), {rep['recoveries']} recoveries, rel err "
              f"{r['first_rel_err']:.2e}; fired {r['fired']}")
        print(f"  quarantine: {sum(len(b) for b in r['bans'].values())} bans "
              f"over {len(r['bans'])} problems")
        print(f"  next call: plan {histo} with {r['plain_blocks']} blocks at "
              f"the plain rung, launches {r['second_launches']}, graph "
              f"equals eager {r['graph_equals_eager']}, rel err "
              f"{r['rel_err']:.2e} (tol {r['tol']:g})"
              + (f", {r['ms']:.3f} ms/forward" if r["ms"] is not None
                 else ""))
        for when, rep in (("first call", r["report"]),
                          ("next call", r["replan_report"])):
            print(f"  runtime report, {when}: " + json.dumps(
                {k: v for k, v in rep.items() if k != "events"}))
        failed |= not recovery_ok(r, cuda)
    print(f"fired: {faultinject.fired_counts()}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
