"""Measurement helpers shared by the port's entry points and
``chip_smoke.py``: relative error, CUDA-event timing, and the device time
and the kernel instances by kernel from ``torch.profiler``."""
from __future__ import annotations

import re
import statistics
import time

import torch


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in fp32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def time_ms(fn, device: torch.device, reps: int = 10,
            warmup: int = 2, launches: int = 1) -> float:
    """Median ms of ``fn()``: CUDA events around each run of ``launches``
    calls on the card (a run of many amortises the event overhead over a
    microsecond kernel), the host clock on the CPU; ms per call."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / launches)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / launches)
    return statistics.median(times)


def graph_ms(fn, device: torch.device, launches: int = 20,
             reps: int = 5, warmup: int = 1) -> float:
    """Median ms per call of ``fn()`` replayed from a CUDA graph that
    captured ``launches`` calls, CUDA events around each of ``reps``
    replays after ``warmup`` untimed ones: the device's pace for a
    microsecond kernel, without the host's launch overhead between calls.
    The graph and its memory pool are released before it returns.  A
    failure of ``fn`` during the capture propagates as ``fn`` raised it
    (``graphs.record``)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    from repro_torch.graphs import record  # graphs imports the kernels
    record(graph, lambda: [fn() for _ in range(launches)], device)
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


#: NCCL's device kernels (``ncclDevKernel_<Coll>_...``, NCCL 2.19 and
#: later) -> the collective counters (``sharding/collectives.py``) one of
#: them stands for: ``all_to_all_single`` runs as grouped sends and
#: receives.
_NCCL_KERNELS = {"ncclDevKernel_AllReduce": ("all_reduce",),
                 "ncclDevKernel_AllGather": ("all_gather",),
                 "ncclDevKernel_ReduceScatter": ("reduce_scatter",),
                 "ncclDevKernel_SendRecv": ("all_to_all",)}

#: Device kernel name fragment -> the port's kernel it belongs to.
_KERNEL_NAMES = {"dw2d_kernel": "dwconv2d", "pw_stream_kernel": "pwconv",
                 "pw_tc_kernel": "pwconv", "pw_simt_kernel": "pwconv",
                 "fused_mb_kernel": "fused_mbconv",
                 "sep_fused_kernel": "separable_fused", "dw_se_": "dw_se",
                 "dw1d_kernel": "dwconv1d",
                 "dw1d_bwd_kernel": "dwconv1d_bwd",
                 "dw1d_df_reduce_kernel": "dwconv1d_bwd_reduce",
                 **{k: v[0] for k, v in _NCCL_KERNELS.items()}}

#: Device kernel name fragment -> the launch counters (``repro_torch.graphs``
#: names) that one instance of it stands for: one kernel per wrapper launch,
#: ``dw_se``'s counted by its second pass.
_KERNEL_COUNTERS = {"dw2d_kernel": ("dwconv2d",),
                    "pw_stream_kernel": ("pwconv", "pwconv.stream"),
                    "pw_tc_kernel": ("pwconv", "pwconv.tc"),
                    "pw_simt_kernel": ("pwconv", "pwconv.simt"),
                    "fused_mb_kernel": ("fused_mbconv",),
                    "dw_se_scale_kernel": ("dw_se",),
                    "dw1d_kernel": ("dwconv1d",),
                    "dw1d_bwd_kernel": ("dwconv1d_bwd",),
                    "dw1d_df_reduce_kernel": ("dwconv1d_bwd_reduce",),
                    **_NCCL_KERNELS}

#: ``sep_fused_kernel<T, EXPAND, KT>``'s EXPAND, demangled or mangled.
_SEP_EXPAND = re.compile(r"sep_fused_kernel(?:<[^,>]+,\s*(true|false)"
                         r"|I\w+?Lb([01])E)")


def _counters_of(kernel: str) -> tuple:
    """The launch counters one instance of the device kernel named
    ``kernel`` stands for; ``()`` for a kernel that is not the port's."""
    if "sep_fused_kernel" in kernel:
        m = _SEP_EXPAND.search(kernel)
        if m is None:
            raise ValueError(f"cannot tell the stage count of {kernel!r}")
        return (("separable_fused3",) if (m.group(1) or m.group(2))
                in ("true", "1") else ("separable_fused2",))
    return next((v for k, v in _KERNEL_COUNTERS.items() if k in kernel), ())


#: Host seconds the profiler's window is held open before the first
#: profiled call and after the last one completes.
_MARGIN_S = 0.02


def device_profile(fn, reps: int = 5, warmup: bool = True):
    """``fn()`` run ``reps`` times under ``torch.profiler``: (device ms per
    call for each of the port's kernels and for every other device kernel,
    PyTorch's pads, casts and adds, together as "other"; the port's kernel
    instances per call that ran on the device, by launch counter name, and
    under ``"device_events"`` every device kernel, copy and fill per call).
    The instances are counted in the trace, so they count the kernels of a
    replayed CUDA graph, which no wrapper's counter sees.  Both are empty
    when the profiler records no device time.  One unprofiled call runs
    first unless ``warmup`` is false (a call that has already run at its
    shapes)."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # margins on the host clock around the calls: the profiler drops
        # device records it places outside its window, and it places them
        # by a conversion of the device's clock to the host's
        time.sleep(_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(_MARGIN_S)
    ms: dict = {}
    counts: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        counts["device_events"] = counts.get("device_events", 0) + e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = next((v for k, v in _KERNEL_NAMES.items() if k in e.key),
                    "other")
        ms[name] = ms.get(name, 0.0) + us / 1e3 / reps
        for c in _counters_of(e.key):
            counts[c] = counts.get(c, 0) + e.count
    return ms, {c: n // reps if n % reps == 0 else n / reps
                for c, n in counts.items()}


def profile_calls(fn, expect: dict, reps: int = 5, tries: int = 5):
    """:func:`device_profile` of ``fn()``, held to ``expect``, the port's
    kernels one call should run, by launch counter.  A trace that holds
    fewer of them (none at all, or part of a replay's) has lost records,
    as the profiler on the card now and then does, and is taken again, up
    to ``tries`` traces in all; a trace with more than ``expect`` is never
    short of records and is returned as it is, as is the last trace.
    Returns (ms by kernel, kernel instances per call by counter, the
    traces taken before it)."""
    for retries in range(tries):
        ms, ran = device_profile(fn, reps)
        if not any(ran.get(k, 0) < n for k, n in expect.items()) or any(
                ran.get(k, 0) > n for k, n in expect.items()):
            break
    return ms, ran, retries
