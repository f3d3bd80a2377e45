"""Measurement helpers shared by the port's entry points and
``chip_smoke.py``: relative error, CUDA-event timing and the device time
by kernel from ``torch.profiler``."""
from __future__ import annotations

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
             reps: int = 5) -> float:
    """Median ms per call of ``fn()`` replayed from a CUDA graph that
    captured ``launches`` calls, CUDA events around each replay: the
    device's pace for a microsecond kernel, without the host's launch
    overhead between calls."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
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


#: Device kernel name fragment -> the port's kernel it belongs to.
_KERNEL_NAMES = {"dw2d_kernel": "dwconv2d", "pw_stream_kernel": "pwconv",
                 "pw_tc_kernel": "pwconv", "pw_simt_kernel": "pwconv",
                 "fused_mb_kernel": "fused_mbconv",
                 "fused_kernel": "separable_fused", "dw_se_kernel": "dw_se",
                 "dw1d_kernel": "dwconv1d"}


def device_breakdown(fn, reps: int = 5, warmup: bool = True) -> dict:
    """Device time of ``fn()`` by kernel, from ``torch.profiler``: ms per
    call for each of the port's kernels and for every other device kernel
    (PyTorch's pads, casts and adds) together.  Empty when the profiler
    records no device time.  ``warmup=False`` skips the unprofiled first
    call (for a function that has just run)."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = next((v for k, v in _KERNEL_NAMES.items() if k in e.key),
                    "other")
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out
