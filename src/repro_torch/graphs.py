"""Whole calls captured as CUDA graphs, and the kernels' launch counters.

The reference never runs a network body, a prefill, a decode step or a
train step op by op from the host: it ``jax.jit``s each and replays the
compiled program (``repro/core/network.py:527-635``,
``repro/launch/serve.py:54,62``, ``repro/launch/train.py:108``).  The
port's counterpart is a CUDA graph of the call, captured once per shape and
replayed (``execute_network``'s memo, ``serve_step.capture_prefill`` and
``capture_decode_step``, ``train_step.capture_train_step``):

* :func:`capture` warms ``fn`` up on a side stream (which builds the
  kernels and raises their shared-memory limits outside the capture),
  captures it into the graph's own memory pool and replays it once;
* :class:`Captured` holds the graph and the tensors it writes.

The kernel wrappers count their launches in plain integers (``launches``
in ``kernels/{dwconv2d,pwconv,separable_fused,fused_mbconv,se_epilogue,
dwconv1d}.py``; ``dwconv1d``'s backward also ``bwd_launches``), where
they call the launch; the sharded layers'
collectives count theirs the same way (``sharding/collectives.py``:
``all_reduce``, ``all_gather``, ``all_to_all``).  The warm-up and the capture
each run the wrappers once, so each moves the counters by one call; a
replay runs no wrapper and moves none.  What a replay ran on the device is
counted in a profiler trace instead (``measure.device_profile``).
:func:`snapshot`, :func:`reset` and :func:`delta` are the one registry of
the counters.

A capture or a replay that fails raises; nothing runs the eager function in
its place.  :func:`record` ends a capture that ``fn`` failed in, so that the
stream can capture again, and lets ``fn``'s own exception (a kernel's launch
error, say) propagate rather than the capture's "invalidated" error.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import (blocking, dwconv1d, dwconv2d, fused_mbconv,
                                 pwconv, se_epilogue, separable_fused)
from repro_torch.sharding import collectives

#: Counter name -> (wrapper module, attribute, key of a dict attribute or
#: None).  ``pwconv.<variant>`` are ``pwconv``'s launches by variant.
_COUNTERS = {
    "dwconv2d": (dwconv2d, "launches", None),
    "pwconv": (pwconv, "launches", None),
    **{f"pwconv.{v}": (pwconv, "launches_by_variant", v)
       for v in blocking.PW_VARIANTS},
    "separable_fused2": (separable_fused, "launches", "fused2"),
    "separable_fused3": (separable_fused, "launches", "fused3"),
    "fused_mbconv": (fused_mbconv, "launches", None),
    "dw_se": (se_epilogue, "launches", None),
    "dwconv1d": (dwconv1d, "launches", None),
    "dwconv1d_bwd": (dwconv1d, "bwd_launches", None),
    **{name: (collectives, "launches", name)
       for name in collectives.launches},
}


def _get(name: str) -> int:
    mod, attr, key = _COUNTERS[name]
    value = getattr(mod, attr)
    return value if key is None else value[key]


def _set(name: str, value: int) -> None:
    mod, attr, key = _COUNTERS[name]
    if key is None:
        setattr(mod, attr, value)
    else:
        getattr(mod, attr)[key] = value


def snapshot() -> dict:
    """Every launch counter, by name."""
    return {name: _get(name) for name in _COUNTERS}


def restore(counts: dict) -> None:
    """Set the named counters to ``counts``."""
    for name, value in counts.items():
        _set(name, value)


def reset() -> None:
    """Set every launch counter to 0."""
    restore(dict.fromkeys(_COUNTERS, 0))


def delta(before: dict, after: dict) -> dict:
    """The launches made between two snapshots."""
    return {name: after[name] - before[name] for name in before}


def copy_tree_(dst, src):
    """Copy every tensor of ``src`` into the same place of ``dst`` (dicts and
    lists of tensors, the same keys and lengths: a captured call's static
    buffers, a cache or a train state), in place; a tensor the two share
    is already there.  Returns ``dst``."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"keys differ: {sorted(dst)} vs {sorted(src)}")
        for k in dst:
            copy_tree_(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src, strict=True):
            copy_tree_(d, s)
    elif dst is not src:
        dst.copy_(src)
    return dst


def record(graph: torch.cuda.CUDAGraph, fn: Callable[[], Any],
           device: torch.device) -> Any:
    """``fn()`` captured into ``graph`` (``torch.cuda.graph``); returns what
    ``fn`` returned.  Where ``fn`` raises during the capture, the capture is
    ended (the error that ending it gives, that the capture was
    invalidated, becomes a note), the current stream is restored, and
    ``fn``'s exception propagates as it was raised."""
    prev = torch.cuda.current_stream(device)
    ctx = torch.cuda.graph(graph)
    ctx.__enter__()
    try:
        out = fn()
    except BaseException as err:
        try:
            ctx.__exit__(type(err), err, err.__traceback__)
        except Exception as end:
            err.add_note(f"the CUDA graph capture was abandoned: {end}")
            # the capture's stream context was not left: leave it here
            torch.cuda.set_stream(prev)
        raise
    ctx.__exit__(None, None, None)
    return out


@dataclasses.dataclass
class Captured:
    """A captured call: ``output`` is what the call returned while it was
    captured (tensors in the graph's pool, rewritten by every replay),
    ``launches`` the launches the wrappers made while the graph recorded
    them (the port's kernel nodes of the graph, by counter), ``capture_s``
    the seconds the capture and the graph's instantiation took."""
    graph: torch.cuda.CUDAGraph
    output: Any
    launches: dict
    capture_s: float

    def replay(self) -> Any:
        """Replay the graph on the current stream; returns :attr:`output`."""
        self.graph.replay()
        return self.output


def capture(fn: Callable[[], Any],
            device: Optional[torch.device] = None, *,
            generators: tuple = ()) -> Captured:
    """Capture ``fn()``, a call on tensors whose addresses stay fixed, as a
    CUDA graph in a private memory pool, then replay it once.  The warm-up
    and the capture each move the launch counters by one call.  Each of
    ``generators`` (CUDA generators that ``fn`` draws from) is registered
    with the graph, so that a replay draws from its seed and offset at the
    time of the replay, as an eager call would.  Raises on
    a device that is not a CUDA device, and when the capture or the replay
    fails (a failure of ``fn`` during the capture as ``fn`` raised it:
    :func:`record`)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph is captured on the card, not on "
                         f"{dev}")
    # warm up on a side stream: builds the kernels, sets their shared-memory
    # limits and lets PyTorch's libraries set up their workspaces before
    # the capture begins
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = snapshot()
    t0 = time.perf_counter()
    output = record(graph, fn, dev)
    capture_s = time.perf_counter() - t0
    recorded = {k: n for k, n in delta(before, snapshot()).items() if n}
    captured = Captured(graph, output, recorded, capture_s)
    captured.replay()
    return captured
