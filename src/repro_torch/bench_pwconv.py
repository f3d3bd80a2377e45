"""Time the ``pwconv`` kernel of one checkout at the xLSTM-125M and CNN
shapes of the main paths, on the card.

    python3 src/repro_torch/bench_pwconv.py [--src DIR] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default the one beside this file), so that one session on the card can time
two checkouts in turn, for example a parent commit unpacked under
``build/parent`` against this one, in the order parent, change, change,
parent:

    for s in build/parent/src src src build/parent/src; do
        python3 src/repro_torch/bench_pwconv.py --src $s; done

Each checkout builds its own kernels into its own ``build/`` directory.  The
script prints one JSON line per shape and dtype: the card's name and power
limit, the source directory, the variant that served the call (where the
checkout counts them), and the kernel's ms with L2 warm and, for G <= 16,
L2 cold (a run rotating over copies of w that together exceed the 50 MB
L2, as a decode step streams its weights; a cold graph captures one pass
over the copies):

* ``ms``: a CUDA graph of ``--reps`` launches replayed between CUDA
  events, per launch: the device's pace, no host launch overhead;
* ``events_ms``: CUDA events around a run of ``--reps`` eager launches,
  per launch (host-paced where the host is slower than the kernel);

and its largest error relative to the plain version.

``--tune`` instead sweeps what ``blocking.plan_pwconv`` decides for this
checkout, CUDA-graph timed: the ``stream`` variant's Co slice and split-K
cluster at the decode shapes (L2 warm and cold), and ``stream`` forced
against the wide variant (``simt`` in fp32, ``tc`` in bf16) at G from 8 to
96, which set ``blocking.PW_STREAM_MAX_G``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (G, Ci, Co, activation): xLSTM-125M's Linears at prefill (G = 8 x 512)
#: and decode (G = batch 1 and 8), then the CNN bodies' extremes at 112x112
#: (V1 block 1 and V2's 56x56 stage at batch 8, a 14x14 stage at batch 8,
#: V1 block 13 at batch 1).
SHAPES = ((4096, 768, 3072, None), (4096, 1536, 1536, None),
          (4096, 768, 1024, "silu"), (4096, 1536, 8, None),
          (8, 768, 3072, None), (8, 1536, 1536, None), (8, 1536, 8, None),
          (1, 768, 3072, None), (1, 1024, 768, None),
          (100352, 32, 64, "relu6"), (25088, 128, 256, "relu6"),
          (1568, 512, 512, "relu6"), (49, 1024, 1024, "relu6"))

#: Bytes the copies of w rotated over for a cold-L2 time add up to at least.
COLD_BYTES = 64 * 2 ** 20


def _run_ms(torch, fn, reps: int) -> float:
    """CUDA events around ``reps`` calls, ms per call, median of 5 runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def _graph_ms(torch, fn, reps: int) -> float:
    """A CUDA graph of ``reps`` calls replayed between CUDA events, ms per
    call, median of 5 replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


#: (G, Ci, Co) of the stream sweep: xLSTM-125M's decode Linears.
TUNE_STREAM = ((1, 768, 3072), (8, 768, 3072), (8, 1536, 1536),
               (8, 1536, 768), (8, 768, 1024), (8, 1024, 768),
               (8, 1536, 8))
#: (Ci, Co) and G of the threshold sweep.
TUNE_WIDE = ((768, 3072), (1536, 1536), (1024, 1024), (512, 512))
TUNE_G = (8, 16, 24, 32, 49, 64, 96)


def tune(torch, pwconv, card, rand) -> None:
    from repro_torch.kernels import blocking
    for dtype in (torch.float32, torch.bfloat16):
        for g, ci, co in TUNE_STREAM:
            x, w = rand((g, ci), dtype), rand((ci, co), dtype, ci ** -0.5)
            n = max(6, -(-COLD_BYTES // (w.numel() * w.element_size())))
            copies = [w] + [w.clone() for _ in range(n - 1)]
            plan = blocking.plan_pwconv(g, ci, co, dtype=dtype)
            vec = blocking.pw_vector(co, dtype)
            for bco in (32, 64, 128, 256):
                for cluster in (1, 2, 4, 8):
                    bci = -(-ci // cluster)
                    if blocking.pwconv_tile_error(
                            "stream", plan.block_g, bco, bci, ci=ci,
                            vector=vec):
                        continue
                    kw = dict(variant="stream", block_co=bco, block_ci=bci)
                    turn = iter(range(10 ** 9))
                    print(json.dumps({
                        "card": card, "tune": "stream",
                        "dtype": str(dtype).replace("torch.", ""),
                        "shape": [g, ci, co], "block_co": bco,
                        "cluster": cluster,
                        "planned": [plan.block_co, plan.cluster] == [
                            bco, cluster],
                        "ms": _graph_ms(
                            torch, lambda: pwconv.pwconv(x, w, **kw), 20),
                        "cold_ms": _graph_ms(torch, lambda: pwconv.pwconv(
                            x, copies[next(turn) % n], **kw), n)}),
                        flush=True)
            del copies
        for ci, co in TUNE_WIDE:
            wide = blocking.pw_variant(10 ** 6, ci, co, dtype)
            for g in TUNE_G:
                x, w = rand((g, ci), dtype), rand((ci, co), dtype)
                print(json.dumps({
                    "card": card, "tune": "threshold",
                    "dtype": str(dtype).replace("torch.", ""),
                    "shape": [g, ci, co], "wide": wide,
                    "stream_ms": _graph_ms(torch, lambda: pwconv.pwconv(
                        x, w, variant="stream"), 20),
                    "wide_ms": _graph_ms(torch, lambda: pwconv.pwconv(
                        x, w, variant=wide), 20)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tune", action="store_true",
                    help="sweep the stream tile and the variant threshold")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.kernels import pwconv
    if not torch.cuda.is_available():
        print("bench_pwconv: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    by_variant = getattr(pwconv, "launches_by_variant", None)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    if args.tune:
        tune(torch, pwconv, card, rand)
        return 0

    for dtype in (torch.float32, torch.bfloat16):
        for g, ci, co, act in SHAPES:
            x = rand((g, ci), dtype)
            w = rand((ci, co), dtype, ci ** -0.5)
            b = rand((co,), dtype, 0.1)

            def kernel(w=w):
                return pwconv.pwconv(x, w, b, activation=act)

            before = dict(by_variant) if by_variant is not None else None
            got = kernel()
            torch.cuda.synchronize(dev)
            variant = None
            if before is not None:
                variant = next(k for k in by_variant
                               if by_variant[k] != before[k])
            want = pwconv.pwconv_plain(x, w, b, activation=act)
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            r = {"card": card, "src": args.src,
                 "shape": f"G={g} {ci}->{co} {act or 'no act'}",
                 "dtype": str(dtype).replace("torch.", ""),
                 "variant": variant, "ms": _graph_ms(torch, kernel, args.reps),
                 "events_ms": _run_ms(torch, kernel, args.reps),
                 "max_rel_err": err}
            if g <= 16:
                n = max(6, -(-COLD_BYTES // (w.numel() * w.element_size())))
                copies = [w] + [w.clone() for _ in range(n - 1)]
                turn = iter(range(10 ** 9))

                def cold():
                    return kernel(copies[next(turn) % n])

                r["cold_ms"] = _graph_ms(torch, cold, n)
                r["cold_events_ms"] = _run_ms(torch, cold, n)
                del copies
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
