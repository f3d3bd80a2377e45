"""Time the ``pwconv`` kernel of one checkout at the xLSTM-125M and CNN
shapes of the main paths, on the card.

    python3 src/repro_torch/bench_pwconv.py [--src DIR] [--reps N]
        [--tp | --tune | --widths]

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

``--tp`` instead times qwen3-1.7b's Linears at their local widths under
tensor parallelism of 2 (:data:`TP_SHAPES`: the column-parallel q and the
MLP's gate/up, the row-parallel o and down with their fp32 partial-sum
store), bf16, at G = 8 (decode), 2048 (a training rank's 8 x 256 tokens)
and 4096 (prefill): the kernel's,
the plain version's and one library call's (``torch.mm``, bf16 out) CUDA-
graph ms, beside the bound: the larger of the bytes moved (x and w read
once, the output written once) at 3.35 TB/s and the products at the bf16
tensor-core peak of 989 TFLOP/s.

``--widths`` prints, without a card, every Linear's local (Ci, Co) of
qwen3-1.7b, qwen3-moe-235b-a22b and smollm-360m at tensor parallelism 2
and 4 (the sharding rules' blocks, at full width) and the ``pwconv``
variant each takes at G = 8 and G = 4096 in bf16 and fp32
(``blocking.pw_variant``).

``--tune`` instead sweeps what ``blocking.plan_pwconv`` decides for this
checkout, CUDA-graph timed: the ``stream`` variant's Co slice and split-K
cluster at the decode shapes (L2 warm and cold; the ``stream`` plans of
``blocking.pwconv_ladder``, which the autotuner draws from), and ``stream`` forced
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

#: (Ci, Co, store dtype) of qwen3-1.7b's Linears at tp 2: q 2048 -> 1024
#: and gate/up 2048 -> 3072 column-parallel; o 1024 -> 2048 and down
#: 3072 -> 2048 row-parallel, stored in fp32 for the sum over ranks.
TP_SHAPES = ((2048, 1024, "bfloat16"), (2048, 3072, "bfloat16"),
             (1024, 2048, "float32"), (3072, 2048, "float32"))
TP_G = (8, 2048, 4096)
HBM_BYTES_PER_S = 3.35e12
BF16_PEAK = 989e12

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
            for q in blocking.pwconv_ladder(g, ci, co, dtype=dtype):
                if q.variant != "stream":
                    continue
                kw = dict(variant="stream", block_g=q.block_g,
                          block_co=q.block_co, block_ci=q.block_c)
                turn = iter(range(10 ** 9))
                print(json.dumps({
                    "card": card, "tune": "stream",
                    "dtype": str(dtype).replace("torch.", ""),
                    "shape": [g, ci, co], "block_co": q.block_co,
                    "cluster": q.cluster, "planned": q == plan,
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


def tp(torch, pwconv, card, rand, reps: int) -> None:
    from repro_torch.kernels import blocking
    for ci, co, store in TP_SHAPES:
        odt = getattr(torch, store)
        for g in TP_G:
            x = rand((g, ci), torch.bfloat16)
            w = rand((ci, co), torch.bfloat16, ci ** -0.5)
            got = pwconv.pwconv(x, w, out_dtype=odt)
            want = pwconv.pwconv_plain(x, w, out_dtype=odt)
            moved = (x.numel() + w.numel()) * 2 + g * co * got.element_size()
            print(json.dumps({
                "card": card, "tp": 2, "shape": [g, ci, co],
                "dtype": "bfloat16", "store": store,
                "variant": blocking.pw_variant(g, ci, co, torch.bfloat16),
                "ms": _graph_ms(torch, lambda: pwconv.pwconv(
                    x, w, out_dtype=odt), reps),
                "plain_ms": _graph_ms(torch, lambda: pwconv.pwconv_plain(
                    x, w, out_dtype=odt), reps),
                "library_ms": _graph_ms(torch, lambda: torch.mm(x, w), reps),
                "bound_ms": max(moved / HBM_BYTES_PER_S,
                                2 * g * ci * co / BF16_PEAK) * 1e3,
                "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                             > 2 * g * ci * co / BF16_PEAK else "operations"),
                "max_rel_err": float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max())}),
                flush=True)


def widths() -> None:
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import blocking
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import build_model
    for arch in ("qwen3-1.7b", "qwen3-moe-235b-a22b", "smollm-360m"):
        for tp in (2, 4):
            rules = make_rules(Mesh(("data", "model"), (1, tp)),
                               mode="serve", multi_pod=False)
            model = build_model(get_config(arch), torch.Generator(), "meta",
                                rules)
            seen = {}
            for name, p in model.named_parameters():
                if not name.startswith("blocks.") or not name.endswith(".w"):
                    continue
                key = name.split(".", 2)[2][:-2]
                if p.dim() != 2 or key in seen or "router" in key:
                    continue
                seen[key] = list(p.shape)
                print(json.dumps({
                    "arch": arch, "tp": tp, "linear": key,
                    "local": list(p.shape), **{
                        f"G={g} {dt}": blocking.pw_variant(
                            g, *p.shape, getattr(torch, dt))
                        for g in (8, 4096)
                        for dt in ("bfloat16", "float32")}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tune", action="store_true",
                    help="sweep the stream tile and the variant threshold")
    ap.add_argument("--tp", action="store_true",
                    help="qwen3-1.7b's Linears at their tp-2 local widths")
    ap.add_argument("--widths", action="store_true",
                    help="local widths and variants at tp 2 and 4 (no card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    if args.widths:
        widths()
        return 0
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
    if args.tp:
        tp(torch, pwconv, card, rand, args.reps)
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
