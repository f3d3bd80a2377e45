"""Time the ``separable_fused`` kernel of one checkout at the main path's
fused blocks (MobileNet V1's 2-stage blocks, V2's and EfficientNet-Lite0's
3x3 and 5x5 inverted residuals), on the card.

    python3 src/repro_torch/bench_separable_fused.py [--src DIR] [--reps N]
    python3 src/repro_torch/bench_separable_fused.py --tune [--batch B]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default the one beside this file), so that one session on the card can time
two checkouts in turn, for example a parent commit unpacked under
``build/parent`` against this one, in the order parent, change, change,
parent:

    for s in build/parent/src src src build/parent/src; do
        python3 src/repro_torch/bench_separable_fused.py --src $s; done

Each checkout builds its own kernels into its own ``build/`` directory.  A
checkout whose wrapper takes ``pad`` gets the unpadded input and pads as it
reads, as the main path calls it; an older one gets the input padded first.
The script prints one JSON line per shape and dtype: the card's name and
power limit, the source directory, the kernel's ms replayed from a CUDA
graph of 20 launches (median of ``--reps`` replays, L2 warm) and from CUDA
events around one eager launch, the same two times of the library
composition of the same function (matmul, depthwise ``F.conv2d`` + bias,
relu6, matmul + bias, activation, residual add), and the kernel's largest
error relative to the plain version.

``--tune`` times, for every fused block of the four CNN bodies at 112x112
(batch 1 and 8, or ``--batch``), fp32 and bf16, every plan of the
planner's own search (``blocking.separable_fused_ladder``: each slab
height, cluster and Co panel, each with the largest chunk that fits; the
ladder the autotuner draws its candidates from), graph-timed, one JSON
line per block: the planner's ms and its plan, and every candidate's,
fastest first.  A candidate that fails to launch raises.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

#: (batch, h, w, ci, c, co, stride, residual, k): Lite0 blocks 8, 9, 11,
#: 12 (the 5x5 fused3 blocks) and 12 at batch 1; V2 blocks 2, 13 and 14;
#: V1 blocks 2, 5 and 12 (fused2, ci == c) at 112x112.
SHAPES = ((8, 28, 28, 80, 480, 112, 1, False, 5),
          (8, 14, 14, 112, 672, 112, 1, True, 5),
          (8, 14, 14, 112, 672, 192, 2, False, 5),
          (8, 7, 7, 192, 1152, 192, 1, True, 5),
          (1, 7, 7, 192, 1152, 192, 1, True, 5),
          (8, 56, 56, 24, 144, 24, 1, True, 3),
          (8, 14, 14, 96, 576, 160, 2, False, 3),
          (8, 7, 7, 160, 960, 160, 1, True, 3),
          (8, 56, 56, 128, 128, 128, 1, False, 3),
          (8, 28, 28, 256, 256, 512, 2, False, 3),
          (8, 7, 7, 1024, 1024, 1024, 1, False, 3))


def _events_ms(fn, reps):
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fn, reps, launches=20):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _main_path_blocks(batches):
    """(arch, batch, ho, wo, ci, c, co, stride, k, residual, bias, hi, wi)
    of every fused2 / fused3 launch of the four bodies, each shape once."""
    import torch
    from repro_torch.core import network
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.mobilenet_inference import ARCHS
    seen, out = set(), []
    for arch, build in ARCHS.items():
        spec = build(1.0)
        for batch in batches:
            nplan = network.plan_network(spec, (batch, 112, 112, spec.c_in),
                                         dtype=torch.float32,
                                         policy=KernelPolicy())
            for p, shape, blk in zip(nplan.plans, nplan.block_shapes,
                                     spec.blocks):
                for sg in p.segments:
                    if sg.kind not in ("fused2", "fused3"):
                        continue
                    st = [blk.stages[i] for i in sg.stages]
                    d, proj = st[-2], st[-1]
                    _, h, w, ci = shape
                    c = st[0].features if sg.kind == "fused3" else ci
                    ho, wo = d.out_dims(h, w)
                    key = (batch, ho, wo, ci if c != ci else 0, c,
                           proj.features, d.stride, d.hf, p.residual_fused,
                           proj.bias, h, w)
                    if key not in seen:
                        seen.add(key)
                        out.append((arch,) + key)
    return out


def tune(batches, reps) -> int:
    import torch
    from repro_torch.kernels import blocking, ref, separable_fused
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for (arch, b, ho, wo, ci, c, co, stride, k, residual, bias, h,
             w) in _main_path_blocks(batches):
            x = rand((b, h, w, ci or c), dtype)
            ew = rand((ci, c), dtype, ci ** -0.5) if ci else None
            f, pw = rand((k, k, c), dtype, 1 / k), rand((c, co), dtype,
                                                          c ** -0.5)
            dwb = rand((c,), dtype, 0.1) if bias else None
            pwb = rand((co,), dtype, 0.1) if bias else None
            res = x if residual else None
            pad = ref.same_pads(h, w, k, k, stride)
            geo = dict(stride=stride, hf=k, wf=k, dtype=dtype, batch=b,
                       hi=h, wi=w)
            planned = blocking.plan_separable_fused(ho, wo, ci, c, co, **geo)

            def run(p):
                return lambda: separable_fused.separable_fused(
                    x, f, pw, dwb, pwb, res, expand_w=ew, pad=pad,
                    stride=stride, dw_activation="relu6", activation="relu6" if bias
                    else None, slab_h=p.slab_h, block_c=p.block_c,
                    block_co=p.block_co, cluster=p.cluster)

            rows = []
            for q in blocking.separable_fused_ladder(ho, wo, ci, c, co,
                                                     **geo)[1:]:
                ms = _graph_ms(run(q), reps, launches=10)
                rows.append({"slab_h": q.slab_h, "cluster": q.cluster,
                             "panel": q.block_co, "cb": q.block_c,
                             "ctas": q.ctas, "smem": q.smem_bytes,
                             "ms": ms})
            rows.sort(key=lambda r: r["ms"])
            print(json.dumps({
                "arch": arch, "dtype": str(dtype).replace("torch.", ""),
                "shape": [b, ho, wo, ci, c, co, stride, k, residual],
                "planned": {"slab_h": planned.slab_h,
                            "cluster": planned.cluster,
                            "panel": planned.block_co,
                            "cb": planned.block_c, "ctas": planned.ctas,
                            "smem": planned.smem_bytes,
                            "ms": _graph_ms(run(planned), reps,
                                            launches=10)},
                "candidates": rows}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--batch", type=int, action="append")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, separable_fused
    if not torch.cuda.is_available():
        print("bench_separable_fused: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tune:
        return tune(args.batch or [1, 8], args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    takes_pad = "pad" in inspect.signature(
        separable_fused.separable_fused).parameters
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, ci, c, co, stride, residual, k in SHAPES:
            expand = ci != c
            x_raw = rand((b, h, w, ci), dtype)
            x = ref.pad_same(x_raw, k, k, stride)
            ew = rand((ci, c), dtype, ci ** -0.5) if expand else None
            f, pw = rand((k, k, c), dtype, 1 / k), rand((c, co), dtype,
                                                          c ** -0.5)
            # V1's blocks carry biases and a relu6 after the project
            dwb = None if expand else rand((c,), dtype, 0.1)
            pwb = None if expand else rand((co,), dtype, 0.1)
            act = None if expand else "relu6"
            res = x_raw if residual else None
            kw = dict(expand_w=ew, stride=stride, dw_activation="relu6",
                      activation=act)
            if takes_pad:
                pad = ref.same_pads(h, w, k, k, stride)
                def kernel():
                    return separable_fused.separable_fused(
                        x_raw, f, pw, dwb, pwb, res, pad=pad, **kw)
            else:
                def kernel():
                    return separable_fused.separable_fused(
                        x, f, pw, dwb, pwb, res, **kw)
            fc = f.permute(2, 0, 1)[:, None].contiguous()

            def library():
                y = torch.matmul(x, ew).clamp_(0, 6) if expand else x
                y = F.conv2d(y.permute(0, 3, 1, 2), fc, dwb, stride=stride,
                             groups=c).clamp_(0, 6)
                y = torch.matmul(y.permute(0, 2, 3, 1), pw)
                if pwb is not None:
                    y = y.add_(pwb)
                if act:
                    y = y.clamp_(0, 6)
                return y.add_(res) if residual else y

            want = separable_fused.separable_fused_plain(
                x, f, pw, dwb, pwb, res, **kw)
            got = kernel()
            torch.cuda.synchronize(dev)
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            print(json.dumps({
                "card": card, "src": args.src,
                "shape": f"{b}x{h}x{w}x{ci}"
                         + (f"(x{c})" if expand else "")
                         + f"->{co} k{k} s{stride}"
                         + (" +res" if residual else ""),
                "dtype": str(dtype).replace("torch.", ""),
                "graph_ms": _graph_ms(kernel, args.reps),
                "ms": _events_ms(kernel, args.reps),
                "library_graph_ms": _graph_ms(library, args.reps),
                "library_ms": _events_ms(library, args.reps),
                "max_rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
