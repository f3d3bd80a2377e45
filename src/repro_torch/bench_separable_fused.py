"""Time the ``separable_fused`` kernel of one checkout at EfficientNet-Lite0's
5x5 and MobileNetV2's 3x3 inverted-residual shapes, on the card.

    python3 src/repro_torch/bench_separable_fused.py [--src DIR] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default the one beside this file), so that one session on the card can time
two checkouts in turn, for example a parent commit unpacked under
``build/parent`` against this one, in the order parent, change, change,
parent:

    for s in build/parent/src src src build/parent/src; do
        python3 src/repro_torch/bench_separable_fused.py --src $s; done

Each checkout builds its own kernels into its own ``build/`` directory.  The
script prints one JSON line per shape and dtype: the card's name and power
limit, the source directory, the kernel's ms (CUDA events, median of
``--reps`` after warm-up, L2 warm) and its largest error relative to the
plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

#: (batch, h, w, ci, c, co, stride, residual, k): Lite0 blocks 8, 9, 11, 12
#: (the 5x5 fused3 blocks of the main path) and V2 blocks 2 and 13 at
#: 112x112, batch 8.
SHAPES = ((8, 28, 28, 80, 480, 112, 1, False, 5),
          (8, 14, 14, 112, 672, 112, 1, True, 5),
          (8, 14, 14, 112, 672, 192, 2, False, 5),
          (8, 7, 7, 192, 1152, 192, 1, True, 5),
          (8, 56, 56, 24, 144, 24, 1, True, 3),
          (8, 14, 14, 96, 576, 160, 2, False, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.kernels import ref, separable_fused
    if not torch.cuda.is_available():
        print("bench_separable_fused: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, ci, c, co, stride, residual, k in SHAPES:
            x_raw = rand((b, h, w, ci), dtype)
            x = ref.pad_same(x_raw, k, k, stride)
            ew = rand((ci, c), dtype, ci ** -0.5)
            f, pw = rand((k, k, c), dtype, 1 / k), rand((c, co), dtype,
                                                          c ** -0.5)
            res = x_raw if residual else None
            kw = dict(expand_w=ew, stride=stride, dw_activation="relu6")

            def kernel():
                return separable_fused.separable_fused(x, f, pw, None, None,
                                                       res, **kw)

            want = separable_fused.separable_fused_plain(x, f, pw, None,
                                                         None, res, **kw)
            got = kernel()
            torch.cuda.synchronize(dev)
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            for _ in range(5):
                kernel()
            times = []
            for _ in range(args.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                kernel()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            print(json.dumps({
                "card": card, "src": args.src,
                "shape": f"{b}x{h}x{w}x{ci}(x{c})->{co} k{k} s{stride}"
                         + (" +res" if residual else ""),
                "dtype": str(dtype).replace("torch.", ""),
                "ms": statistics.median(times), "max_rel_err": err}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
