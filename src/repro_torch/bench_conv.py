"""Time the ``fused_mbconv``, ``dwconv2d`` or ``dw_se`` kernel of one
checkout at the main path's shapes, on the card.

    python3 src/repro_torch/bench_conv.py
        --kernel fused_mbconv|dwconv2d|dw_se [--src DIR] [--reps N]
    python3 src/repro_torch/bench_conv.py --kernel ... --tune

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default the one beside this file), so that one session on the card can time
two checkouts in turn, for example a parent commit unpacked under
``build/parent`` against this one, in the order parent, change, change,
parent:

    for s in build/parent/src src src build/parent/src; do
        python3 src/repro_torch/bench_conv.py --kernel fused_mbconv --src $s
    done

Each checkout builds its own kernels into its own ``build/`` directory.  A
checkout whose wrapper takes ``pad`` gets the unpadded input and pads as it
reads, as the main path calls it; an older one gets the input padded first
(and is skipped at a filter its kernel does not take; an older ``dw_se``
plans its own cluster and mode).  The shapes: ``fused_mbconv`` at
EfficientNet-Lite0's four fused-MBConv blocks at batch 8 and its last at
batch 1; ``dwconv2d`` at the three depthwise shapes of ``chip_smoke.py``
(8x112x112x32 s1, 8x112x112x64 s2, 8x56x56x72 s2 5x5) and at 9x9 and
11x11; ``dw_se`` at MnasNet-A1's six SE block shapes at batch 8 and 1 and
its blocks 3 and 11 at a 224 input at batch 8.  The script prints one JSON
line per shape and dtype:
the card's name and power limit, the source directory, the kernel's ms
replayed from a CUDA graph of 20 launches (median of ``--reps`` replays, L2
warm) and from CUDA events around one eager launch, the same two times of
the PyTorch library call or composition of the same function
(``F.conv2d`` with ``groups=C``; ``F.conv2d`` + bias, relu6, ``addmm`` and
the residual add; ``F.conv2d``, relu, mean, two ``addmm``, sigmoid and the
scale), and the kernel's largest error relative to the plain version.

``--tune`` times, at each of those shapes (``fused_mbconv`` also at batch 1
for all four blocks), fp32 and bf16, every plan of the planner's own
search (``blocking.fused_mb_ladder``: each slab height, cluster and panel
of the full-width tiles; ``dwconv2d_ladder`` and ``dw_se_ladder``: tiles of
other rows, columns and channel groups; the ladders the autotuner draws
its candidates from), graph-timed, one JSON line per shape: the planner's
ms and its plan, and every candidate's, fastest first.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

#: fused_mbconv: (batch, h, w, ci, c, co, stride, residual) of Lite0's
#: blocks A-D at batch 8, and D at batch 1 (3x3 taps).
MB_SHAPES = ((8, 112, 112, 16, 96, 24, 2, False),
             (8, 56, 56, 24, 144, 24, 1, True),
             (8, 56, 56, 24, 144, 40, 2, False),
             (8, 28, 28, 40, 240, 40, 1, True),
             (1, 28, 28, 40, 240, 40, 1, True))
#: dwconv2d: (batch, h, w, c, stride, k).
DW_SHAPES = ((8, 112, 112, 32, 1, 3), (8, 112, 112, 64, 2, 3),
             (8, 56, 56, 72, 2, 5), (8, 56, 56, 72, 1, 9),
             (8, 56, 56, 72, 2, 11))
#: dw_se: (batch, h, w, c, c_se, stride, k) of MnasNet-A1's SE blocks 3,
#: 4-5, 10, 11, 12 and 13-14 at a 112 body input, batch 8 then 1, and of
#: blocks 3 and 11 at a 224 input, batch 8.
_SE = ((56, 56, 72, 6, 2, 5), (28, 28, 120, 10, 1, 5), (14, 14, 480, 20, 1, 3),
       (14, 14, 672, 28, 1, 3), (14, 14, 672, 28, 2, 5), (7, 7, 960, 40, 1, 5))
SE_SHAPES = (tuple((8,) + s for s in _SE) + tuple((1,) + s for s in _SE)
             + ((8, 112, 112, 72, 6, 2, 5), (8, 28, 28, 672, 28, 1, 3)))
SHAPES = {"fused_mbconv": MB_SHAPES, "dwconv2d": DW_SHAPES,
          "dw_se": SE_SHAPES}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _events_ms(fn, reps):
    from repro_torch.measure import time_ms
    import torch
    return time_ms(fn, torch.device("cuda", 0), reps=reps, warmup=5)


def _graph_ms(fn, reps, launches=20):
    from repro_torch.measure import graph_ms
    import torch
    return graph_ms(fn, torch.device("cuda", 0), launches=launches,
                    reps=reps)


class Case:
    """The operands, kernel call, plain version and library yardstick of
    one shape."""

    def __init__(self, kernel, shape, dtype, takes_pad):
        import torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        dev = torch.device("cuda", 0)
        gen = torch.Generator().manual_seed(0)

        def rand(s, scale=1.0):
            return (torch.randn(s, generator=gen) * scale).to(dev, dtype)

        self.kernel, self.shape, self.dtype = kernel, shape, dtype
        if kernel == "fused_mbconv":
            from repro_torch.kernels import fused_mbconv as mod
            b, h, w, ci, c, co, s, residual = shape
            k = 3
            self.label = (f"{b}x{h}x{w}x{ci}(x{c})->{co} k{k} s{s}"
                          + (" +res" if residual else ""))
            x = rand((b, h, w, ci))
            xp = ref.pad_same(x, k, k, s)
            f, fb = rand((k, k, ci, c), (k * k * ci) ** -0.5), rand((c,), 0.1)
            pw, pwb = rand((c, co), c ** -0.5), rand((co,), 0.1)
            res = x if residual else None
            pad = ref.same_pads(h, w, k, k, s)
            kw = dict(stride=s, mb_activation="relu6", activation=None)
            self.args = (x, f, pw, fb, pwb, res)
            self.kw = dict(kw, pad=pad) if takes_pad else kw
            self.xin = x if takes_pad else xp
            self.call = lambda **blocks: mod.fused_mbconv(
                self.xin, f, pw, fb, pwb, res, **self.kw, **blocks)
            self.plain = lambda: mod.fused_mbconv_plain(xp, f, pw, fb, pwb,
                                                        res, **kw)
            xc, fc = xp.permute(0, 3, 1, 2), f.permute(3, 2, 0, 1).contiguous()

            def library():
                y = F.conv2d(xc, fc, fb, stride=s).clamp_(0, 6)
                y = torch.addmm(pwb, y.permute(0, 2, 3, 1).reshape(-1, c), pw)
                return y.view(res.shape).add_(res) if residual else y
            self.library = library
        elif kernel == "dw_se":
            from repro_torch.kernels import se_epilogue as mod
            b, h, w, c, c_se, s, k = shape
            self.label = f"{b}x{h}x{w}x{c} k{k} s{s} Cse {c_se}"
            x = rand((b, h, w, c))
            xp = ref.pad_same(x, k, k, s)
            f = rand((k, k, c), 1 / k)
            w1, b1, w2, b2 = gate = (rand((c, c_se), c ** -0.5),
                                     rand((c_se,), 0.1),
                                     rand((c_se, c), c_se ** -0.5),
                                     rand((c,), 0.1))
            kw = dict(stride=s, dw_activation="relu", se_activation="relu")
            self.xin = x if takes_pad else xp
            self.kw = dict(kw, pad=ref.same_pads(h, w, k, k, s)) \
                if takes_pad else kw
            self.call = lambda **blocks: mod.dw_se(self.xin, f, *gate,
                                                   **self.kw, **blocks)
            self.plain = lambda: mod.dw_se_plain(xp, f, *gate, **kw)
            xc = xp.permute(0, 3, 1, 2)
            fc = f.permute(2, 0, 1)[:, None].contiguous()

            def library():
                y = F.conv2d(xc, fc, stride=s, groups=c).relu_()
                hid = torch.addmm(b1, y.mean(dim=(2, 3)), w1).relu_()
                g = torch.sigmoid(torch.addmm(b2, hid, w2))
                return y * g[:, :, None, None]
            self.library = library
        else:
            from repro_torch.kernels import dwconv2d as mod
            b, h, w, c, s, k = shape
            self.label = f"{b}x{h}x{w}x{c} k{k} s{s}"
            x = rand((b, h, w, c))
            xp = ref.pad_same(x, k, k, s)
            f = rand((k, k, c), 1 / k)
            pad = ref.same_pads(h, w, k, k, s)
            self.xin = x if takes_pad else xp
            self.kw = dict(stride=s, pad=pad) if takes_pad else dict(stride=s)
            self.call = lambda **blocks: mod.dwconv2d(self.xin, f, **self.kw,
                                                      **blocks)
            self.plain = lambda: mod.dwconv2d_plain(xp, f, stride=s)
            xc = xp.permute(0, 3, 1, 2)
            fc = f.permute(2, 0, 1)[:, None].contiguous()
            self.library = lambda: F.conv2d(xc, fc, stride=s, groups=c)

    def error(self):
        import torch
        got, want = self.call(), self.plain()
        torch.cuda.synchronize()
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())


def candidates(case):
    """The planner's plan and every plan of its search (the ladder of
    ``blocking.fused_mb_ladder``, ``dw_se_ladder`` or ``dwconv2d_ladder``,
    which the autotuner also measures), as keyword blocks."""
    from repro_torch.kernels import blocking
    dt = case.dtype
    if case.kernel == "fused_mbconv":
        b, h, w, ci, c, co, s, _ = case.shape
        ho, wo = -(-h // s), -(-w // s)
        ladder = blocking.fused_mb_ladder(ho, wo, ci, c, co, stride=s,
                                          dtype=dt, batch=b)
        blocks = lambda p: dict(slab_h=p.slab_h, tile_w=p.tile_w,  # noqa: E731
                                block_c=p.block_c, block_co=p.block_co,
                                cluster=p.cluster)
        fields = lambda p: {"slab_h": p.slab_h, "cluster": p.cluster,  # noqa: E731
                            "cb": p.block_c, "ctas": p.ctas,
                            "smem": p.smem_bytes}
    else:
        if case.kernel == "dw_se":
            b, h, w, c, c_se, s, k = case.shape
            ho, wo = -(-h // s), -(-w // s)
            ladder = blocking.dw_se_ladder(ho, wo, c, c_se, k, k, stride=s,
                                           dtype=dt, batch=b)
        else:
            b, h, w, c, s, k = case.shape
            ho, wo = -(-h // s), -(-w // s)
            ladder = blocking.dwconv2d_ladder(ho, wo, c, k, k, stride=s,
                                              dtype=dt)
        blocks = lambda p: dict(slab_h=p.slab_h, tile_w=p.tile_w,  # noqa: E731
                                block_c=p.block_c)
        fields = lambda p: {"slab_h": p.slab_h, "tile_w": p.tile_w,  # noqa: E731
                            "block_c": p.block_c, "smem": p.smem_bytes,
                            "ctas": b * -(-ho // p.slab_h)
                            * -(-wo // p.tile_w) * -(-c // p.block_c)}
    return ladder[0], ladder[1:], blocks, fields


def tune(kernel, reps) -> int:
    import torch
    shapes = SHAPES[kernel]
    if kernel == "fused_mbconv":
        shapes = shapes + tuple((1,) + s[1:] for s in MB_SHAPES[:3])
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            case = Case(kernel, shape, dtype, True)
            planned, cands, blocks, fields = candidates(case)
            rows = []
            for q in cands:
                ms = _graph_ms(lambda: case.call(**blocks(q)), reps, 10)
                rows.append({**fields(q), "ms": ms})
            rows.sort(key=lambda r: r["ms"])
            print(json.dumps({
                "kernel": kernel, "shape": case.label,
                "dtype": str(dtype).replace("torch.", ""),
                "planned": {**fields(planned), "ms": _graph_ms(
                    lambda: case.call(**blocks(planned)), reps, 10)},
                "candidates": rows}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(SHAPES), required=True)
    ap.add_argument("--src", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tune", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_conv: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tune:
        return tune(args.kernel, args.reps)
    if args.kernel == "fused_mbconv":
        from repro_torch.kernels.fused_mbconv import fused_mbconv as fn
    elif args.kernel == "dw_se":
        from repro_torch.kernels.se_epilogue import dw_se as fn
    else:
        from repro_torch.kernels.dwconv2d import dwconv2d as fn
    shapes = SHAPES[args.kernel]
    takes_pad = "pad" in inspect.signature(fn).parameters
    name = card()
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            if not takes_pad and args.kernel == "dwconv2d" and shape[-1] > 7:
                continue  # the older kernel holds at most 7x7 taps
            case = Case(args.kernel, shape, dtype, takes_pad)
            err = case.error()
            print(json.dumps({
                "card": name, "src": args.src, "kernel": args.kernel,
                "shape": case.label,
                "dtype": str(dtype).replace("torch.", ""),
                "graph_ms": _graph_ms(case.call, args.reps),
                "ms": _events_ms(case.call, args.reps),
                "library_graph_ms": _graph_ms(case.library, args.reps),
                "library_ms": _events_ms(case.library, args.reps),
                "max_rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
