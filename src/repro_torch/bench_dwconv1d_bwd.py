"""Times ``dwconv1d``'s backward (``csrc/dwconv1d.cu::dw1d_bwd_kernel``)
beside variants of its design, on the card.

    PYTHONPATH=src python3 src/repro_torch/bench_dwconv1d_bwd.py \\
        [--variants JSON] [--reps 5]

Each variant is the library's source with some of its ``kBwd*`` constants
replaced (``{"name": "s3", "kBwdStages": 3}``; ``"fold": false`` drops the
cluster's df sum, so that variant computes dx alone), built into a library
of its own under ``build/repro_torch/bwd_variants/`` (one nvcc each, all
at once).  At xLSTM's and hymba's training shapes and hymba's tp 2 / 4
channel blocks (K = 4, fp32 and bf16) every variant's dx (and df where it
folds) is held to ``dwconv1d_causal_bwd_plain`` and timed as a CUDA graph
of 20 launches (``measure.graph_ms``, L2 warm), beside one
``torch.add(x, dy, out=)`` that moves the same bytes.  One JSON line a
shape and dtype: ms and share of the byte bound by variant, and ptxas'
registers of each variant's K = 4 vector kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch import measure
from repro_torch.kernels import _build, dwconv1d

#: The design's alternatives that were measured against it: 3 and 4 stages,
#: smaller and larger chunks, a register cap, two channels a lane, 256
#: threads a CTA, fewer or more CTAs, clusters of at most 8, no df fold.
VARIANTS = [
    {"name": "design"},
    {"name": "stages3", "kBwdStages": 3},
    {"name": "stages4", "kBwdStages": 4},
    {"name": "rows16_5", "kBwdRunRows16": 5},
    {"name": "rows16_13", "kBwdRunRows16": 13},
    {"name": "minblocks5", "kBwdMinBlocks": 5},
    {"name": "vec2", "kBwdVec": 2, "kBwdRunRows": 9},
    {"name": "threads256", "kBwdThreads": 256, "kBwdRunRows": 3,
     "kBwdRunRows16": 5},
    {"name": "fill132", "kBwdFill": 132},
    {"name": "fill528", "kBwdFill": 528},
    {"name": "cluster8", "kBwdMaxCluster": 8},
    {"name": "nofold", "fold": False},
]
SHAPES = ((8, 256, 1536), (8, 256, 768), (2, 640, 3200), (4, 640, 3200),
          (2, 640, 1600), (2, 640, 800))
HBM_BYTES_PER_S = 3.35e12
_FOLD = "cluster_fold<T>(cluster, [&](int e) {"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def variant_source(src: str, v: dict) -> str:
    """``src`` with the variant's constants replaced (each must occur once)
    and, for ``"fold": false``, the exact-K path's df fold removed."""
    for key, val in v.items():
        if key in ("name", "fold"):
            continue
        src, n = re.subn(rf"constexpr (int|long long) {key} = [^;]+;",
                         rf"constexpr \g<1> {key} = {val};", src)
        if n != 1:
            raise ValueError(f"{key} is not a constant of the source")
    if not v.get("fold", True):
        start = src.index(_FOLD)
        end = src.index("nch);", start) + len("nch);")
        src = src[:start] + src[end:]
    return src


def build(variants: list) -> dict:
    """{name: (library, registers of the K = 4 vector kernel by dtype)}."""
    out_dir = _build.BUILD_DIR / "bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "dwconv1d.cu").read_text()
    procs = {}
    for v in variants:
        cu = out_dir / f"{v['name']}.cu"
        cu.write_text(variant_source(src, v))
        lib = out_dir / f"lib{v['name']}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu), *_build.LINK_FLAGS]
        procs[v["name"]] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        regs = {}
        for tname, tag in (("float32", "If"), ("bfloat16", "I13__nv_bfloat16")):
            m = re.search(rf"dw1d_bwd_kernel{tag}Li4ELb1E\S*' for \S+\n"
                          rf"(?:.*\n)*?.*Used (\d+) registers", log)
            regs[tname] = int(m.group(1)) if m else -1
        libs[name] = (ctypes.CDLL(str(lib)), regs)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="JSON list of variants "
                    "(default: the design and its measured alternatives)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the backward runs on the card")
    variants = json.loads(args.variants) if args.variants else VARIANTS
    libs = build(variants)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "registers": {
        n: r for n, (_, r) in libs.items()}}), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        code, _ = _build.dtype_codes(dtype, dtype)
        for b, length, d in SHAPES:
            k = 4
            x = torch.randn((b, length, d), generator=gen).to(dev, dtype)
            f = (torch.randn((k, d), generator=gen) * 0.5).to(dev, dtype)
            dy = torch.randn((b, length, d), generator=gen).to(dev, dtype)
            want = dwconv1d.dwconv1d_causal_bwd_plain(x, f, dy)
            nbytes = (3 * x.numel() + 2 * f.numel()) * x.element_size()
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out = torch.empty_like(x)
            row = {"shape": f"{b}x{length}x{d}", "dtype": str(dtype)[6:],
                   "bound_ms": bound, "same_bytes_add_ms": measure.graph_ms(
                       lambda: torch.add(x, dy, out=out), dev)}
            for v in variants:
                lib = libs[v["name"]][0]
                fn = lib.dwconv1d_bwd_launch
                fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
                dx, df = torch.empty_like(x), torch.empty_like(f)

                def call():
                    rc = fn(x.data_ptr(), f.data_ptr(), dy.data_ptr(),
                            dx.data_ptr(), df.data_ptr(), b, length, d, k,
                            dwconv1d.vector_width(x, f, dy, dx, df), code,
                            _build.stream(dev))
                    if rc:
                        raise RuntimeError(f"variant {v['name']}: {rc}")
                call()
                torch.cuda.synchronize(dev)
                errs = [measure.rel_err(dx, want[0])]
                if v.get("fold", True):
                    errs.append(measure.rel_err(df, want[1]))
                if max(errs) > (1e-4 if dtype == torch.float32 else 1e-2):
                    raise AssertionError(f"variant {v['name']} {row}: "
                                         f"rel err {errs}")
                ms = measure.graph_ms(call, dev)
                row[v["name"]] = {"ms": ms, "share": bound / ms}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
