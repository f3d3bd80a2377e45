#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

From the root of a checkout it:

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions; turns TF32 off for matmul and cuDNN (cuDNN's
   fp32 convolutions default to TF32, which would spoil the plain DW
   yardstick);
2. builds every kernel from ``src/repro_torch/csrc`` (one nvcc per source,
   all at once) and prints the build seconds and ptxas' register report;
3. holds each kernel against its plain PyTorch version on the card at
   main-path shapes (3x3 and 5x5 taps), in fp32 and bf16, and times the
   kernel, the plain version and PyTorch library calls for the same
   function;
4. drives the port's main path, ``execute_network`` on MobileNet V1 and
   V2, MnasNet-A1 and EfficientNet-Lite0 at width 1.0 and 112x112, batch 1
   and 8, fp32 and bf16 streaming, under the default plan and
   ``fused=False``: for each run it zeroes the launch counters, drives one
   forward, checks that the counters moved by exactly the expected counts,
   holds the output against the fp32 plain path and times the forward;
5. prints the kernels it launched, one JSON line of per-kernel numbers, the
   card again, and as its last line ``{"ok": true, "device": ...}``.

Any failed check raises, and the script exits non-zero before the last
line.  It needs one CUDA device and imports nothing of JAX or of the JAX
package.  With ``--out DIR`` the full results also go to
``DIR/chip_smoke.json``.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: Relative-to-max tolerances of a kernel against its plain version on the
#: same inputs.  fp32: the same products summed in another order than
#: cuDNN / cuBLAS / the plain path sum them.  bf16: both sides store bf16,
#: so they may differ by one bf16 rounding of the output.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}

#: Published H100 SXM peaks (NVIDIA data sheet): device memory rate, fp32
#: outside the tensor cores, dense bf16.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

#: Launches one forward makes, by plan: the segment counts the reference
#: planner gives these bodies at 112x112 (a standalone ``se`` segment
#: launches ``pwconv`` twice; ``mb`` is the plain ``F.conv2d``).
EXPECTED_LAUNCHES = {
    ("v1", None): {"separable_fused2": 13},
    ("v1", False): {"dwconv2d": 13, "pwconv": 13},
    ("v2", None): {"separable_fused2": 1, "separable_fused3": 16},
    ("v2", False): {"dwconv2d": 17, "pwconv": 33},
    ("mnasnet", None): {"separable_fused2": 1, "separable_fused3": 7,
                        "pwconv": 16, "dw_se": 8},
    ("mnasnet", False): {"dwconv2d": 16, "pwconv": 47},
    ("lite0", None): {"separable_fused2": 1, "fused_mbconv": 4,
                      "separable_fused3": 11},
    ("lite0", False): {"dwconv2d": 12, "pwconv": 27},
}

SOURCES = {
    "dwconv2d": ("src/repro_torch/csrc/dwconv2d.cu",
                 "src/repro/kernels/dwconv2d.py:87"),
    "pwconv": ("src/repro_torch/csrc/pwconv.cu",
               "src/repro/kernels/pwconv.py:122"),
    "separable_fused2": ("src/repro_torch/csrc/separable_fused.cu",
                         "src/repro/kernels/separable_fused.py:254"),
    "separable_fused3": ("src/repro_torch/csrc/separable_fused.cu",
                         "src/repro/kernels/separable_fused.py:254"),
    "fused_mbconv": ("src/repro_torch/csrc/fused_mbconv.cu",
                     "src/repro/kernels/fused_mbconv.py:193"),
    "dw_se": ("src/repro_torch/csrc/dw_se.cu",
              "src/repro/kernels/se_epilogue.py:143"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _versions(torch, build) -> str:
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    return (f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"torch CUDA {torch.version.cuda}, nvcc: {nv[-1]}")


class KernelChecks:
    """Each kernel against its plain version at main-path shapes."""

    def __init__(self, torch, dev):
        from repro_torch.kernels import ref
        from repro_torch.mobilenet_inference import rel_err, time_ms
        self.torch, self.dev = torch, dev
        self.pad_same, self.rel_err, self.time_ms = ref.pad_same, rel_err, time_ms
        self.gen = torch.Generator().manual_seed(0)
        self.results = []

    def rand(self, shape, dtype, scale=1.0):
        t = self.torch.randn(shape, generator=self.gen) * scale
        return t.to(device=self.dev, dtype=dtype)

    def measure(self, name, label, dtype, kern, plain, library, ops, nbytes):
        torch = self.torch
        got, want = kern(), plain()
        torch.cuda.synchronize(self.dev)
        dname = str(dtype).replace("torch.", "")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = self.rel_err(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        ms = self.time_ms(kern, self.dev, reps=20, warmup=3)
        plain_ms = self.time_ms(plain, self.dev, reps=20, warmup=3)
        library_ms = self.time_ms(library, self.dev, reps=20, warmup=3)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dname] * 1e3
        r = {"name": name, "shape": label, "dtype": dname,
             "max_abs_err": abs_err, "max_rel_err": rel,
             "tol": KERNEL_TOL[dname], "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops}
        print(f"  {name:17s} {label:44s} {dname:8s} rel err {rel:.2e} "
              f"(tol {r['tol']:g}) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        if not (finite and rel <= r["tol"]):
            raise AssertionError(f"{name} {label} {dname}: rel err {rel} "
                                 f"> {r['tol']} (finite={finite})")
        self.results.append(r)

    def dwconv2d(self, b, h, w, c, stride, dtype, k=3):
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, dwconv2d
        x = self.pad_same(self.rand((b, h, w, c), dtype), k, k, stride)
        f = self.rand((k, k, c), dtype, 1 / k)
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_dwconv2d(x.shape[1], x.shape[2], ho, wo, c,
                                      k, k, dtype=dtype)
        xc = x.permute(0, 3, 1, 2)
        fc = f.permute(2, 0, 1)[:, None].contiguous()
        self.measure(
            "dwconv2d", f"{b}x{h}x{w}x{c} k{k} s{stride} vec {plan.block_c}",
            dtype,
            lambda: dwconv2d.dwconv2d(x, f, stride=stride,
                                      block_c=plan.block_c),
            lambda: dwconv2d.dwconv2d_plain(x, f, stride=stride),
            lambda: F.conv2d(xc, fc, stride=stride, groups=c),
            2 * b * ho * wo * c * k * k,
            (x.numel() + f.numel() + b * ho * wo * c) * x.element_size())

    def pwconv(self, g, ci, co, dtype):
        torch = self.torch
        from repro_torch.kernels import pwconv
        x = self.rand((g, ci), dtype)
        w = self.rand((ci, co), dtype, ci ** -0.5)
        bias = self.rand((co,), dtype, 0.1)
        self.measure(
            "pwconv", f"G={g} {ci}->{co} relu6", dtype,
            lambda: pwconv.pwconv(x, w, bias, activation="relu6"),
            lambda: pwconv.pwconv_plain(x, w, bias, activation="relu6"),
            lambda: torch.addmm(bias, x, w),
            2 * g * ci * co,
            (x.numel() + w.numel() + co + g * co) * x.element_size())

    def fused(self, b, h, w, ci, c, co, stride, residual, dtype, k=3):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, separable_fused
        expand = ci != c
        x_raw = self.rand((b, h, w, ci), dtype)
        x = self.pad_same(x_raw, k, k, stride)
        ew = self.rand((ci, c), dtype, ci ** -0.5) if expand else None
        f = self.rand((k, k, c), dtype, 1 / k)
        dwb = self.rand((c,), dtype, 0.1)
        pw = self.rand((c, co), dtype, c ** -0.5)
        pwb = self.rand((co,), dtype, 0.1)
        res = x_raw if residual else None
        ho, wo = -(-h // stride), -(-w // stride)
        if expand:
            plan = blocking.plan_separable3(ho, wo, ci, c, co, stride=stride,
                                            hf=k, wf=k, dtype=dtype)
        else:
            plan = blocking.plan_separable(ho, wo, c, co, stride=stride,
                                           hf=k, wf=k, dtype=dtype)
        self.same_smem(plan.smem_bytes, separable_fused.smem_bytes(
            ci, c, k, k, stride, plan.slab_h, plan.tile_w, plan.block_c,
            plan.block_co, expand, dtype))
        act = None if expand else "relu6"
        kw = dict(expand_w=ew, stride=stride, dw_activation="relu6",
                  activation=act)
        fc = f.permute(2, 0, 1)[:, None].contiguous()

        def library():
            y = torch.matmul(x, ew) if expand else x
            y = F.conv2d(y.permute(0, 3, 1, 2), fc, dwb, stride=stride,
                         groups=c)
            return torch.matmul(y.permute(0, 2, 3, 1), pw)

        ops = 2 * b * ho * wo * c * (k * k + co)
        if expand:
            ops += 2 * b * h * w * ci * c
        nbytes = (x.numel() + f.numel() + c + pw.numel() + co
                  + (ew.numel() if expand else 0)
                  + (res.numel() if residual else 0) + b * ho * wo * co)
        name = "separable_fused3" if expand else "separable_fused2"
        label = (f"{b}x{h}x{w}x{ci}" + (f"(x{c})" if expand else "")
                 + f"->{co} k{k} s{stride}" + (" +res" if residual else "")
                 + f" tile {plan.slab_h}x{plan.tile_w} cb {plan.block_c}")
        self.measure(
            name, label, dtype,
            lambda: separable_fused.separable_fused(
                x, f, pw, dwb, pwb, res, block_c=plan.block_c,
                block_co=plan.block_co, slab_h=plan.slab_h,
                tile_w=plan.tile_w, **kw),
            lambda: separable_fused.separable_fused_plain(
                x, f, pw, dwb, pwb, res, **kw),
            library, ops, nbytes * x.element_size())

    @staticmethod
    def same_smem(planned, kernel):
        if kernel != planned:
            raise AssertionError(f"planner models {planned} B of shared "
                                 f"memory, the kernel {kernel}")

    def fused_mb(self, b, h, w, ci, c, co, stride, residual, dtype, k=3):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, fused_mbconv
        x_raw = self.rand((b, h, w, ci), dtype)
        x = self.pad_same(x_raw, k, k, stride)
        f = self.rand((k, k, ci, c), dtype, (k * k * ci) ** -0.5)
        fb = self.rand((c,), dtype, 0.1)
        pw = self.rand((c, co), dtype, c ** -0.5)
        pwb = self.rand((co,), dtype, 0.1)
        res = x_raw if residual else None
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_fused_mb(ho, wo, ci, c, co, stride=stride,
                                      hf=k, wf=k, dtype=dtype)
        self.same_smem(plan.smem_bytes, fused_mbconv.smem_bytes(
            ci, k, k, stride, plan.slab_h, plan.tile_w, plan.block_c,
            plan.block_co))
        kw = dict(stride=stride, mb_activation="relu6", activation=None)
        xc = x.permute(0, 3, 1, 2)
        fc = f.permute(3, 2, 0, 1).contiguous()

        def library():
            y = F.conv2d(xc, fc, fb, stride=stride).clamp_(0, 6)
            return torch.addmm(pwb, y.permute(0, 2, 3, 1).reshape(-1, c), pw)

        ops = 2 * b * ho * wo * c * (k * k * ci + co)
        nbytes = (x.numel() + f.numel() + c + pw.numel() + co
                  + (res.numel() if residual else 0) + b * ho * wo * co)
        self.measure(
            "fused_mbconv",
            f"{b}x{h}x{w}x{ci}(x{c})->{co} k{k} s{stride}"
            + (" +res" if residual else "")
            + f" tile {plan.slab_h}x{plan.tile_w} cb {plan.block_c}", dtype,
            lambda: fused_mbconv.fused_mbconv(
                x, f, pw, fb, pwb, res, block_c=plan.block_c,
                block_co=plan.block_co, slab_h=plan.slab_h,
                tile_w=plan.tile_w, **kw),
            lambda: fused_mbconv.fused_mbconv_plain(x, f, pw, fb, pwb, res,
                                                    **kw),
            library, ops, nbytes * x.element_size())

    def dw_se(self, b, h, w, c, c_se, stride, dtype, k=3):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, se_epilogue
        x = self.pad_same(self.rand((b, h, w, c), dtype), k, k, stride)
        f = self.rand((k, k, c), dtype, 1 / k)
        w1 = self.rand((c, c_se), dtype, c ** -0.5)
        b1 = self.rand((c_se,), dtype, 0.1)
        w2 = self.rand((c_se, c), dtype, c_se ** -0.5)
        b2 = self.rand((c,), dtype, 0.1)
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_dw_se(x.shape[1], x.shape[2], ho, wo, c, c_se,
                                   k, k, dtype=dtype)
        self.same_smem(plan.smem_bytes, se_epilogue.smem_bytes(
            ho, wo, c, c_se, plan.cluster))
        kw = dict(stride=stride, dw_activation="relu", se_activation="relu")
        xc = x.permute(0, 3, 1, 2)
        fc = f.permute(2, 0, 1)[:, None].contiguous()

        def library():
            y = F.conv2d(xc, fc, stride=stride, groups=c).relu_()
            hid = torch.addmm(b1, y.mean(dim=(2, 3)), w1).relu_()
            gate = torch.sigmoid(torch.addmm(b2, hid, w2))
            return y * gate[:, :, None, None]

        npix = b * ho * wo * c
        ops = 2 * npix * k * k + 2 * npix + 4 * b * c * c_se
        nbytes = (x.numel() + f.numel() + 2 * c * c_se + c_se + c + npix)
        self.measure(
            "dw_se", f"{b}x{h}x{w}x{c} k{k} s{stride} Cse {c_se} cluster "
            f"{plan.cluster}", dtype,
            lambda: se_epilogue.dw_se(x, f, w1, b1, w2, b2,
                                      cluster=plan.cluster, **kw),
            lambda: se_epilogue.dw_se_plain(x, f, w1, b1, w2, b2, **kw),
            library, ops, nbytes * x.element_size())


def run_networks(torch, dev):
    """The main path: execute_network on V1, V2, MnasNet-A1 and Lite0,
    every plan, dtype and batch."""
    from repro_torch.mobilenet_inference import (ARCHS, KERNEL_SEGMENTS,
                                                 expected_launches,
                                                 run_network)
    totals = dict.fromkeys(KERNEL_SEGMENTS, 0)
    runs = []
    for arch, build in ARCHS.items():
        spec = build(1.0)
        for fused in (None, False):
            for batch in (1, 8):
                for dtype in ("fp32", "bf16"):
                    r = run_network(spec, res=112, batch=batch, dtype=dtype,
                                    fused=fused, device=dev)
                    want = dict.fromkeys(KERNEL_SEGMENTS, 0)
                    want.update(EXPECTED_LAUNCHES[(arch, fused)])
                    plan_counts = expected_launches(r["histogram"])
                    plan_name = "default" if fused is None else "fused=False"
                    peak = r["peak_bytes"] / 2 ** 20
                    busy = sum(r["device_ms"].values())
                    print(f"  {arch:7s} {plan_name:11s} batch {batch} {dtype}: "
                          f"{r['ms']:.3f} ms/forward, peak {peak:.1f} MiB, "
                          f"rel err {r['rel_err']:.2e} (tol {r['tol']:g}), "
                          f"launches {r['launches']}", flush=True)
                    print(f"    device {busy:.3f} ms/forward: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in sorted(
                            r["device_ms"].items())), flush=True)
                    if r["launches"] != want or plan_counts != want:
                        raise AssertionError(
                            f"{arch} {plan_name} b{batch} {dtype}: launches "
                            f"{r['launches']}, plan {plan_counts}, expected "
                            f"{want}")
                    if not (r["finite_and_shaped"]
                            and r["rel_err"] <= r["tol"]):
                        raise AssertionError(
                            f"{arch} {plan_name} b{batch} {dtype}: rel err "
                            f"{r['rel_err']} > {r['tol']} or bad output")
                    for k in totals:
                        totals[k] += r["launches"][k]
                    runs.append({"arch": arch, "plan": plan_name,
                                 "batch": batch, "dtype": dtype,
                                 **{k: r[k] for k in (
                                     "ms", "peak_bytes", "device_ms",
                                     "rel_err", "launches", "out_shape")}})
    return runs, totals


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "NVIDIA GPU.")
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(_versions(torch, _build))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, p in paths.items():
        log = p.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                                text))
        print(f"  ptxas {name}: {len(regs)} kernels, at most "
              f"{max(regs, default=0)} registers, {spills} bytes of spill "
              "stores in all")

    print("kernels vs plain versions:")
    kc = KernelChecks(torch, dev)
    for dtype in (torch.float32, torch.bfloat16):
        kc.dwconv2d(8, 112, 112, 32, 1, dtype)
        kc.dwconv2d(8, 112, 112, 64, 2, dtype)
        kc.dwconv2d(8, 56, 56, 72, 2, dtype, k=5)
        kc.pwconv(8 * 56 * 56, 128, 256, dtype)
        kc.fused(8, 56, 56, 128, 128, 128, 1, False, dtype)
        kc.fused(8, 28, 28, 256, 256, 512, 2, False, dtype)
        kc.fused(8, 56, 56, 24, 144, 24, 1, True, dtype)
        kc.fused(8, 14, 14, 96, 576, 160, 2, False, dtype)
        kc.fused(8, 14, 14, 112, 672, 112, 1, True, dtype, k=5)
        kc.fused_mb(8, 112, 112, 16, 96, 24, 2, False, dtype)
        kc.fused_mb(8, 56, 56, 24, 144, 24, 1, True, dtype)
        kc.dw_se(8, 56, 56, 72, 6, 2, dtype, k=5)
        kc.dw_se(8, 14, 14, 672, 28, 1, dtype)

    print("main path: execute_network, MobileNet V1/V2, MnasNet-A1 and "
          "EfficientNet-Lite0 at width 1.0, 112x112:")
    runs, launches = run_networks(torch, dev)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        first = next(r for r in kc.results
                     if r["name"] == name and r["dtype"] == "float32")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **{k: first[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "shape", "dtype",
                            "max_rel_err")}})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump({"card": card, "kernel_checks": kc.results,
                       "networks": runs, "launches": launches,
                       "seconds": time.perf_counter() - t_start}, fh,
                      indent=1)
    print(f"kernels launched and checked: {', '.join(SOURCES)} "
          f"({time.perf_counter() - t_start:.0f} s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
