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
   main-path shapes (3x3 and 5x5 taps; the xLSTM conv and Linear shapes),
   in fp32 and bf16, and times the kernel, the plain version and PyTorch
   library calls for the same function;
4. drives the CNN path, ``execute_network`` on MobileNet V1 and
   V2, MnasNet-A1 and EfficientNet-Lite0 at width 1.0 and 112x112, batch 1
   and 8, fp32 and bf16 streaming, under the default plan and
   ``fused=False``: for each run it zeroes the launch counters, drives one
   forward, checks that the counters moved by exactly the expected counts,
   holds the output against the fp32 plain path and times the forward;
5. drives the serving path, xlstm-125m at full width on random weights
   from a seed: ``prefill`` of batch 1 and 8 prompts of 512 tokens, then
   32 greedy ``decode_step``s, in fp32 and bf16.  Around each call it
   zeroes the counters and checks the launches (12 ``dwconv1d`` + 60
   ``pwconv`` per prefill, 0 + 60 per decode step); it holds every call's
   logits against the fp32 plain path (``impl="torch"`` on the card; each
   decode step from the plain path's cache and token), reports the error
   of the kernel path run on its own cache, holds ``prefill`` against
   ``prefill_by_stepping`` at a 64-token prompt, and times prefill (host
   clock around the checked call) and decode (CUDA events, median of 10)
   with the device's busy share;
6. prints the kernels it launched, one JSON line of per-kernel numbers, the
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
    "dwconv1d": ("src/repro_torch/csrc/dwconv1d.cu",
                 "src/repro/kernels/dwconv1d.py:51"),
}

#: The serving phase: prompt length, greedy decode steps, the prompt of the
#: prefill_by_stepping oracle, and the bf16 tolerance of the reference's
#: network gate.
PROMPT_LEN, GEN_STEPS, STEPPING_PROMPT = 512, 32, 64
BF16_REL_TOL = 5e-2
#: fp32 kernels against the fp32 plain path (summation order).
FP32_REL_TOL = 1e-4


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
        from repro_torch.measure import rel_err, time_ms
        self.torch, self.dev = torch, dev
        self.pad_same, self.rel_err, self.time_ms = ref.pad_same, rel_err, time_ms
        self.gen = torch.Generator().manual_seed(0)
        self.results = []

    def rand(self, shape, dtype, scale=1.0):
        t = self.torch.randn(shape, generator=self.gen) * scale
        return t.to(device=self.dev, dtype=dtype)

    def measure(self, name, label, dtype, kern, plain, library, ops, nbytes,
                launches=1, extra=None):
        """``launches``: calls timed between one pair of events (a run of
        many for a microsecond kernel); ``extra``: more fields to keep."""
        torch = self.torch
        got, want = kern(), plain()
        torch.cuda.synchronize(self.dev)
        dname = str(dtype).replace("torch.", "")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = self.rel_err(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        kw = dict(reps=20, warmup=3, launches=launches)
        ms = self.time_ms(kern, self.dev, **kw)
        plain_ms = self.time_ms(plain, self.dev, **kw)
        library_ms = self.time_ms(library, self.dev, **kw)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dname] * 1e3
        r = {"name": name, "shape": label, "dtype": dname,
             "max_abs_err": abs_err, "max_rel_err": rel,
             "tol": KERNEL_TOL[dname], "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops, **(extra or {})}
        print(f"  {name:17s} {label:44s} {dname:8s} rel err {rel:.2e} "
              f"(tol {r['tol']:g}) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
              + "".join(f", {k} {v:.4f}" if isinstance(v, float)
                        else f", {k} {v}" for k, v in (extra or {}).items()),
              flush=True)
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

    def pwconv(self, g, ci, co, dtype, act="relu6"):
        """One shape: the planner's variant and tile, its shared memory
        against the kernel's own count, times over runs of 20 launches
        (eager, and replayed from a CUDA graph, which leaves out the host's
        launch overhead), and for ``stream`` also with L2 cold (a run
        rotating over copies of w that together exceed the 50 MB L2, as
        decode streams its weights)."""
        torch = self.torch
        from repro_torch.kernels import blocking, pwconv
        from repro_torch.measure import graph_ms
        x = self.rand((g, ci), dtype)
        w = self.rand((ci, co), dtype, ci ** -0.5)
        bias = self.rand((co,), dtype, 0.1)
        plan = blocking.plan_pwconv(g, ci, co, dtype=dtype)
        self.same_smem(plan.smem_bytes, pwconv.smem_bytes(
            plan.variant, plan.block_g, plan.block_co, plan.block_c, ci))
        extra = {"variant": plan.variant,
                 "tile": [plan.block_g, plan.block_co, plan.block_c,
                          plan.cluster],
                 "graph_ms": graph_ms(
                     lambda: pwconv.pwconv(x, w, bias, activation=act),
                     self.dev)}
        if plan.variant == "stream":
            copies = [w] + [w.clone() for _ in range(
                max(5, -(-64 * 2 ** 20 // (w.numel() * w.element_size()))))]
            turn = iter(range(10 ** 9))
            cold = lambda: pwconv.pwconv(  # noqa: E731
                x, copies[next(turn) % len(copies)], bias, activation=act)
            extra["cold_ms"] = self.time_ms(cold, self.dev, reps=20,
                                            warmup=3, launches=len(copies))
            extra["cold_graph_ms"] = graph_ms(cold, self.dev,
                                              launches=len(copies))
        before = pwconv.launches_by_variant[plan.variant]
        pwconv.pwconv(x, w, bias, activation=act)
        if pwconv.launches_by_variant[plan.variant] != before + 1:
            raise AssertionError(f"pwconv G={g} {ci}->{co}: the launch was "
                                 f"not counted as {plan.variant}")
        self.measure(
            "pwconv", f"G={g} {ci}->{co} {act or 'no act'} {plan.variant}",
            dtype,
            lambda: pwconv.pwconv(x, w, bias, activation=act),
            lambda: pwconv.pwconv_plain(x, w, bias, activation=act),
            lambda: torch.addmm(bias, x, w),
            2 * g * ci * co,
            (x.numel() + w.numel() + co + g * co) * x.element_size(),
            launches=20, extra=extra)

    def dwconv1d(self, b, length, d, k, dtype, rows=None):
        import torch.nn.functional as F
        from repro_torch.kernels import dwconv1d
        x = self.rand((b, length, d), dtype)
        f = self.rand((k, d), dtype, k ** -0.5)
        rows = rows or dwconv1d.ROWS
        xt, ft = x.transpose(1, 2), f.T[:, None, :]
        self.measure(
            "dwconv1d", f"{b}x{length}x{d} k{k} vec "
            f"{dwconv1d.vector_width(x, f)} rows {rows}", dtype,
            lambda: dwconv1d.dwconv1d_causal(x, f, rows=rows),
            lambda: dwconv1d.dwconv1d_causal_plain(x, f),
            lambda: F.conv1d(xt, ft, groups=d, padding=k - 1)[..., :length],
            2 * b * length * d * k,
            (2 * x.numel() + f.numel()) * x.element_size())

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
    variants = {}
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
                            r["device_ms"].items())) + "; pwconv by variant "
                        f"{r['pwconv_variants']}", flush=True)
                    check_variants(f"{arch} {plan_name} b{batch} {dtype}",
                                   r["pwconv_variants"],
                                   r["launches"]["pwconv"], dtype)
                    for k, v in r["pwconv_variants"].items():
                        variants[k] = variants.get(k, 0) + v
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
                                     "rel_err", "launches", "pwconv_variants",
                                     "out_shape")}})
    return runs, totals, variants


def check_variants(label, got, total, dtype, phase=None):
    """``pwconv``'s launches by variant in one counted call: every one
    counted once; a decode step streams every Linear; otherwise no fp32
    product reaches the tensor cores and no bf16 one (G > 16, rows TMA can
    describe, as every CNN and xLSTM width is) stays on the CUDA cores."""
    if sum(got.values()) != total:
        raise AssertionError(f"{label}: pwconv launches {total}, by variant "
                             f"{got}")
    if phase == "decode":
        bad = total - got["stream"]
    elif dtype in ("fp32", "float32"):
        bad = got["tc"]
    else:
        bad = got["simt"]
    if bad:
        raise AssertionError(f"{label} {phase or ''}: pwconv by variant "
                             f"{got}")


def run_serving(torch, dev):
    """The serving path: xlstm-125m at full width, prefill + greedy decode,
    batch 1 and 8, fp32 and bf16, each kernel-path call held against the
    plain path's call on the same inputs: fp32 within FP32_REL_TOL; bf16
    within BF16_REL_TOL of the bf16 plain path (random-init xLSTM does not
    hold the fp32 plain path to 5e-2 in bf16: a 512-token prefill at batch
    1 differs from it by about that much; PERF.md), the error against the
    fp32 plain path reported beside it."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import pwconv
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.serve import (expected_launches, launch_counts,
                                          reset_launch_counts)
    from repro_torch.measure import device_breakdown, rel_err, time_ms
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy

    t0 = time.perf_counter()
    cfg16 = get_config("xlstm-125m")
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    models = {"fp32": init_params(cfg32, seed=0, device=dev),
              "bf16": init_params(cfg16, seed=0, device=dev)}
    n = sum(p.numel() for p in models["fp32"].parameters())
    print(f"  random weights from seed 0, {n / 1e6:.1f}M parameters, fp32 "
          f"and bf16, in {time.perf_counter() - t0:.1f} s", flush=True)
    plain = KernelPolicy(impl="torch")
    want = {"prefill": expected_launches(cfg32, "prefill"),
            "decode": expected_launches(cfg32, "decode")}
    max_len = PROMPT_LEN + GEN_STEPS
    totals = dict.fromkeys(want["prefill"], 0)
    variants = {}
    seen = {"fp32": {}, "bf16": {}}

    def counted(label, phase, fn):
        """fn() on the kernel path, the counters zeroed just before and read
        just after; the launches must be the expected ones, every decode
        step's ``pwconv`` launch ``stream`` and every prefill's the
        dtype's wide variant (``tc`` in bf16, ``simt`` in fp32)."""
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize(dev)
        got = launch_counts()
        if got != want[phase]:
            raise AssertionError(f"{label} {phase}: launches {got}, "
                                 f"expected {want[phase]}")
        by = dict(pwconv.launches_by_variant)
        check_variants(label, by, got["pwconv"], label, phase)
        if phase == "prefill" and by[
                "tc" if label == "bf16" else "simt"] != got["pwconv"]:
            raise AssertionError(f"{label} prefill: pwconv by variant {by}")
        seen[label][phase] = by
        for k in totals:
            totals[k] += got[k]
        for k, v in by.items():
            variants[k] = variants.get(k, 0) + v
        return out

    def lead(prompts):
        """The fp32 plain path, free-running greedy: its logits, and the
        (cache, token) each decode step started from."""
        m = models["fp32"]
        reset_launch_counts()
        logits, cache = S.prefill(m, prompts, max_len=max_len, policy=plain)
        outs, steps = [logits], []
        for _ in range(GEN_STEPS):
            tok = greedy(logits)[:, None]
            steps.append((cache, tok))
            logits, cache = S.decode_step(m, cache, tok, policy=plain)
            outs.append(logits)
        if any(launch_counts().values()):
            raise AssertionError(f"the plain path launched {launch_counts()}")
        return outs, steps

    def follow(dtype, prompts, steps, policy=None):
        """The kernel path (or ``policy``'s): prefill, then each decode step
        from the fp32 plain path's cache and token.  Held call by call, the
        error does not compound along the sequence.  Returns the logits and
        the ms of the prefill (host clock, ending in a synchronize)."""
        m = models[dtype]
        call = counted if policy is None else (lambda _l, _p, fn: fn())
        policy = policy or KernelPolicy()
        t0 = time.perf_counter()
        logits, _ = call(dtype, "prefill", lambda: S.prefill(
            m, prompts, max_len=max_len, policy=policy))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = [logits]
        for cache, tok in steps:
            outs.append(call(dtype, "decode", lambda: S.decode_step(
                m, cache, tok, policy=policy))[0])
        return outs, prefill_ms

    def free_run(dtype, prompts, steps):
        """The kernel path on its own cache, fed the plain path's tokens."""
        m = models[dtype]
        logits, cache = S.prefill(m, prompts, max_len=max_len)
        outs = [logits]
        for _, tok in steps:
            logits, cache = S.decode_step(m, cache, tok)
            outs.append(logits)
        return outs

    def errors(got, ref):
        e = [rel_err(a, b) for a, b in zip(got, ref)]
        return {"prefill": e[0], "decode": max(e[1:]), "max": max(e)}

    runs = []
    with torch.inference_mode():
        for batch in (1, 8):
            prompts = torch.randint(
                0, cfg32.vocab_size, (batch, PROMPT_LEN),
                generator=torch.Generator().manual_seed(batch)).to(dev)
            ref, steps = lead(prompts)
            for dtype in ("fp32", "bf16"):
                model = models[dtype]
                torch.cuda.reset_peak_memory_stats(dev)
                got, prefill_ms = follow(dtype, prompts, steps)
                peak = torch.cuda.max_memory_allocated(dev)
                finite = all(bool(torch.isfinite(o).all()) and tuple(
                    o.shape) == (batch, cfg32.vocab_size) for o in got)
                err = errors(got, ref)
                if dtype == "bf16":
                    gated = errors(got, follow("bf16", prompts, steps,
                                               plain)[0])
                    chained = errors(free_run(dtype, prompts, steps), ref)
                else:
                    gated, chained = err, None
                pre = lambda: S.prefill(model, prompts, max_len=max_len)
                cache, tok = steps[-1]
                step = lambda: S.decode_step(model, cache, tok)
                decode_ms = time_ms(step, dev, reps=10, warmup=2)
                # Profiling a prefill (~10^5 device events) costs more than
                # the rest of its cell: once per batch, in fp32 (bf16 runs
                # the same kernels at the same width, PERF.md).
                dev_pre = (device_breakdown(pre, reps=1, warmup=False)
                           if dtype == "fp32" else {})
                dev_dec = device_breakdown(step, reps=5)
                tol = FP32_REL_TOL if dtype == "fp32" else BF16_REL_TOL
                r = {"batch": batch, "dtype": dtype,
                     "prefill_ms": prefill_ms, "decode_ms": decode_ms,
                     "tokens_per_s": batch * 1e3 / decode_ms,
                     "peak_bytes": peak, "prefill_device_ms": dev_pre,
                     "decode_device_ms": dev_dec,
                     "prefill_busy": (sum(dev_pre.values()) / prefill_ms
                                      if dev_pre else None),
                     "decode_busy": sum(dev_dec.values()) / decode_ms,
                     "rel_err_vs_fp32_plain": err,
                     "rel_err_gated": gated, "tol": tol,
                     "rel_err_on_own_cache": chained}
                runs.append(r)
                busy = ("not profiled" if r["prefill_busy"] is None
                        else f"{r['prefill_busy']:.0%}")
                print(f"  xlstm-125m batch {batch} {dtype}: prefill "
                      f"{batch}x{PROMPT_LEN} {prefill_ms:.1f} ms (device busy "
                      f"{busy}), decode {decode_ms:.2f} "
                      f"ms/token (busy {r['decode_busy']:.0%}), "
                      f"{r['tokens_per_s']:.1f} tokens/s, peak "
                      f"{peak / 2**20:.0f} MiB", flush=True)
                print(f"    pwconv by variant: prefill "
                      f"{seen[dtype]['prefill']}, a decode step "
                      f"{seen[dtype]['decode']}", flush=True)
                print(f"    vs {dtype} plain path, each call from the same "
                      f"inputs: prefill {gated['prefill']:.2e}, decode steps "
                      f"{gated['decode']:.2e} (tol {tol:g})", flush=True)
                if dtype == "bf16":
                    print(f"    vs fp32 plain path (not gated): each call "
                          f"from the same inputs: prefill "
                          f"{err['prefill']:.2e}, decode steps "
                          f"{err['decode']:.2e}; on its own cache: decode "
                          f"steps {chained['decode']:.2e}", flush=True)
                print("    device ms per prefill: " + (", ".join(
                    f"{k} {v:.2f}" for k, v in sorted(dev_pre.items()))
                    or "not profiled") + "; per decode step: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in sorted(dev_dec.items())),
                    flush=True)
                if not (finite and gated["max"] <= tol):
                    raise AssertionError(
                        f"xlstm-125m batch {batch} {dtype}: rel err {gated} "
                        f"> {tol} or bad logits (finite and shaped: "
                        f"{finite})")
            del ref, steps

        prompts = torch.randint(
            0, cfg32.vocab_size, (8, STEPPING_PROMPT),
            generator=torch.Generator().manual_seed(64)).to(dev)
        m = models["fp32"]
        lp, cp = S.prefill(m, prompts, max_len=max_len)
        ls, cs = S.prefill_by_stepping(m, prompts, max_len=max_len)
        tok = greedy(lp)[:, None]
        e_pre = rel_err(lp, ls)
        e_next = rel_err(S.decode_step(m, cp, tok)[0],
                         S.decode_step(m, cs, tok)[0])
        print(f"  prefill vs prefill_by_stepping, fp32 8x{STEPPING_PROMPT}: "
              f"rel err {e_pre:.2e}, next decode step {e_next:.2e} (tol "
              f"{FP32_REL_TOL:g})", flush=True)
        if not max(e_pre, e_next) <= FP32_REL_TOL:
            raise AssertionError(f"prefill vs prefill_by_stepping: {e_pre}, "
                                 f"{e_next}")
    return runs, totals, {"prefill": e_pre, "next_step": e_next}, variants


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

    t_phase = time.perf_counter()
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
        for b, length, d, k, rows in (
                (8, 512, 1536, 4, None), (8, 512, 768, 4, None),
                (2, 1000, 1000, 4, 7), (2, 1000, 1002, 4, None),
                (8, 512, 1536, 3, None), (8, 512, 1536, 5, None),
                (8, 1, 1536, 4, None), (8, 2, 768, 4, None)):
            kc.dwconv1d(b, length, d, k, dtype, rows)
        kc.pwconv(4096, 768, 3072, dtype, act=None)
        kc.pwconv(4096, 1536, 1536, dtype, act=None)
        kc.pwconv(1024, 768, 1024, dtype, act="silu")
        kc.pwconv(8, 768, 3072, dtype, act=None)
        # the main path's extremes: V1 block 1 at batch 8, a 14x14 stage at
        # batch 8, V1 block 13 at batch 1, decode at batch 1, the mLSTM gate
        # projection with its bias
        kc.pwconv(8 * 112 * 112, 32, 64, dtype)
        kc.pwconv(8 * 14 * 14, 512, 512, dtype)
        kc.pwconv(49, 1024, 1024, dtype)
        kc.pwconv(1, 768, 3072, dtype, act=None)
        kc.pwconv(8, 1536, 8, dtype, act=None)
    print(f"  ({time.perf_counter() - t_phase:.0f} s)")

    t_phase = time.perf_counter()
    print("main path: execute_network, MobileNet V1/V2, MnasNet-A1 and "
          "EfficientNet-Lite0 at width 1.0, 112x112:")
    runs, launches, variants = run_networks(torch, dev)
    print(f"  ({time.perf_counter() - t_phase:.0f} s)")
    t_phase = time.perf_counter()
    print("serving path: xlstm-125m at full width, prefill + greedy decode:")
    serving, serve_launches, stepping, serve_variants = run_serving(
        torch, dev)
    print(f"  ({time.perf_counter() - t_phase:.0f} s)")
    launches["dwconv1d"] = 0
    for name, n in serve_launches.items():
        launches[name] += n
    for name, n in serve_variants.items():
        variants[name] = variants.get(name, 0) + n
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
    print(f"pwconv launches by variant on the main paths: {variants}")
    for name in ("stream", "tc", "simt"):
        if not variants.get(name):
            raise AssertionError(f"pwconv variant {name} was never launched "
                                 "on the main paths")

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
                       "networks": runs, "serving": serving,
                       "prefill_vs_stepping": stepping, "launches": launches,
                       "pwconv_variants": variants,
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
