"""The paper's workload on the port: MobileNet V1/V2, MnasNet-A1 and
EfficientNet-Lite0 bodies end to end through ``execute_network``, on the
card by default.

    python -m repro_torch.mobilenet_inference
        [--arch v1|v2|mnasnet|lite0|all]
        [--dtype fp32|bf16] [--res N] [--batch B] [--device cuda|cpu]
        [--unfused]

For each network it prints the plan histogram, the kernel launches of one
forward, ms per forward (CUDA events on the card, median of 10)
with the peak device memory, and the error against the plain path: the
same network with ``impl="torch"`` in fp32 on the same device.  Counterpart
of ``examples/mobilenet_inference.py``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import network
from repro_torch.kernels import (dwconv2d, fused_mbconv, pwconv,
                                 se_epilogue, separable_fused)
from repro_torch.kernels.policy import BF16_STREAM, NATIVE, KernelPolicy
from repro_torch.measure import device_breakdown, rel_err, time_ms

#: bf16-streamed network vs the fp32 plain path: one bf16 rounding per
#: streamed operand per block, compounded over 13-17 blocks (the
#: reference's gate, ``examples/mobilenet_inference.py:43``).
BF16_REL_TOL = 5e-2
#: fp32 kernels vs the fp32 plain path: the same products summed in
#: another order than cuDNN and cuBLAS (or the CPU's) sum them.
FP32_REL_TOL = 1e-4

#: The networks ``--arch`` names.
ARCHS = {"v1": network.mobilenet_v1_spec, "v2": network.mobilenet_v2_spec,
         "mnasnet": network.mnasnet_a1_spec,
         "lite0": network.efficientnet_lite0_spec}

#: Launch counter name -> segment kinds it serves, with the launches one
#: segment makes (a standalone ``se`` runs its two FCs through ``pwconv``;
#: ``mb`` is the plain ``F.conv2d`` and launches none of ours).
KERNEL_SEGMENTS = {"dwconv2d": {"dw": 1}, "pwconv": {"pw": 1, "se": 2},
                   "separable_fused2": {"fused2": 1},
                   "separable_fused3": {"fused3": 1},
                   "fused_mbconv": {"fusedmb": 1}, "dw_se": {"dw_se": 1}}


def expected_launches(histogram: dict) -> dict:
    """Kernel launches one forward of a plan with this segment histogram
    makes, by kernel name."""
    return {name: sum(n * histogram.get(kind, 0) for kind, n in kinds.items())
            for name, kinds in KERNEL_SEGMENTS.items()}


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel name."""
    return {"dwconv2d": dwconv2d.launches, "pwconv": pwconv.launches,
            "separable_fused2": separable_fused.launches["fused2"],
            "separable_fused3": separable_fused.launches["fused3"],
            "fused_mbconv": fused_mbconv.launches,
            "dw_se": se_epilogue.launches}


def reset_launch_counts() -> None:
    dwconv2d.launches = 0
    pwconv.reset_launches()
    fused_mbconv.launches = 0
    se_epilogue.launches = 0
    for k in separable_fused.launches:
        separable_fused.launches[k] = 0


def run_network(net: network.NetworkSpec, *, res: int = 112, batch: int = 1,
                dtype: str = "fp32", fused=None, device="cuda",
                seed: int = 0) -> dict:
    """Drive one network body once, time it and hold it against the fp32
    plain path.  Returns the histogram, the launches of the counted
    forward (and its ``pwconv`` launches by variant), ms, peak memory
    (bytes, card only), the device time by kernel
    (card only, :func:`device_breakdown`) and the error."""
    dev = network.require_device(device)
    params32 = network.init_network(net, seed=seed, device=dev)
    x = torch.randn((batch, res, res, net.c_in),
                    generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    pol = KernelPolicy(fused=fused,
                       dtype_policy=BF16_STREAM if dtype == "bf16" else NATIVE)
    params = (network.cast_network_params(params32, torch.bfloat16)
              if dtype == "bf16" else params32)
    nplan = network.plan_network(net, x.shape, dtype=x.dtype, policy=pol)

    reset_launch_counts()
    y = network.execute_network(net, params, x, policy=pol)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = launch_counts()
    variants = dict(pwconv.launches_by_variant)

    peak = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    def forward():
        return network.execute_network(net, params, x, policy=pol)

    ms = time_ms(forward, dev)
    device = {}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        device = device_breakdown(forward)

    ref = network.execute_network(net, params32, x,
                                  policy=KernelPolicy(impl="torch",
                                                      fused=fused))
    err = rel_err(y, ref)
    ok = bool(torch.isfinite(y.float()).all()) and tuple(y.shape) == \
        nplan.out_shape
    return {"histogram": nplan.segment_histogram(), "launches": launches,
            "pwconv_variants": variants, "ms": ms, "peak_bytes": peak, "device_ms": device,
            "rel_err": err,
            "tol": BF16_REL_TOL if dtype == "bf16" else FP32_REL_TOL,
            "out_shape": tuple(y.shape), "out_dtype": str(y.dtype),
            "finite_and_shaped": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=(*ARCHS, "all"), default="all")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    ap.add_argument("--res", type=int, default=112,
                    help="body input resolution (112 = a 224 image after "
                         "the stem)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unfused", action="store_true",
                    help="plan with KernelPolicy(fused=False)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    nets = [spec() for name, spec in ARCHS.items()
            if args.arch in (name, "all")]
    failed = False
    for net in nets:
        r = run_network(net, res=args.res, batch=args.batch,
                        dtype=args.dtype,
                        fused=False if args.unfused else None,
                        device=args.device)
        histo = ",".join(f"{k}:{v}" for k, v in sorted(r["histogram"].items()))
        clock = "CUDA events" if args.device.startswith("cuda") else "host"
        print(f"{net.name} @{args.res}x{args.res} batch {args.batch} "
              f"{args.dtype} on {args.device}: plan {histo}; launches "
              f"{r['launches']}")
        peak = ("" if r["peak_bytes"] is None
                else f", peak {r['peak_bytes'] / 2**20:.1f} MiB")
        print(f"  {r['ms']:.3f} ms/forward ({clock}, median of "
              f"10){peak}; out {r['out_shape']} {r['out_dtype']}")
        if r["device_ms"]:
            busy = sum(r["device_ms"].values())
            print(f"  device time {busy:.3f} ms/forward "
                  f"({busy / r['ms']:.0%} of the forward): "
                  + ", ".join(f"{k} {v:.3f} ms"
                              for k, v in sorted(r["device_ms"].items())))
        print(f"  vs fp32 plain path: max rel err {r['rel_err']:.2e} "
              f"(tol {r['tol']:g})")
        failed |= not (r["rel_err"] <= r["tol"] and r["finite_and_shaped"])
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
