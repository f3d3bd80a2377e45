"""``python -m repro_torch.analysis`` — the static verifier's sweep.

Counterpart of ``python -m repro.analysis``: plans and verifies every
benchmarked geometry of the port (the ``SHAPES`` of
``bench_separable_fused.py``, of ``bench_conv.py`` for ``fused_mbconv``,
``dwconv2d`` and ``dw_se``, and of ``bench_pwconv.py``) under both dtype
policies (native fp32 and bf16 streaming), and the MobileNet V1 and V2,
MnasNet-A1 and EfficientNet-Lite0 network plans at a 112 and a 224 input,
batch 1 and 8, in both dtypes, under the default plan and ``fused=False``;
then prints the diagnostics and exits 1 on any error.  ``--batch`` and
``--res`` restrict the networks to one batch and one resolution;
``--json PATH`` writes the report (sorted keys, trailing newline);
``--no-trace`` skips the trace audit.  Planning takes shapes only, so it
runs on a host with no card (the traces run the plain versions on the
CPU).

RT401 (a problem the runtime quarantine bans) is reported only under
``--degrade`` (``KernelPolicy(on_failure="degrade")``): the port's default
policy reads no quarantine.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from repro_torch import analysis
from repro_torch.analysis.diagnostics import INFO, Diagnostic, Report
from repro_torch.core import chain, network
from repro_torch.kernels.policy import BF16_STREAM, DTYPES, NATIVE, KernelPolicy

#: The networks of the sweep, by the name ``mobilenet_inference`` gives.
NETWORKS = {"v1": network.mobilenet_v1_spec, "v2": network.mobilenet_v2_spec,
            "mnasnet": network.mnasnet_a1_spec,
            "lite0": network.efficientnet_lite0_spec}


def _policies(on_failure: str = "raise") -> dict:
    base = KernelPolicy(on_failure=on_failure)
    return {"fp32": dataclasses.replace(base, dtype_policy=NATIVE),
            "bf16": dataclasses.replace(base, dtype_policy=BF16_STREAM)}


def bench_chains():
    """(label, spec, input shape) of every benchmarked geometry."""
    from repro_torch import bench_conv, bench_pwconv, bench_separable_fused
    out = []
    for b, h, w, ci, c, co, stride, _res, k in bench_separable_fused.SHAPES:
        spec = (chain.inverted_residual_spec(ci, co, expand=c // ci,
                                             stride=stride, hf=k)
                if ci != c else
                chain.separable_block_spec(co, stride=stride, hf=k))
        out.append((f"sep/{b}x{h}x{w}x{ci}x{c}->{co}/k{k}s{stride}", spec,
                    (b, h, w, ci)))
    for b, h, w, ci, c, co, stride, _res in bench_conv.MB_SHAPES:
        out.append((f"mb/{b}x{h}x{w}x{ci}x{c}->{co}/s{stride}",
                    chain.fused_mbconv_spec(ci, co, expand=c // ci,
                                            stride=stride), (b, h, w, ci)))
    for b, h, w, c, stride, k in bench_conv.DW_SHAPES:
        out.append((f"dw/{b}x{h}x{w}x{c}/k{k}s{stride}",
                    chain.SeparableSpec((chain.DW(stride=stride, hf=k,
                                                  wf=k),)), (b, h, w, c)))
    for b, h, w, c, c_se, stride, k in bench_conv.SE_SHAPES:
        out.append((f"dw_se/{b}x{h}x{w}x{c}/se{c_se}/k{k}s{stride}",
                    chain.SeparableSpec((chain.DW(stride=stride, hf=k, wf=k,
                                                  activation="relu"),
                                         chain.SE(c_se))), (b, h, w, c)))
    for g, ci, co, act in bench_pwconv.SHAPES:
        out.append((f"pw/G{g}/{ci}->{co}",
                    chain.SeparableSpec((chain.PW(co, activation=act),)),
                    (g, 1, 1, ci)))
    return out


def quarantine_diagnostic(spec, shape, dtype, pol, label):
    """RT401: the problem is quarantined on this host (``runtime/
    quarantine.py``); the sweep reports it in place of verifying a plan
    the runtime ladder would degrade anyway.  None when not quarantined,
    and always under the default ``on_failure="raise"``, which reads no
    quarantine."""
    if pol.on_failure != "degrade":
        return None
    from repro_torch.runtime import quarantine  # runtime sits above
    banned = quarantine.banned_kinds(spec, shape, dtype, pol, "cpu")
    if not banned:
        return None
    return Diagnostic(
        rule="RT401", severity=INFO, segment=label,
        message=f"plan quarantined on this backend (banned rungs: "
                f"{sorted(banned)}); the runtime ladder degrades it at "
                "execute time: static re-verification skipped",
        hint="inspect or clear the quarantine store "
             "(runtime.quarantine.quarantine_path) to re-verify")


def sweep(batches=(1, 8), resolutions=(112, 224), trace: bool = True,
          verbose: bool = False, on_failure: str = "raise") -> Report:
    report = Report()
    policies = _policies(on_failure)

    def run(label, spec, shape, pol):
        qd = quarantine_diagnostic(spec, shape, torch.float32, pol, label)
        if qd is not None:
            report.extend([qd])
            print(f"  {label:52s} QUARANTINED (RT401)")
            return
        cp = chain.plan(spec, shape, policy=pol, device="cpu")
        r = analysis.analyze_chain(spec, cp, shape, policy=pol, label=label,
                                   trace=trace)
        report.extend(r.diagnostics)
        status = "ok" if r.ok else "FAIL " + ",".join(r.rules("error"))
        print(f"  {label:52s} {status}")
        if verbose and r.diagnostics:
            print(r.format())

    for pname, pol in policies.items():
        print(f"# benchmarked geometries ({pname})")
        for label, spec, shape in bench_chains():
            run(f"{label}/{pname}", spec, shape, pol)
    for pname, pol in policies.items():
        for arch, build in NETWORKS.items():
            net = build()
            for res in resolutions:
                for batch in batches:
                    for fused in (None, False):
                        q = dataclasses.replace(pol, fused=fused)
                        label = (f"network/{arch}/res{res}/b{batch}/{pname}"
                                 + ("/unfused" if fused is False else ""))
                        shape = (batch, res, res, net.c_in)
                        qds = _network_quarantine(net, shape, q, label)
                        if qds:
                            report.extend(qds)
                            print(f"  {label:52s} QUARANTINED ({len(qds)} "
                                  "blocks, RT401)")
                            continue
                        nplan = network.plan_network(net, shape, policy=q,
                                                     device="cpu")
                        r = analysis.analyze_network(net, nplan, policy=q,
                                                     trace=trace)
                        report.extend(r.diagnostics)
                        status = ("ok" if r.ok else
                                  "FAIL " + ",".join(r.rules("error")))
                        print(f"  {label:52s} {status}  ({nplan.n_blocks} "
                              f"blocks, {nplan.n_kernel_passes} passes)")
                        if verbose and r.diagnostics:
                            print(r.format())
    return report


def _network_quarantine(net, shape, pol, label) -> list:
    if pol.on_failure != "degrade":
        return []
    policies = network.resolve_block_policies(net, pol)
    problems, _ = network._block_problems(net, shape, torch.float32,
                                          policies)
    return [qd for i, (spec, (bshape, dt), bp) in enumerate(
                zip(net.blocks, problems, policies))
            for qd in [quarantine_diagnostic(spec, bshape, DTYPES[dt], bp,
                                             f"{label}/block{i}")]
            if qd is not None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static plan and launch verifier over the benchmarked "
                    "geometries and the four bodies' network plans.")
    ap.add_argument("--batch", type=int,
                    help="network plans at this batch only (default 1 and 8)")
    ap.add_argument("--res", type=int,
                    help="network plans at this input resolution only "
                         "(default 112 and 224)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the structured report here")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the (slower) trace audit")
    ap.add_argument("--verbose", action="store_true",
                    help="print every diagnostic, not just failures")
    ap.add_argument("--degrade", action="store_true",
                    help="sweep under KernelPolicy(on_failure='degrade'), "
                         "which reports quarantined problems (RT401)")
    args = ap.parse_args(argv)

    report = sweep(batches=(args.batch,) if args.batch else (1, 8),
                   resolutions=(args.res,) if args.res else (112, 224),
                   trace=not args.no_trace, verbose=args.verbose,
                   on_failure="degrade" if args.degrade else "raise")
    print(report.format(max_lines=None if args.verbose else 40))
    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"report written to {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
