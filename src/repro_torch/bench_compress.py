"""The gradient compressors' device memory and time on a rank's blocks
(``optim/compress.py``), under a mesh of ``torchrun``'s ranks.

    python -m torch.distributed.run --nproc-per-node 4 \\
        src/repro_torch/bench_compress.py [--arch qwen3-1.7b] \\
        [--model-parallel 1] [--backend gloo|nccl] [--kinds topk,int8]

Each rank draws its blocks of the model's parameters at published widths
(``init_params`` under the train rules, ``--n-layers`` to cut the depth),
random fp32 gradients of them and zeroed errors, then runs ``compress_``
(the train step's form) with the layout and the reference's stacks of the
layers, once to warm up and ``--reps`` times more.  One JSON line a kind,
from rank 0, with every rank's: the entries of its blocks, its largest
leaf's, the bytes of the gradients and errors it was given, the peak of
device memory above them in one call (``torch.cuda.max_memory_allocated``)
and, of that, the compressed gradients it returns (the rest is the
compressor's temporaries), and the median ms of a call (synchronized; under
gloo the collectives go through host copies, and several ranks may share a
card, so time only under NCCL means the card's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import make_rules
from repro_torch.models.transformer import init_params, param_stacks
from repro_torch.optim.compress import CompressionConfig, compress_
from repro_torch.sharding.rules import use_rules
from repro_torch.train.train_step import state_layout


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def measure(grads: dict, err: dict, kind: str, layout, stacks, reps: int,
            dev) -> dict:
    """One rank's figures of ``compress_`` of ``kind`` (see the module's
    docstring); ``err`` is written in place, as the step writes it."""
    cfg = CompressionConfig(kind=kind)
    cuda = dev.type == "cuda"

    def call():
        return compress_(grads, err, cfg, key=7, layout=layout,
                         stacks=stacks)
    call()                                       # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = call()
    peak = out_bytes = None
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        out_bytes = _nbytes(out)
    del out
    ms = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        call()
        if cuda:
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    largest = max(grads, key=lambda n: grads[n].numel())
    return {"entries": sum(g.numel() for g in grads.values()),
            "largest_leaf": largest,
            "largest_entries": grads[largest].numel(),
            "input_bytes": _nbytes(grads) + _nbytes(err),
            "peak_above_inputs_bytes": peak,
            "output_bytes": out_bytes,
            "temporaries_bytes": None if peak is None else peak - out_bytes,
            "ms": statistics.median(ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a check on the CPU)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kinds", default="topk,int8")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = mesh_lib.init_world(args.backend, args.device)
    try:
        mesh = mesh_lib.make_host_mesh(model=args.model_parallel)
        rules = make_rules(mesh, mode="train", multi_pod=False)
        cfg = get_config(args.arch, smoke=args.smoke)
        if args.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
        with use_rules(rules):
            model = init_params(cfg, generator=torch.Generator(
                dev).manual_seed(0), device=dev)
            layout = state_layout(model)
            stacks = param_stacks(model)
            gen = torch.Generator(dev).manual_seed(1 + dist.get_rank())
            grads = {n: torch.randn(p.shape, generator=gen, device=dev)
                     for n, p in model.named_parameters()}
            del model
            err = {n: torch.zeros_like(g) for n, g in grads.items()}
            for kind in args.kinds.split(","):
                mine = measure(grads, err, kind, layout, stacks, args.reps,
                               dev)
                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, mine)
                if dist.get_rank() == 0:
                    print(json.dumps({
                        "arch": args.arch, "layers": cfg.n_layers,
                        "mesh": mesh.shape, "backend": args.backend,
                        "kind": kind, "ranks": every}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
