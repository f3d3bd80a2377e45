"""Training launcher, one card or a mesh of ranks.  Counterpart of
``repro/launch/train.py``: the mesh is ``make_host_mesh(model=
--model-parallel)`` over the ranks of the launch and the rules
``dryrun.make_rules(mesh, mode="train")`` (FSDP over "data", tensor
parallelism over "model").

    python -m repro_torch.launch.train --arch <id> [--smoke] \\
        [--steps 100] [--seq-len 256] [--global-batch 8] [--lr 3e-4] \\
        [--microbatches 1] [--ckpt-dir DIR] [--ckpt-every 50] \\
        [--compress none|topk|int8] [--seed 0] [--device cuda]

``<id>`` is any id of ``configs.registry.ARCH_IDS``: the attention-MLP
transformers, whisper-small, xlstm-125m and hymba-1.5b all train.  Weights
are random, drawn from ``--seed``; the
data is the synthetic pipeline (``data/pipeline.py``) from ``--seed``; an
encoder-decoder gets one fixed set of encoder frames drawn from
``--seed`` (``launch.serve.frontend_stub``) for every step.  The loop is
the fault-tolerant ``train_loop``: it resumes from the newest committed
checkpoint under ``--ckpt-dir`` (default ``build/repro_torch/ckpt/<arch>``
in the checkout), so a second run of the same command continues the
first.  On the card the step is the reference's jitted, donated step:
one CUDA graph of the whole step (``train_step.capture_train_step``:
loss, backward, compression and AdamW, the state updated in place),
captured once before the loop, whose capture seconds it prints; the
kernels and the embedding's backward run deterministically
(``torch.use_deterministic_algorithms``), as the graph's bits and the
loop's bit-exact recovery need.  It prints ms per step, trained tokens/s,
each rank's peak device memory and the kernel launches of one step
against :func:`expected_train_launches` (on the card the launches the
graph recorded: ``pwconv`` in the forward, the per-layer remat's
recomputed forward and the backward's recomputed pre-activations;
``dwconv1d`` in the forward and the remat, and its backward's two kernels
once each).  ``--device cpu`` runs the eager step
(``train_step.make_train_step``) on the plain PyTorch versions; without a
card the default raises.

Sharded training runs under ``torchrun``, which sets the world in the
environment; ``--model-parallel M`` (default 1) splits the model over M
ranks and the batch over the rest:

    python -m torch.distributed.run --nproc-per-node W \\
        -m repro_torch.launch.train --arch <id> --model-parallel M \\
        [--backend nccl|gloo] [--timeout 120] ...

The attention-MLP families (dense and MoE) train under the mesh: each
rank holds its ``P(data, model)`` block of every weight (gathered over
"data" at its use), its ZeRO-1 block of AdamW's moments, and its rows of
every global batch; the MoE's experts are split over "model" with their
fsdp dimension over "data".  The backend is NCCL on cards (one rank a
card, the step captured as one CUDA graph with its collectives) and gloo
with ``--device cpu``; ``--backend gloo`` on cards runs several ranks on
one card, eager (gloo cannot be captured).  Checkpoints are written whole
by rank 0 and restore under any mesh.  Rank 0 prints, besides, the mesh,
the backend and how its collectives move tensors, the collectives of a
step by op, and the losses.  Outside ``torchrun`` a ``--model-parallel``
above 1 raises.  Still refused: the hymba, xLSTM and encoder-decoder
families and gradient compression under a mesh (ROADMAP.md queue A,
item 4.3.3), and ``--production-mesh`` / ``--multi-pod``, whose 256 / 512
ranks this launcher does not build (ROADMAP.md queue A, item 4.3).
"""
from __future__ import annotations

import argparse
import os
import time

MESH_NOT_PORTED = ("the production meshes (--production-mesh, "
                   "--multi-pod) need worlds of 256 / 512 ranks, which this "
                   "launcher does not build yet: ROADMAP.md queue A, "
                   "item 4.3")


#: The launch counters of a train step (``repro_torch.graphs`` names).
TRAIN_COUNTERS = ("dwconv1d", "dwconv1d_bwd", "pwconv")

#: Linears with an activation a layer has, by variant: each one's backward
#: recomputes its pre-activation with one more ``pwconv`` launch (the
#: MLP's gate; the sLSTM block's FFN gate; none in an mLSTM block).
GATED_LINEARS = {"mlstm": 0, "slstm": 1, "hymba": 1, "attn_mlp": 1,
                 "attn_moe": 0, "dec": 1}


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one microbatch's loss and backward on the card,
    by :data:`TRAIN_COUNTERS`: ``pwconv`` for every Linear of the forward
    (an encoder-decoder's encoder included), again in the per-layer
    remat's recomputed forward (``remat="block"``), and once more for each
    Linear with an activation, whose backward recomputes its
    pre-activation; ``dwconv1d`` for each conv pre-activation (one an
    mLSTM, sLSTM or hymba layer) in the forward and again in the remat,
    and its backward's one kernel once."""
    from repro_torch.launch.serve import (LAYER_LAUNCHES,
                                          SHARED_EXPERT_LAUNCHES)
    from repro_torch.models import transformer as T
    pattern = T.model_pattern(cfg)
    variants = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    if cfg.encdec is not None:
        variants += [T.ENC_VARIANT] * cfg.encdec.n_enc_layers
    passes = 2 if cfg.remat == "block" else 1
    out = dict.fromkeys(TRAIN_COUNTERS, 0)
    for v in variants:
        kind = "attn_moe" if v.use_moe else v.kind
        fwd = dict(LAYER_LAUNCHES["prefill"][kind])
        gates = GATED_LINEARS[kind]
        if v.use_moe and cfg.moe.n_shared:
            fwd["pwconv"] += SHARED_EXPERT_LAUNCHES["pwconv"]
            gates += 1
        out["pwconv"] += passes * fwd["pwconv"] + gates
        out["dwconv1d"] += passes * fwd["dwconv1d"]
        out["dwconv1d_bwd"] += fwd["dwconv1d"]
    return out


def train_launch_counts() -> dict:
    """The launch counters of a train step, by :data:`TRAIN_COUNTERS`."""
    from repro_torch import graphs
    counts = graphs.snapshot()
    return {name: counts[name] for name in TRAIN_COUNTERS}


def deterministic_card() -> None:
    """What bit-exact training on the card needs: cuBLAS's deterministic
    workspace (``CUBLAS_WORKSPACE_CONFIG``, read when cuBLAS starts, so
    called before the first product), deterministic algorithms (the
    embedding's backward is an accumulating ``index_put_``, atomic
    otherwise), and no TF32 or reduced-precision bf16 reductions."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _setup(args):
    """(device, rules, backend or None) of this rank: the process group
    under ``torchrun``, or where a backend is asked for; the host mesh and
    the train rules over it."""
    from repro_torch.core.network import require_device
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import make_rules
    import torch
    launched = "WORLD_SIZE" in os.environ        # under torchrun
    if args.model_parallel > 1 and not launched:
        raise ValueError(
            f"--model-parallel {args.model_parallel} needs a world of ranks:"
            f" launch them with python -m torch.distributed.run "
            f"--nproc-per-node W -m repro_torch.launch.train ...")
    backend = None
    if launched or args.backend:
        backend = args.backend or ("gloo" if torch.device(args.device).type
                                   == "cpu" else "nccl")
        dev = mesh_lib.init_world(backend, args.device,
                                  timeout_s=args.timeout)
    else:
        dev = require_device(args.device)
    mesh = mesh_lib.make_host_mesh(model=args.model_parallel)
    return dev, make_rules(mesh, mode="train", multi_pod=False), backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch.mesh import DEFAULT_TIMEOUT_S
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cards, gloo with --device cpu")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds a rank waits at set-up and in a "
                         "collective")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (and one at the end); "
                         "0 writes none")
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(MESH_NOT_PORTED)

    import torch.distributed as dist

    from repro_torch.sharding.rules import use_rules
    dev, rules, backend = _setup(args)
    try:
        with use_rules(rules):
            return _train(args, dev, rules, backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev, rules, backend) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import (collective_counts, frontend_stub,
                                          reset_launch_counts)
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.sharding import collectives
    from repro_torch.train.train_step import (TrainConfig, state_layout,
                                              step_for_device)
    from repro_torch.train.trainer import LoopConfig, train_loop

    cfg = get_config(args.arch, smoke=args.smoke)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if dev.type == "cuda":
        deterministic_card()
    ckpt_dir = args.ckpt_dir or str(_build.BUILD_DIR / "ckpt" / cfg.name)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5)),
        microbatches=args.microbatches,
        compression=CompressionConfig(kind=args.compress))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=args.seed)
    T.check_mesh(cfg, rules, training=True)
    model = T.init_params(cfg, seed=args.seed, device=dev)
    # gloo cannot be captured: its ranks run the eager step
    use_graph = dev.type == "cuda" and backend in (None, "nccl")
    step_fn, state = step_for_device(model, tcfg, args.global_batch,
                                     args.seq_len, seed=args.seed,
                                     capture=use_graph)
    if use_graph and rank0:
        print(f"[train] {cfg.name}: the step captured as one CUDA graph in "
              f"{step_fn.captured.capture_s:.2f} s")
    frames = (frontend_stub(cfg, args.global_batch, dev, seed=args.seed)
              if cfg.encdec is not None else None)
    per_step = []       # the eager step's launches (a replay counts none)

    def run_step(state, batch):
        if frames is not None:
            batch = dict(batch, frontend=frames)
        if use_graph:
            return step_fn(state, batch)
        reset_launch_counts()
        out = step_fn(state, batch)
        per_step.append(graphs.snapshot())
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, info = train_loop(
        run_step, state, dcfg,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
        ckpt_dir, layout=state_layout(model),
        log=print if rank0 else (lambda _: None))
    wall = time.perf_counter() - t0
    hist = info["history"]
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    peaks = [peak]
    if dist.is_initialized():
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
    if not rank0:
        return 0
    if not hist:
        print(f"[train] nothing to do: {ckpt_dir} holds step {args.steps}")
        return 0
    times = sorted(h["time_s"] for h in hist)
    ms = times[len(times) // 2] * 1e3
    tokens = args.global_batch * args.seq_len
    peak_text = ("not measured on the CPU" if peak is None else
                 ", ".join(f"{p:.2f}" for p in peaks) + " GiB")
    want = {k: n * args.microbatches if dev.type == "cuda" else 0
            for k, n in expected_train_launches(cfg).items()}
    # a replay runs no wrapper: on the card, the launches the graph holds
    counts = step_fn.captured.launches if use_graph else per_step[-1]
    launched = {k: counts.get(k, 0) for k in want}
    mesh = rules.mesh
    group = next((mesh.group(a) for a in mesh.axis_names
                  if mesh.shape[a] > 1), None)
    print(f"[train] mesh {mesh.shape} over "
          f"{dist.get_world_size() if dist.is_initialized() else 1} rank(s)"
          f", backend {backend or 'none (one process)'}, collectives "
          f"{collectives.transport(group, dev)}")
    print(f"[train] {cfg.name} on {dev}: {len(hist)} steps in {wall:.1f} s, "
          f"median {ms:.1f} ms/step = {tokens * 1e3 / ms:.0f} trained "
          f"tokens/s; peak device memory by rank {peak_text}; kernel "
          f"launches a step {launched} (expected {want})")
    recorded = " (the graph recorded)" if use_graph else ""
    print(f"[train] collectives a step{recorded}: "
          f"{collective_counts(counts)}")
    print(f"[train] losses {[h['loss'] for h in hist]}")
    print(f"[train] done: {len(hist)} steps, final loss "
          f"{hist[-1]['loss']:.4f}, stragglers {info['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
