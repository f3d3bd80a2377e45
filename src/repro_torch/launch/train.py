"""Training launcher, one card.  Counterpart of ``repro/launch/train.py``
without its mesh: the model, its optimizer state and every batch live on
one device.

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
the process's peak device memory and the kernel launches of one step
against :func:`expected_train_launches` (on the card the launches the
graph recorded: ``pwconv`` in the forward, the per-layer remat's
recomputed forward and the backward's recomputed pre-activations;
``dwconv1d`` in the forward and the remat, and its backward's two kernels
once each).  ``--device cpu`` runs the eager step
(``train_step.make_train_step``) on the plain PyTorch versions; without a
card the default raises.

The reference's ``--model-parallel`` (above 1), ``--production-mesh`` and
``--multi-pod`` shard over a mesh: they raise here, naming ROADMAP.md
queue A item 4.3.
"""
from __future__ import annotations

import argparse
import os
import time

MESH_NOT_PORTED = ("sharding over a mesh (--model-parallel, "
                   "--production-mesh, --multi-pod) is not ported yet: "
                   "ROADMAP.md queue A, item 4.3")


#: The launch counters of a train step (``repro_torch.graphs`` names).
TRAIN_COUNTERS = ("dwconv1d", "dwconv1d_bwd", "dwconv1d_bwd_reduce",
                  "pwconv")

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
    and its backward's two kernels once each."""
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
        out["dwconv1d_bwd_reduce"] += fwd["dwconv1d"]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    from repro_torch.configs.registry import ARCH_IDS
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel != 1 or args.production_mesh or args.multi_pod:
        raise NotImplementedError(MESH_NOT_PORTED)

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.network import require_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import frontend_stub, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.train.train_step import TrainConfig, step_for_device
    from repro_torch.train.trainer import LoopConfig, train_loop

    dev = require_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
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
    model = T.init_params(cfg, seed=args.seed, device=dev)
    step_fn, state = step_for_device(model, tcfg, args.global_batch,
                                     args.seq_len, seed=args.seed)
    if dev.type == "cuda":
        print(f"[train] {cfg.name}: the step captured as one CUDA graph in "
              f"{step_fn.captured.capture_s:.2f} s")
    frames = (frontend_stub(cfg, args.global_batch, dev, seed=args.seed)
              if cfg.encdec is not None else None)
    per_step = []       # the eager step's launches (a replay counts none)

    def run_step(state, batch):
        if frames is not None:
            batch = dict(batch, frontend=frames)
        if dev.type == "cuda":
            return step_fn(state, batch)
        reset_launch_counts()
        out = step_fn(state, batch)
        per_step.append(train_launch_counts())
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, info = train_loop(
        run_step, state, dcfg,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
        ckpt_dir)
    wall = time.perf_counter() - t0
    hist = info["history"]
    if not hist:
        print(f"[train] nothing to do: {ckpt_dir} holds step {args.steps}")
        return 0
    times = sorted(h["time_s"] for h in hist)
    ms = times[len(times) // 2] * 1e3
    tokens = args.global_batch * args.seq_len
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured on the CPU")
    want = {k: n * args.microbatches if dev.type == "cuda" else 0
            for k, n in expected_train_launches(cfg).items()}
    # a replay runs no wrapper: on the card, the launches the graph holds
    launched = ({k: step_fn.captured.launches.get(k, 0) for k in want}
                if dev.type == "cuda" else per_step[-1])
    print(f"[train] {cfg.name} on {dev}: {len(hist)} steps in {wall:.1f} s, "
          f"median {ms:.1f} ms/step = {tokens * 1e3 / ms:.0f} trained "
          f"tokens/s; peak device memory {peak}; kernel launches a step "
          f"{launched} (expected {want})")
    print(f"[train] done: {len(hist)} steps, final loss "
          f"{hist[-1]['loss']:.4f}, stragglers {info['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
