"""End-to-end training on the port: a ~100M-parameter decoder trained for
a few hundred steps on the synthetic structured corpus, with checkpoints
and the fault-tolerant loop, on the card by default.  Counterpart of
``examples/train_e2e.py``: the same config (``repro-103m``, 12 layers x
768, 12 heads over 4 KV heads, d_ff 2048, a tied 32768-token vocabulary,
fp32, ``loss_chunk`` 128, ``attn_chunk`` 256), the same defaults and the
same last line.

    python -m repro_torch.train_e2e [--steps 300] [--seq-len 128]
        [--global-batch 4] [--ckpt-dir DIR] [--out PATH] [--device cuda]

Weights come from seed 0, the data from seed 11; AdamW at 3e-4 with 20
warmup steps and a cosine over ``--steps``; a checkpoint every 50 steps
under ``--ckpt-dir`` (default ``build/repro_torch/e2e_ckpt`` in the
checkout), from which a rerun resumes.  On the card the step is the
reference's jitted, donated step: one CUDA graph of the whole step
(``train.train_step.capture_train_step``), with deterministic algorithms
on; ``--device cpu`` runs the eager step on the plain PyTorch versions.
The loss history goes to ``--out`` (default
``build/repro_torch/e2e_history.json``), and the last line is the mean
loss of the first 10 and the last 10 steps.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.base import ModelConfig

CONFIG_100M = ModelConfig(
    name="repro-103m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32768,
    tie_embeddings=True,
    dtype="float32",
    loss_chunk=128,
    attn_chunk=256,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.network import require_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.train import deterministic_card
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, step_for_device
    from repro_torch.train.trainer import LoopConfig, train_loop

    dev = require_device(args.device)
    if dev.type == "cuda":
        deterministic_card()
    cfg = CONFIG_100M
    print(f"[e2e] {cfg.name}: {cfg.n_params() / 1e6:.1f}M params "
          "(analytical)")
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=args.steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=11)
    model = T.init_params(cfg, seed=0, device=dev)
    print(f"[e2e] actual params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")
    step, state = step_for_device(model, tcfg, args.global_batch,
                                  args.seq_len)
    if dev.type == "cuda":
        print(f"[e2e] the step captured as one CUDA graph in "
              f"{step.captured.capture_s:.2f} s")
    state, info = train_loop(
        step, state, dcfg,
        LoopConfig(total_steps=args.steps, ckpt_every=50, log_every=10),
        args.ckpt_dir or str(_build.BUILD_DIR / "e2e_ckpt"))
    out = args.out or str(_build.BUILD_DIR / "e2e_history.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(info["history"], f)
    losses = [h["loss"] for h in info["history"]]
    if not losses:
        print(f"[e2e] nothing to do: the checkpoints hold step {args.steps}")
        return 0
    print(f"[e2e] loss: first10={sum(losses[:10]) / len(losses[:10]):.4f} "
          f"last10={sum(losses[-10:]) / len(losses[-10:]):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
