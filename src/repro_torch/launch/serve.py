"""Serving launcher: batched prefill, then greedy (or sampled) decode, on
one card.  Counterpart of ``repro/launch/serve.py`` (no mesh and no
sharding rules: one device).

    python -m repro_torch.launch.serve --arch xlstm-125m [--smoke] \\
        [--batch 4] [--prompt-len 32] [--gen 32] [--max-len 256] \\
        [--temperature 0] [--seed 0] [--device cuda]

Weights are random, drawn from ``--seed``.  It prints the prefill time,
the decode rate, the kernel launches of the prefill and of one decode
step, and the first generated tokens.  It runs on the card unless
``--device cpu`` asks for the plain PyTorch versions, and raises without
a card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.network import require_device
from repro_torch.kernels import dwconv1d, pwconv
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step as S
from repro_torch.serve.sampler import generate, greedy

#: Kernel launches of one layer, by variant: ``pwconv`` runs every Linear,
#: ``dwconv1d`` the conv pre-activation over a sequence (a decode step
#: takes the plain one-row step instead).
LAYER_LAUNCHES = {
    "prefill": {"mlstm": {"dwconv1d": 1, "pwconv": 6},
                "slstm": {"dwconv1d": 1, "pwconv": 4}},
    "decode": {"mlstm": {"dwconv1d": 0, "pwconv": 6},
               "slstm": {"dwconv1d": 0, "pwconv": 4}},
}


def launch_counts() -> dict:
    """The launch counters of the kernels the LM stack runs."""
    return {"dwconv1d": dwconv1d.launches, "pwconv": pwconv.launches}


def reset_launch_counts() -> None:
    dwconv1d.launches = 0
    pwconv.reset_launches()


def expected_launches(cfg: ModelConfig, phase: str) -> dict:
    """Launches of one prefill (``phase="prefill"``) or one decode step
    (``"decode"``) on the card, by kernel."""
    pattern = T.layer_pattern(cfg)
    out = {"dwconv1d": 0, "pwconv": 0}
    for i in range(cfg.n_layers):
        for name, n in LAYER_LAUNCHES[phase][pattern[i % len(pattern)].kind].items():
            out[name] += n
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = T.init_params(cfg, seed=args.seed, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1)).to(dev)
    sampler = torch.Generator(device=dev).manual_seed(2)

    with torch.inference_mode():
        reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = S.prefill(model, prompts, max_len=args.max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_launches = launch_counts()

        first = greedy(logits)[:, None]
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, cache = generate(
            lambda c, t: S.decode_step(model, c, t), cache, first, args.gen,
            sampler, temperature=args.temperature)
        _sync(dev)
        t_gen = time.perf_counter() - t0
        per_step = {k: v / max(args.gen, 1) for k, v in launch_counts().items()}

    tps = args.batch * args.gen / t_gen
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill * 1e3:.1f} ms; generated "
          f"{args.gen} tok/seq in {t_gen * 1e3:.1f} ms = {tps:.1f} tok/s")
    print(f"[serve] kernel launches: prefill {prefill_launches}, per decode "
          f"step {per_step}")
    print("[serve] sample tokens:", toks[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
