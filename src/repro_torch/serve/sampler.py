"""Token samplers for the serving loop (counterpart of
``repro/serve/sampler.py``).  Tokens are int64, PyTorch's index type."""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,).  Temperature 0 is greedy; ``top_k``
    keeps the k largest logits (ties with the k-th included).  The
    generator must live on the logits' device."""
    if temperature <= 0.0:
        return greedy(logits)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -float("inf"), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(decode_step_fn, cache, first_tokens: torch.Tensor, n_steps: int,
             generator: Optional[torch.Generator] = None, *,
             temperature: float = 0.0, top_k: int = 0):
    """Batched autoregressive generation.

    decode_step_fn(cache, tokens (B,1)) -> (logits (B,V), cache).
    Returns (tokens (B, n_steps), cache).
    """
    tok, toks = first_tokens, []
    for _ in range(n_steps):
        logits, cache = decode_step_fn(cache, tok)
        nxt = sample(logits, generator, temperature=temperature, top_k=top_k)
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), cache
