"""Serving: cache construction, prefill, and the one-token decode step.
Counterpart of ``repro/serve/serve_step.py`` for the recurrent (xLSTM)
layers; the attention branches (KV capture, ``_ring_fill``) wait for the
attention slice.

* :func:`prefill` — one full forward with per-layer state capture: the
  mLSTM ``(c, n, m)`` state carried out of the chunkwise scan, the sLSTM
  ``(c, n, h, m)`` state out of its loop, and each layer's conv state (the
  last K-1 pre-conv inputs).
* :func:`decode_step` — one token through every layer with its cache.
* :func:`prefill_by_stepping` — a loop of decode steps over the prompt;
  the oracle for :func:`prefill`.

A cache is ``{"pos": (B,) int32, "layers": [one dict per layer]}``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import transformer as T
from repro_torch.models.layers import embed, norm, unembed_logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed cache.  ``max_len`` bounds attention caches; the recurrent
    layers' state does not depend on it."""
    pattern = T.layer_pattern(cfg)
    return {"pos": torch.zeros(batch, dtype=torch.int32, device=device),
            "layers": [T.init_layer_cache(cfg, pattern[i % len(pattern)],
                                          batch, max_len, device)
                       for i in range(cfg.n_layers)]}


def decode_step(model: T.XLSTMModel, cache: dict, tokens: torch.Tensor, *,
                policy: KernelPolicy = DEFAULT_POLICY):
    """tokens (B, 1) -> (logits (B, V) fp32, new cache)."""
    x = embed(model.embedding, tokens)                  # (B,1,d)
    layers = []
    for i, block in enumerate(model.blocks):
        x, c = T.layer_decode(block, x, cache["layers"][i], model.variant(i),
                              policy=policy)
        layers.append(c)
    x = norm(x, model.ln_final, model.cfg.norm_type)
    logits = unembed_logits(x[:, 0], model.unembed_table)
    return logits, {"pos": cache["pos"] + 1, "layers": layers}


def prefill(model: T.XLSTMModel, tokens: torch.Tensor, *, max_len: int,
            policy: KernelPolicy = DEFAULT_POLICY):
    """tokens (B, S) -> (last logits (B, V), cache primed to pos = S)."""
    b, s = tokens.shape
    x, prefix, aux = T.hidden_states(model, tokens, policy=policy,
                                     capture_kv=True)
    cache = {"pos": torch.full((b,), prefix + s, dtype=torch.int32,
                               device=tokens.device),
             "layers": aux["states"]}
    return unembed_logits(x[:, -1], model.unembed_table), cache


def prefill_by_stepping(model: T.XLSTMModel, tokens: torch.Tensor, *,
                        max_len: int,
                        policy: KernelPolicy = DEFAULT_POLICY):
    """Reference prefill: one decode step per prompt token."""
    b, s = tokens.shape
    cache = init_cache(model.cfg, b, max_len, tokens.device)
    logits = torch.zeros((b, model.cfg.vocab_size), device=tokens.device)
    for t in range(s):
        logits, cache = decode_step(model, cache, tokens[:, t:t + 1],
                                    policy=policy)
    return logits, cache
