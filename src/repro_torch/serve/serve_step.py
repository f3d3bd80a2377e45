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
* :func:`decode_step_into` — the static-buffer form of :func:`decode_step`:
  it writes the new state into the cache it was given and the logits into
  a fixed buffer, in place, and runs on any device.
* :func:`capture_decode_step` and :func:`capture_prefill` — the card's
  counterparts of the reference's ``jax.jit`` of the decode step and of
  the prefill (``repro/launch/serve.py:54,62``): each captures its step as
  a CUDA graph once per shape (:func:`repro_torch.graphs.capture`) and
  replays it.  Sampling stays outside the graph.

A cache is ``{"pos": (B,) int32, "layers": [one dict per layer]}``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import graphs
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


def copy_cache_(dst: dict, src: dict) -> dict:
    """Copy every tensor of cache ``src`` into the same place of ``dst``, in
    place; returns ``dst``."""
    dst["pos"].copy_(src["pos"])
    for d, s in zip(dst["layers"], src["layers"], strict=True):
        for k, v in d.items():
            v.copy_(s[k])
    return dst


def _clone_cache(cache: dict) -> dict:
    return {"pos": cache["pos"].clone(),
            "layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in cache["layers"]]}


def decode_step_into(model: T.XLSTMModel, cache: dict, tokens: torch.Tensor,
                     logits: torch.Tensor, *,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """:func:`decode_step` on static buffers: the step's new state (every
    mLSTM ``(c, n, m)``, sLSTM ``(c, n, h, m)`` and conv state, and ``pos``)
    is copied into ``cache``'s own tensors at the end of the step, and its
    logits into ``logits`` (B, V) fp32, in place.  It reads and writes the
    same addresses every call, which is what a CUDA graph of it needs.
    Returns ``(logits, cache)``."""
    new_logits, new_cache = decode_step(model, cache, tokens, policy=policy)
    logits.copy_(new_logits)
    copy_cache_(cache, new_cache)
    return logits, cache


@dataclasses.dataclass
class CapturedDecodeStep:
    """A decode step captured as a CUDA graph, called as
    ``sampler.generate`` calls its step: ``(cache, tokens (B, 1)) ->
    (logits (B, V) fp32, cache)``.  The cache it returns is its own static
    :attr:`cache`, which the next call updates in place; handed that cache,
    a call only replays, handed any other, it first copies it in.  The
    logits are a copy of the graph's buffer.  ``captured`` has the capture
    time and the launches the capture recorded."""
    captured: graphs.Captured
    tokens: torch.Tensor
    cache: dict

    def __call__(self, cache: dict, tokens: torch.Tensor):
        with torch.inference_mode():
            if cache is not self.cache:
                copy_cache_(self.cache, cache)
            self.tokens.copy_(tokens)
            logits, _ = self.captured.replay()
            return logits.clone(), self.cache


def capture_decode_step(model: T.XLSTMModel, batch: int, max_len: int, *,
                        policy: KernelPolicy = DEFAULT_POLICY
                        ) -> CapturedDecodeStep:
    """Capture :func:`decode_step_into` for ``batch`` sequences on the
    model's device, which must be the card; raises on the CPU."""
    dev = model.embedding["table"].device
    cache = init_cache(model.cfg, batch, max_len, dev)
    tokens = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    logits = torch.zeros((batch, model.cfg.vocab_size), device=dev)
    with torch.inference_mode():
        captured = graphs.capture(lambda: decode_step_into(
            model, cache, tokens, logits, policy=policy), dev)
        # the warm-up and the first replay stepped the static cache
        copy_cache_(cache, init_cache(model.cfg, batch, max_len, dev))
    return CapturedDecodeStep(captured, tokens, cache)


@dataclasses.dataclass
class CapturedPrefill:
    """A prefill captured as a CUDA graph for one (batch, prompt length):
    ``tokens (B, S) -> (last logits (B, V), cache)``, both copies of the
    graph's buffers, as :func:`prefill` returns them."""
    captured: graphs.Captured
    tokens: torch.Tensor

    def __call__(self, tokens: torch.Tensor):
        if tokens.shape != self.tokens.shape:
            raise ValueError(f"prefill captured for tokens of shape "
                             f"{tuple(self.tokens.shape)}, got "
                             f"{tuple(tokens.shape)}")
        with torch.inference_mode():
            self.tokens.copy_(tokens)
            logits, cache = self.captured.replay()
            return logits.clone(), _clone_cache(cache)


def capture_prefill(model: T.XLSTMModel, batch: int, prompt_len: int, *,
                    max_len: Optional[int] = None,
                    policy: KernelPolicy = DEFAULT_POLICY) -> CapturedPrefill:
    """Capture :func:`prefill` of ``batch`` prompts of ``prompt_len`` tokens
    on the model's device, which must be the card; raises on the CPU.  The
    sLSTM loop over the prompt is captured with the rest, so the graph holds
    about 20 nodes a token for each sLSTM layer."""
    dev = model.embedding["table"].device
    tokens = torch.zeros((batch, prompt_len), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        captured = graphs.capture(lambda: prefill(
            model, tokens, max_len=max_len or prompt_len, policy=policy), dev)
    return CapturedPrefill(captured, tokens)
