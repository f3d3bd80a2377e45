"""Model assembly for the architectures the port runs: xLSTM so far.
Counterpart of the xLSTM parts of ``repro/models/transformer.py``.

A config expands to a repeating pattern of layer variants (xLSTM:
``[mLSTM, sLSTM]`` for ``slstm_every=2``).  Layer ``i`` is variant
``i % period``.  The reference stacks each variant's parameters along a
leading groups axis and scans over the groups; here :class:`XLSTMModel`
holds the layers in order in an ``nn.ModuleList`` and the forward is a
Python loop (``convert.lm_params_from_numpy`` maps layer ``g*period + vi``
to the reference's ``blocks_v{vi}[g]``).

The attention, hymba, MoE and enc-dec branches are not ported: they raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import require_device
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import embed, init_embedding, init_norm, norm

_ATTENTION = ("attention layers (dense, sliding-window, MoE, enc-dec) are "
              "not ported yet: ROADMAP.md queue A, the rest of A12")
_HYMBA = ("hymba layers (attention + Mamba heads) are not ported yet: "
          "ROADMAP.md queue A, hymba-1.5b")


@dataclasses.dataclass(frozen=True)
class LayerVariant:
    """One layer kind: ``mlstm`` | ``slstm`` (the reference's attention
    kinds and their window / RoPE / MoE fields come with their slice)."""
    kind: str


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(_HYMBA if kind == "hymba" else _ATTENTION)


def layer_pattern(cfg: ModelConfig) -> list:
    if cfg.family == "ssm" and cfg.xlstm is not None:
        every = max(cfg.xlstm.slstm_every, 1)
        return ([LayerVariant(kind="mlstm")] * (every - 1)
                + [LayerVariant(kind="slstm")])
    raise _not_ported("hymba" if cfg.family == "hybrid" else "attn_mlp")


# ---------------------------------------------------------------------------
# Single layer: init / forward / cache / decode by variant kind
# ---------------------------------------------------------------------------


def init_layer(cfg: ModelConfig, variant: LayerVariant,
               generator: torch.Generator, device="cuda") -> nn.Module:
    kw = dict(generator=generator, dtype=cfg.torch_dtype, device=device)
    if variant.kind == "mlstm":
        return xlstm_lib.MLSTMBlock(cfg.d_model, cfg.n_heads, cfg.xlstm, **kw)
    if variant.kind == "slstm":
        return xlstm_lib.SLSTMBlock(cfg.d_model, cfg.n_heads, cfg.xlstm, **kw)
    raise _not_ported(variant.kind)


def layer_forward(block: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                  variant: LayerVariant, *,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  capture_kv: bool = False):
    """x (B,S,d) -> (x', aux); aux["state"] is the layer's decode cache
    when ``capture_kv``."""
    aux: dict[str, Any] = {}
    if variant.kind == "mlstm":
        res = block(x, chunk=cfg.attn_chunk // 8, policy=policy,
                    return_cache=capture_kv)
    elif variant.kind == "slstm":
        res = block(x, policy=policy, return_cache=capture_kv)
    else:
        raise _not_ported(variant.kind)
    if capture_kv:
        res, aux["state"] = res
    return res, aux


def init_layer_cache(cfg: ModelConfig, variant: LayerVariant, batch: int,
                     max_len: int, device="cuda") -> dict:
    """A zeroed decode cache for one layer.  The recurrent layers' state
    does not grow with ``max_len``."""
    if variant.kind == "mlstm":
        return xlstm_lib.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, device)
    if variant.kind == "slstm":
        return xlstm_lib.init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, device)
    raise _not_ported(variant.kind)


def layer_decode(block: nn.Module, x_t: torch.Tensor, cache: dict,
                 variant: LayerVariant, *,
                 policy: KernelPolicy = DEFAULT_POLICY):
    """x_t (B,1,d), the layer's cache -> (x_t', cache').  (The reference's
    position and config arguments serve its attention layers.)"""
    if variant.kind in ("mlstm", "slstm"):
        return block.step(x_t, cache, policy=policy)
    raise _not_ported(variant.kind)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


class XLSTMModel(nn.Module):
    """The stack: embedding, the layers in order, the final norm (and an
    unembedding table when the embeddings are not tied)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        pattern = layer_pattern(cfg)
        if cfg.n_layers % len(pattern):
            raise ValueError(f"{cfg.n_layers} layers do not divide into the "
                             f"pattern of {len(pattern)}")
        self.cfg, self.pattern = cfg, pattern
        dt = cfg.torch_dtype
        self.embedding = init_embedding(generator, cfg.vocab_size,
                                        cfg.d_model, dtype=dt, device=device)
        self.ln_final = init_norm(cfg.norm_type, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = init_embedding(generator, cfg.vocab_size,
                                          cfg.d_model, dtype=dt,
                                          device=device)
        self.blocks = nn.ModuleList(
            init_layer(cfg, self.variant(i), generator, device)
            for i in range(cfg.n_layers))

    def variant(self, i: int) -> LayerVariant:
        return self.pattern[i % len(self.pattern)]

    @property
    def unembed_table(self) -> torch.Tensor:
        p = self.embedding if self.cfg.tie_embeddings else self.unembed
        return p["table"]


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> XLSTMModel:
    """A model with random weights drawn from ``generator`` (else a host
    generator seeded with ``seed``), on ``device``: the card unless the
    caller asks for the CPU.  The same seed gives the same weights on every
    device."""
    dev = require_device(device)
    gen = generator or torch.Generator().manual_seed(seed)
    return XLSTMModel(cfg, generator=gen, device=dev)


def hidden_states(model: XLSTMModel, tokens: torch.Tensor, *,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  capture_kv: bool = False):
    """tokens (B, S) -> (hidden (B, S, d), prefix_len 0, aux).  With
    ``capture_kv``, ``aux["states"]`` holds each layer's decode cache."""
    cfg = model.cfg
    x = embed(model.embedding, tokens)
    states = []
    for i, block in enumerate(model.blocks):
        x, a = layer_forward(block, x, cfg, model.variant(i), policy=policy,
                             capture_kv=capture_kv)
        if capture_kv:
            states.append(a["state"])
    x = norm(x, model.ln_final, cfg.norm_type)
    return x, 0, ({"states": states} if capture_kv else {})
