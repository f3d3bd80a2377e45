"""Model assembly for the architectures the port runs: xLSTM and hymba so
far.  Counterpart of ``repro/models/transformer.py``.

A config expands to a repeating pattern of layer variants (xLSTM:
``[mLSTM, sLSTM]`` for ``slstm_every=2``; hymba: ``[hymba]``, a
sliding-window attention branch and a Mamba branch side by side, then a
SwiGLU MLP).  Layer ``i`` is variant ``i % period``.  The reference stacks
each variant's parameters along a leading groups axis and scans over the
groups; here :class:`LMModel` holds the layers in order in an
``nn.ModuleList`` and the forward is a Python loop
(``convert.lm_params_from_numpy`` maps layer ``g*period + vi`` to the
reference's ``blocks_v{vi}[g]``).

The ``attn_mlp`` (dense and sliding-window transformer), MoE and enc-dec
branches are not ported: they raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import require_device
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (embed, init_embedding, init_norm,
                                       norm, param, randn)
from repro_torch.models.mlp import MLP

_ATTENTION = ("attention-MLP layers (dense and sliding-window transformers, "
              "MoE, enc-dec) are not ported yet: ROADMAP.md queue A, the "
              "rest of A12")


@dataclasses.dataclass(frozen=True)
class LayerVariant:
    kind: str                      # mlstm | slstm | hymba (| attn_mlp)
    window: Optional[int] = None
    rope: bool = True
    use_moe: bool = False
    sink: int = 0


def layer_pattern(cfg: ModelConfig) -> list:
    if cfg.family == "ssm" and cfg.xlstm is not None:
        every = max(cfg.xlstm.slstm_every, 1)
        return ([LayerVariant(kind="mlstm")] * (every - 1)
                + [LayerVariant(kind="slstm")])
    if cfg.family == "hybrid":
        return [LayerVariant(kind="hymba", window=cfg.sliding_window,
                             sink=cfg.meta_tokens)]
    raise NotImplementedError(_ATTENTION)


# ---------------------------------------------------------------------------
# Single layer: init / forward / cache / decode by variant kind
# ---------------------------------------------------------------------------


class HymbaLayer(nn.Module):
    """The reference's hymba layer dict: ``ln_attn``, ``attn``, ``mamba``,
    ``ln_out_attn``, ``ln_out_mamba``, ``ln_mlp`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        kw = dict(generator=generator, dtype=cfg.torch_dtype, device=device)
        d = cfg.d_model
        self.ln_attn = init_norm(cfg.norm_type, d, device=device)
        self.attn = attn_lib.Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
        self.mamba = ssm_lib.Mamba(d, cfg.ssm, **kw)
        self.ln_out_attn = init_norm("rms", d, device=device)
        self.ln_out_mamba = init_norm("rms", d, device=device)
        self.ln_mlp = init_norm(cfg.norm_type, d, device=device)
        self.mlp = MLP(d, cfg.d_ff, **kw)

    def mix(self, x, attn_out, mamba_out, cfg: ModelConfig, policy):
        """The branches' outputs, each normalized, averaged into the
        residual; then the MLP with its residual."""
        mixed = 0.5 * (norm(attn_out, self.ln_out_attn, "rms")
                       + norm(mamba_out, self.ln_out_mamba, "rms"))
        x = x + mixed
        return x + self.mlp(norm(x, self.ln_mlp, cfg.norm_type),
                            policy=policy)


def init_layer(cfg: ModelConfig, variant: LayerVariant,
               generator: torch.Generator, device="cuda") -> nn.Module:
    kw = dict(generator=generator, dtype=cfg.torch_dtype, device=device)
    if variant.kind == "mlstm":
        return xlstm_lib.MLSTMBlock(cfg.d_model, cfg.n_heads, cfg.xlstm, **kw)
    if variant.kind == "slstm":
        return xlstm_lib.SLSTMBlock(cfg.d_model, cfg.n_heads, cfg.xlstm, **kw)
    if variant.kind == "hymba":
        return HymbaLayer(cfg, generator=generator, device=device)
    raise NotImplementedError(_ATTENTION)


def _attn_kwargs(cfg: ModelConfig, variant: LayerVariant) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, window=variant.window,
                sink=variant.sink,
                rope_theta=cfg.rope_theta if variant.rope else None,
                qk_norm=cfg.qk_norm)


def layer_forward(block: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                  variant: LayerVariant, *,
                  positions: Optional[torch.Tensor] = None,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  capture_kv: bool = False):
    """x (B,S,d) -> (x', aux); with ``capture_kv``, aux["kv"] is the
    attention's (k, v) after RoPE and aux["state"] the recurrent decode
    state (xLSTM: the layer's cache; hymba: the Mamba state)."""
    aux: dict[str, Any] = {}
    if variant.kind == "mlstm":
        res = block(x, chunk=cfg.attn_chunk // 8, policy=policy,
                    return_cache=capture_kv)
    elif variant.kind == "slstm":
        res = block(x, policy=policy, return_cache=capture_kv)
    elif variant.kind == "hymba":
        xn = norm(x, block.ln_attn, cfg.norm_type)
        ares = attn_lib.attention(
            block.attn, xn, positions=positions, chunk=cfg.attn_chunk,
            policy=policy, return_kv=capture_kv, **_attn_kwargs(cfg, variant))
        mres = ssm_lib.mamba_mixer(block.mamba, xn, cfg.ssm, policy=policy,
                                   return_state=capture_kv)
        if capture_kv:
            (ares, aux["kv"]), (mres, aux["state"]) = ares, mres
        return block.mix(x, ares, mres, cfg, policy), aux
    else:
        raise NotImplementedError(_ATTENTION)
    if capture_kv:
        res, aux["state"] = res
    return res, aux


def cache_len(variant: LayerVariant, max_len: int) -> int:
    """Slots of an attention layer's KV cache: a streaming ring of
    ``window + sink`` once ``max_len`` exceeds that, else ``max_len``."""
    if variant.window is not None and max_len > variant.window + variant.sink:
        return variant.window + variant.sink
    return max_len


def init_layer_cache(cfg: ModelConfig, variant: LayerVariant, batch: int,
                     max_len: int, device="cuda") -> dict:
    """A zeroed decode cache for one layer.  The recurrent layers' state
    does not grow with ``max_len``; hymba's is ``{"k", "v", "mamba"}``."""
    if variant.kind == "mlstm":
        return xlstm_lib.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, device)
    if variant.kind == "slstm":
        return xlstm_lib.init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, device)
    if variant.kind != "hymba":
        raise NotImplementedError(_ATTENTION)
    if cfg.kv_quant:
        raise NotImplementedError(attn_lib.KV_QUANT)
    shape = (batch, cache_len(variant, max_len), cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "mamba": ssm_lib.init_mamba_state(batch, cfg.d_model, cfg.ssm,
                                              device)}


def layer_decode(block: nn.Module, x_t: torch.Tensor, cache: dict,
                 pos: torch.Tensor, cfg: ModelConfig, variant: LayerVariant,
                 *, policy: KernelPolicy = DEFAULT_POLICY,
                 in_place: bool = False):
    """x_t (B,1,d), the layer's cache, pos (B,) -> (x_t', cache').
    ``in_place`` writes the new K/V slot into the cache's own tensors
    (``attention_decode``)."""
    if variant.kind in ("mlstm", "slstm"):
        return block.step(x_t, cache, policy=policy)
    if variant.kind != "hymba":
        raise NotImplementedError(_ATTENTION)
    if cfg.kv_quant:
        raise NotImplementedError(attn_lib.KV_QUANT)
    ring = (variant.window is not None
            and cache["k"].shape[1] == variant.window + variant.sink)
    xn = norm(x_t, block.ln_attn, cfg.norm_type)
    attn_out, new_k, new_v = attn_lib.attention_decode(
        block.attn, xn, cache["k"], cache["v"], pos, ring=ring,
        policy=policy, in_place=in_place, **_attn_kwargs(cfg, variant))
    mamba_out, mstate = ssm_lib.mamba_mixer_step(
        block.mamba, xn, cache["mamba"], cfg.ssm, policy=policy)
    return (block.mix(x_t, attn_out, mamba_out, cfg, policy),
            {"k": new_k, "v": new_v, "mamba": mstate})


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


class LMModel(nn.Module):
    """The stack of any pattern the port runs: embedding, the layers in
    order, the final norm, an unembedding table when the embeddings are not
    tied, and the learnable meta tokens (``meta``, (M, d)) when the config
    has them."""

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
        if cfg.meta_tokens:
            self.meta = param(randn(generator, (cfg.meta_tokens, cfg.d_model),
                                    0.02, dt, device))

    def variant(self, i: int) -> LayerVariant:
        return self.pattern[i % len(self.pattern)]

    @property
    def unembed_table(self) -> torch.Tensor:
        p = self.embedding if self.cfg.tie_embeddings else self.unembed
        return p["table"]

    def meta_embeds(self, batch: int) -> torch.Tensor:
        """The meta tokens as a (B, M, d) prefix in the activation dtype."""
        return self.meta[None].expand(batch, -1, -1).to(
            self.cfg.torch_dtype).contiguous()


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> LMModel:
    """A model with random weights drawn from ``generator`` (else a host
    generator seeded with ``seed``), on ``device``: the card unless the
    caller asks for the CPU.  The same seed gives the same weights on every
    device."""
    dev = require_device(device)
    gen = generator or torch.Generator().manual_seed(seed)
    return LMModel(cfg, generator=gen, device=dev)


def cast_params(model: LMModel, cfg: ModelConfig) -> LMModel:
    """A model of ``cfg`` (``model``'s config in another dtype) on
    ``model``'s device holding ``model``'s weights, each cast to its own
    dtype in ``cfg``.  Every init draws in fp32 and casts, so for ``model =
    init_params(cfg32, seed=s)`` this is ``init_params(cfg, seed=s)``
    without drawing the weights a second time."""
    dev = model.embedding["table"].device
    out = LMModel(cfg, generator=torch.Generator(),
                  device="meta").to_empty(device=dev)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(src.pop(name))
    if src:
        raise ValueError(f"parameters {sorted(src)} have no place in {cfg}")
    return out


def hidden_states(model: LMModel, tokens: torch.Tensor, *,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  capture_kv: bool = False):
    """tokens (B, S) -> (hidden (B, P+S, d), prefix_len P, aux): the meta
    tokens, if any, are prepended (P of them) and every position is
    absolute (RoPE).  With ``capture_kv``, ``aux["layers"]`` holds each
    layer's captured ``{"kv"?, "state"}`` (:func:`layer_forward`)."""
    cfg = model.cfg
    b = tokens.shape[0]
    x = embed(model.embedding, tokens)
    prefix = 0
    if cfg.meta_tokens:
        x = torch.cat([model.meta_embeds(b), x], dim=1)
        prefix = cfg.meta_tokens
    total = x.shape[1]
    positions = torch.arange(total, device=x.device)[None].expand(b, total)
    captured = []
    for i, block in enumerate(model.blocks):
        x, a = layer_forward(block, x, cfg, model.variant(i),
                             positions=positions, policy=policy,
                             capture_kv=capture_kv)
        if capture_kv:
            captured.append(a)
    x = norm(x, model.ln_final, cfg.norm_type)
    return x, prefix, ({"layers": captured} if capture_kv else {})
