"""Config schema for every architecture of the LM stack.

Counterpart of ``repro/configs/base.py``: the same frozen dataclasses and
fields, with ``torch_dtype`` in place of ``jax_dtype``; the assigned
shape set (``SHAPES``, ``shape_skip_reason``) and ``input_specs``, whose
stand-ins are ``meta``-device tensors where the reference's are
``jax.ShapeDtypeStruct``s.  Each
``configs/<arch>.py`` exports ``CONFIG`` (the exact assigned config) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 2.0
    norm_topk: bool = True       # renormalize top-k router weights
    router_aux_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    conv_k: int = 4
    expand: int = 2
    dt_min: float = 1e-3
    dt_max: float = 1e-1
    chunk: int = 128             # selective-scan time chunk


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 2         # every Nth block is sLSTM (others mLSTM)
    proj_factor: float = 2.0     # mLSTM up-projection
    conv_k: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    enc_seq: int                 # stubbed frontend frames (whisper: 1500)
    enc_bidirectional: bool = True


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None    # None = global attention
    global_every: int = 0        # >0: every Nth layer is global (llama4 iRoPE)
    nope_on_global: bool = False # no RoPE on global layers (llama4)

    # block flavor
    norm_type: str = "rms"       # rms | layer
    parallel_block: bool = False # command-r: attn & mlp in parallel
    tie_embeddings: bool = False
    scan_layers: bool = True     # reference: lax.scan over stacked layers

    # stubs / extras
    fusion_tokens: int = 0       # precomputed frontend embeds prepended (vlm/moe-mm)
    meta_tokens: int = 0         # hymba learnable meta tokens

    moe: Optional[MoEConfig] = None
    moe_every: int = 1           # every Nth layer is MoE (llama4: 2)
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None

    dtype: str = "bfloat16"      # activation/param dtype (fp32 accumulate)
    kv_quant: bool = False       # int8 KV cache (per-vector scales)

    # training-time knobs
    remat: str = "block"         # none | block — checkpoint each layer block
    loss_chunk: int = 512        # chunked cross-entropy sequence chunk
    attn_chunk: int = 1024       # blockwise-attention chunk (q and kv)

    # --- derived -----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True iff long-context decode is O(1)/O(window) per token."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return self.sliding_window is not None and self.global_every == 0
        return False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        """Analytical parameter count (embedding included once if tied)."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.moe is not None:
            ff = 3 * d * self.moe.d_ff_expert
            moe_l = (self.moe.n_experts * ff
                     + self.moe.n_shared * 3 * d * self.d_ff
                     + d * self.moe.n_experts)          # router
            dense_l = 3 * d * self.d_ff
            frac = 1.0 / self.moe_every
            mlp = int(moe_l * frac + dense_l * (1 - frac))
        elif self.d_ff:
            mlp = 3 * d * self.d_ff
        else:
            mlp = 0
        if self.xlstm is not None:
            pf = self.xlstm.proj_factor
            mlp = 0
            attn = int(d * d * pf * 2 + (d * pf) * dh * 3 + d * d * pf)
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            di = d * self.ssm.expand
            ssm_p = d * 2 * di + di * (self.ssm.d_state * 2 + 2) + di * d
            attn = attn + ssm_p if self.family == "hybrid" else ssm_p
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        layers = self.n_layers
        if self.encdec is not None:
            layers += self.encdec.n_enc_layers
            attn = attn * 2  # cross-attention adds a second attn per dec layer
        return layers * (attn + mlp) + emb

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed/shared experts)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        n_moe_layers = self.n_layers // self.moe_every
        all_experts = n_moe_layers * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        active = n_moe_layers * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return full - all_experts + active


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set) + meta-tensor stand-ins
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else reason (recorded in docs)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return (
            "full-attention arch: 500k-token decode needs sub-quadratic "
            "attention (DESIGN.md §Arch-applicability)"
        )
    return None


def _spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the ``meta`` device, which
    holds no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta-tensor stand-ins for every model input of this cell, with the
    reference's shapes and dtypes (tokens int32).

    Training: {tokens, labels [, frontend]}.
    Prefill:  {tokens [, frontend]}.
    Decode:   {tokens (B,1), pos (B,)} — the KV cache is built separately
              (``serve_step.cache_specs``; it is carried state, not an
              input here).
    """
    meta = SHAPES[shape]
    b, s = meta["global_batch"], meta["seq_len"]
    i32 = torch.int32
    act = cfg.torch_dtype
    if meta["kind"] == "train":
        specs = {"tokens": _spec((b, s), i32), "labels": _spec((b, s), i32)}
        if cfg.family in ("vlm",) or (cfg.fusion_tokens
                                      and cfg.family == "moe"):
            specs["frontend"] = _spec((b, cfg.fusion_tokens, cfg.d_model),
                                      act)
        if cfg.encdec is not None:
            specs["frontend"] = _spec((b, cfg.encdec.enc_seq, cfg.d_model),
                                      act)
        return specs
    if meta["kind"] == "prefill":
        specs = {"tokens": _spec((b, s), i32)}
        if cfg.fusion_tokens:
            specs["frontend"] = _spec((b, cfg.fusion_tokens, cfg.d_model),
                                      act)
        if cfg.encdec is not None:
            specs["frontend"] = _spec((b, cfg.encdec.enc_seq, cfg.d_model),
                                      act)
        return specs
    # decode: one new token against a cache of seq_len
    return {"tokens": _spec((b, 1), i32), "pos": _spec((b,), i32)}
