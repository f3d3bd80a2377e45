"""Config schema for every architecture of the LM stack.

Counterpart of ``repro/configs/base.py``: the same frozen dataclasses and
fields, with ``torch_dtype`` in place of ``jax_dtype``.  The TPU dry run's
``SHAPES`` and ``input_specs`` are not carried.  Each
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
