"""Model assembly for every architecture the port runs.  Counterpart of
``repro/models/transformer.py``.

A config expands to a repeating pattern of layer variants (xLSTM:
``[mLSTM, sLSTM]`` for ``slstm_every=2``; hymba: ``[hymba]``, a
sliding-window attention branch and a Mamba branch side by side, then a
SwiGLU MLP; the attention-MLP transformers: a period of
``lcm(global_every, moe_every)`` ``attn_mlp`` layers, e.g. llama4's three
sliding-window layers and one global NoPE layer with MoE on every other
layer, or one layer for a dense model).  Layer ``i`` is variant
``i % period``.  The reference stacks each variant's parameters along a
leading groups axis and scans over the groups; here :class:`LMModel`
holds the layers in order in an ``nn.ModuleList`` and the forward is a
Python loop (``convert.lm_params_from_numpy`` maps layer ``g*period +
vi`` to the reference's ``blocks_v{vi}[g]``).

An ``attn_mlp`` layer is sequential (attention, then the MLP or MoE, each
with its own norm and residual) or, for ``parallel_block`` (command-r),
one shared norm feeding attention and MLP whose outputs join the residual
together.  An encoder-decoder (whisper) stacks ``dec`` layers (causal
self-attention, cross attention to the encoder's output, the MLP) over an
encoder of ``attn_mlp`` layers run bidirectionally on the stubbed frames
(``enc_blocks``, ``enc_ln_final``, ``enc_pos``).

Training: :func:`loss_fn` is the reference's chunked cross-entropy over
the final hidden states (plus the MoE's weighted aux loss) for every
family the reference trains; with ``remat="block"`` every layer (the
mLSTM, sLSTM and hymba layers included) runs under
``torch.utils.checkpoint``, so its activations are recomputed in the
backward, as the reference's ``jax.checkpoint`` does.  The recurrent
layers' gradients go through ``dwconv1d``'s backward kernels, the
differentiable selective scan (``ssm.ChunkScanFn``) and the chunk
checkpoint of the sLSTM loop; hymba's meta tokens get theirs through the
prefix the loss drops.  The checkpoints (the layer's, the sLSTM chunk's,
the loss chunk's) stash no RNG state (``preserve_rng_state=False``): the
forward draws no random numbers, so that is exact, and the captured
train step reads no generator state inside its capture.

Sharded serving (under ``sharding.rules.use_rules`` with a mesh of more
than one rank): :func:`init_params` draws every parameter whole, in the
unsharded order, and keeps the rank's block of it (``param_specs``; a
fused projection part by part, :func:`param_parts`), so a sharded model
holds exactly the unsharded model's values; :func:`hidden_states` takes
the whole batch (and an encoder-decoder's whole frames) and keeps the
rank's rows (``shard_act(tokens, "tokens")``); the layers run
tensor-parallel (``attention.py``, ``mlp.py``, ``layers.py``; hymba's
Mamba branch over its channels, ``ssm.py``; the mLSTM and sLSTM over
their heads, ``xlstm.py``; whisper's encoder and cross attention by head,
its cached K/V by frame) and a MoE layer expert-parallel
(``moe.moe_forward`` with the mesh, :func:`_moe_kwargs`).  The residual
stream stays whole on every rank: hymba's ``mix`` and meta tokens need
no collective.

Sharded training of the attention-MLP families (the train rules: FSDP
over "data", tensor parallelism over "model"): each rank holds its
``P(fsdp, tp)`` block of every weight, gathered over "data" at its use
(``layers.fsdp_gather``), and :func:`loss_fn` takes the whole batch,
keeps the rank's rows and sums the NLL and the token count over the
batch axes, so every rank's loss is the global mean and autograd through
the collectives gives each rank its blocks' gradients
(``sharding/collectives.py``).  Serving with ``serve_weight_fsdp`` runs
the same gathers.  Sequence-parallel activations, and training or FSDP
of the hymba, xLSTM and encoder-decoder layers under a mesh, raise
(ROADMAP.md queue A, item 4.3.3), as do recurrent widths that do not
split whole (:func:`check_mesh`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import require_device
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models import layers
from repro_torch.models.layers import (chunked_cross_entropy, embed,
                                       init_embedding, init_norm, norm,
                                       param, randn, row_linear)
from repro_torch.models.mlp import MLP
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import (active_mesh, batch_groups,
                                        current_rules, local_block,
                                        own_rows, param_specs, shard_act)

@dataclasses.dataclass(frozen=True)
class LayerVariant:
    kind: str                      # attn_mlp | hymba | mlstm | slstm | dec
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
    ge = cfg.global_every if (cfg.global_every and cfg.sliding_window) else 1
    me = cfg.moe_every if cfg.moe is not None else 1
    variants = []
    for i in range(math.lcm(ge, me)):
        is_global = ge > 1 and (i % ge == ge - 1)
        variants.append(LayerVariant(
            kind="attn_mlp",
            window=None if is_global else cfg.sliding_window,
            rope=not (is_global and cfg.nope_on_global),
            use_moe=cfg.moe is not None and (i % me == me - 1),
        ))
    return variants


def model_pattern(cfg: ModelConfig) -> list:
    """The pattern a model of ``cfg`` stacks: :func:`layer_pattern`, or for
    an encoder-decoder one ``dec`` layer (its encoder's layers are
    ``attn_mlp``, :data:`ENC_VARIANT`)."""
    if cfg.encdec is not None:
        return [LayerVariant(kind="dec")]
    return layer_pattern(cfg)


#: The encoder's layers: attention (bidirectional) and the MLP.
ENC_VARIANT = LayerVariant(kind="attn_mlp")


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


class AttnMLPLayer(nn.Module):
    """The reference's attention-MLP layer dict: ``ln_attn``, ``attn``,
    ``ln_mlp`` (absent for ``parallel_block``, whose one norm feeds both
    branches) and ``mlp`` or, on a MoE layer, ``moe``."""

    def __init__(self, cfg: ModelConfig, variant: LayerVariant, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        kw = dict(generator=generator, dtype=cfg.torch_dtype, device=device)
        d = cfg.d_model
        self.ln_attn = init_norm(cfg.norm_type, d, device=device)
        self.attn = attn_lib.Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
        if not cfg.parallel_block:
            self.ln_mlp = init_norm(cfg.norm_type, d, device=device)
        if variant.use_moe:
            self.moe = moe_lib.MoE(d, cfg.moe, cfg.d_ff, **kw)
        else:
            self.mlp = MLP(d, cfg.d_ff, **kw)

    def finish(self, x, xn, attn_out, cfg: ModelConfig,
               variant: LayerVariant, policy):
        """The rest of the layer after its attention: ``(x', aux)``, aux
        holding a MoE layer's ``aux_loss`` and ``drop_frac``."""
        if cfg.parallel_block:      # command-r: shared norm, parallel residual
            return x + attn_out + self.mlp(xn, policy=policy), {}
        x = x + attn_out
        xn2 = norm(x, self.ln_mlp, cfg.norm_type)
        if variant.use_moe:
            y, aux = moe_lib.moe_forward(self.moe, xn2, cfg.moe,
                                         policy=policy, **_moe_kwargs())
            return x + y, aux
        return x + self.mlp(xn2, policy=policy), {}


class DecLayer(nn.Module):
    """The reference's ``dec`` layer dict: ``ln_attn``, ``attn`` (causal
    self-attention), ``ln_cross``, ``cross`` (attention to the encoder's
    output), ``ln_mlp`` and ``mlp``, each with its residual."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        kw = dict(generator=generator, dtype=cfg.torch_dtype, device=device)
        d = cfg.d_model
        self.ln_attn = init_norm(cfg.norm_type, d, device=device)
        self.attn = attn_lib.Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
        self.ln_cross = init_norm(cfg.norm_type, d, device=device)
        self.cross = attn_lib.Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
        self.ln_mlp = init_norm(cfg.norm_type, d, device=device)
        self.mlp = MLP(d, cfg.d_ff, **kw)

    def finish(self, x, cross_out, cfg: ModelConfig, policy):
        """The cross attention's output into the residual, then the MLP
        with its own."""
        x = x + cross_out
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
    if variant.kind == "dec":
        return DecLayer(cfg, generator=generator, device=device)
    return AttnMLPLayer(cfg, variant, generator=generator, device=device)


def _moe_kwargs() -> dict:
    """The mesh a MoE layer runs expert-parallel on, from the rules in
    force (``repro/models/transformer.py:127-132``); none on one rank."""
    r = current_rules()
    if active_mesh(r) is None:
        return dict(mesh=None)
    return dict(mesh=r.mesh, data_axes=r.batch_axes, model_axis=r.model_axis,
                expert_axis=r.expert_fsdp)


#: Layer kinds whose training, and whose weights split over "data", under
#: a mesh are not ported yet (ROADMAP.md queue A, item 4.3.3).
_SERVE_ONLY_KINDS = ("hymba", "mlstm", "slstm", "dec")


def check_mesh(cfg: ModelConfig, rules=None, *,
               training: bool = False) -> None:
    """Raise where ``cfg`` cannot run under the mesh of ``rules`` (default:
    the context's): sequence-parallel activations; a model with a hymba,
    mLSTM, sLSTM or ``dec`` layer with weights split over the fsdp axis,
    or ``training``; and recurrent layers whose channels (the Mamba
    branch's d_inner) or heads (the mLSTM's and sLSTM's) do not split
    whole over the model axis.  The attention-MLP families (dense and
    MoE) serve and train under FSDP and tensor parallelism."""
    r = rules if rules is not None else current_rules()
    if active_mesh(r) is None:
        return
    tp = r.model_size
    if cfg.ssm is not None and (cfg.d_model * cfg.ssm.expand) % tp:
        raise NotImplementedError(
            f"{cfg.name}: the Mamba branch's {cfg.d_model * cfg.ssm.expand} "
            f"channels do not split over {tp} ranks")
    if cfg.xlstm is not None and cfg.n_heads % tp:
        raise NotImplementedError(
            f"{cfg.name}: the xLSTM's {cfg.n_heads} heads do not split over "
            f"{tp} ranks")
    if r.seq_axis is not None:
        raise NotImplementedError(
            "sequence-parallel activations (seq_axis) are not ported to the "
            "layers yet: ROADMAP.md queue A, item 4.3.3")
    kinds = {v.kind for v in model_pattern(cfg)}
    if kinds & set(_SERVE_ONLY_KINDS) and (r.fsdp_size > 1 or training):
        raise NotImplementedError(
            f"{cfg.name}: training and weights split over the fsdp axis "
            f"(FSDP, serve_weight_fsdp) under a mesh are ported for the "
            f"attention-MLP families only, not yet for the hymba, xLSTM "
            f"and encoder-decoder layers: ROADMAP.md queue A, item 4.3.3")


def _attn_kwargs(cfg: ModelConfig, variant: LayerVariant) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, window=variant.window,
                sink=variant.sink,
                rope_theta=cfg.rope_theta if variant.rope else None,
                qk_norm=cfg.qk_norm)


def layer_forward(block: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                  variant: LayerVariant, *,
                  positions: Optional[torch.Tensor] = None,
                  xkv: Optional[torch.Tensor] = None, causal: bool = True,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  capture_kv: bool = False):
    """x (B,S,d) -> (x', aux); with ``capture_kv``, aux["kv"] is the
    attention's (k, v) after RoPE, aux["cross_kv"] a ``dec`` layer's cross
    attention's (k, v) of the encoder's output ``xkv``, and aux["state"]
    the recurrent decode state (xLSTM: the layer's cache; hymba: the Mamba
    state).  A MoE layer's aux also holds its ``aux_loss`` and
    ``drop_frac``.  ``causal=False`` makes the self-attention
    bidirectional (the encoder's)."""
    aux: dict[str, Any] = {}
    if variant.kind == "mlstm":
        res = block(x, chunk=cfg.attn_chunk // 8, policy=policy,
                    return_cache=capture_kv)
    elif variant.kind == "slstm":
        res = block(x, chunk=cfg.attn_chunk // 8, policy=policy,
                    return_cache=capture_kv)
    else:
        kw = dict(chunk=cfg.attn_chunk, policy=policy, return_kv=capture_kv,
                  **_attn_kwargs(cfg, variant))
        xn = norm(x, block.ln_attn, cfg.norm_type)
        ares = attn_lib.attention(block.attn, xn, positions=positions,
                                  causal=causal, **kw)
        if capture_kv:
            ares, aux["kv"] = ares
        if variant.kind == "attn_mlp":
            x, moe_aux = block.finish(x, xn, ares, cfg, variant, policy)
            aux.update(moe_aux)
            return x, aux
        if variant.kind == "dec":
            x = x + ares
            xc = norm(x, block.ln_cross, cfg.norm_type)
            kw.update(window=None, sink=0)
            cres = attn_lib.attention(block.cross, xc, xkv=xkv, **kw)
            if capture_kv:
                cres, aux["cross_kv"] = cres
            return block.finish(x, cres, cfg, policy), aux
        mres = ssm_lib.mamba_mixer(block.mamba, xn, cfg.ssm, policy=policy,
                                   return_state=capture_kv)
        if capture_kv:
            mres, aux["state"] = mres
        return block.mix(x, ares, mres, cfg, policy), aux
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
    does not grow with ``max_len``.  An attention layer's is ``{"k", "v"}``
    (B, S_c, Hkv, dh) in the model's dtype, or with ``kv_quant`` int8 with
    ``{"k_scale", "v_scale"}`` (B, S_c, Hkv) fp32; hymba's adds
    ``"mamba"``."""
    if variant.kind == "mlstm":
        return xlstm_lib.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, device)
    if variant.kind == "slstm":
        return xlstm_lib.init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, device)
    shape = (batch, cache_len(variant, max_len), cfg.n_kv_heads, cfg.head_dim)
    kdtype = torch.int8 if cfg.kv_quant else cfg.torch_dtype
    cache = {"k": torch.zeros(shape, dtype=kdtype, device=device),
             "v": torch.zeros(shape, dtype=kdtype, device=device)}
    if cfg.kv_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], device=device)
    if variant.kind == "hymba":
        cache["mamba"] = ssm_lib.init_mamba_state(batch, cfg.d_model,
                                                  cfg.ssm, device)
    return cache


def layer_decode(block: nn.Module, x_t: torch.Tensor, cache: dict,
                 pos: torch.Tensor, cfg: ModelConfig, variant: LayerVariant,
                 *, enc_kv: Optional[tuple] = None,
                 policy: KernelPolicy = DEFAULT_POLICY,
                 in_place: bool = False, kv_len: Optional[int] = None):
    """x_t (B,1,d), the layer's cache, pos (B,) -> (x_t', cache').
    ``in_place`` writes the new K/V slot (and scales) into the cache's own
    tensors (``attention_decode``). ``kv_len``: the whole cache's slots,
    where the layer's cache holds this rank's block of its sequence. A
    ``dec`` layer's cross attention reads the encoder's K/V ``enc_kv`` =
    (k, v) (B, S_enc, Hkv, dh), unmasked. It projects the token's query
    alone: the reference also projects it through the cross attention's
    ``w_k`` and ``w_v`` and discards both
    (``repro/models/transformer.py:296-299``), which changes no number and
    would cost two ``pwconv`` launches a layer a step."""
    if variant.kind in ("mlstm", "slstm"):
        return block.step(x_t, cache, policy=policy)
    slots = kv_len or cache["k"].shape[1]
    ring = (variant.window is not None
            and slots == variant.window + variant.sink)
    xn = norm(x_t, block.ln_attn, cfg.norm_type)
    scales = (cache["k_scale"], cache["v_scale"]) if cfg.kv_quant else None
    res = attn_lib.attention_decode(
        block.attn, xn, cache["k"], cache["v"], pos, ring=ring,
        scales=scales, policy=policy, in_place=in_place, kv_len=kv_len,
        **_attn_kwargs(cfg, variant))
    attn_out, new = res[0], {"k": res[1], "v": res[2]}
    if cfg.kv_quant:
        new["k_scale"], new["v_scale"] = res[3]
    if variant.kind == "attn_mlp":
        return block.finish(x_t, xn, attn_out, cfg, variant, policy)[0], new
    if variant.kind == "dec":
        x_t = x_t + attn_out
        xc = norm(x_t, block.ln_cross, cfg.norm_type)
        q = attn_lib.project_q(block.cross, xc, cfg.n_heads, cfg.head_dim,
                               qk_norm=cfg.qk_norm, policy=policy)
        cross = attn_lib.cross_decode(q, *enc_kv, cfg.encdec.enc_seq)
        width = cfg.n_heads * cfg.head_dim
        cross = cross.reshape(x_t.shape[0], 1, width).contiguous()
        return block.finish(x_t, row_linear(block.cross.w_o, cross, width,
                                            d_out=cfg.d_model,
                                            policy=policy), cfg, policy), new
    mamba_out, new["mamba"] = ssm_lib.mamba_mixer_step(
        block.mamba, xn, cache["mamba"], cfg.ssm, policy=policy)
    return block.mix(x_t, attn_out, mamba_out, cfg, policy), new


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


class LMModel(nn.Module):
    """The stack of any pattern the port runs: embedding, the layers in
    order, the final norm, an unembedding table when the embeddings are not
    tied, the learnable meta tokens (``meta``, (M, d)) when the config
    has them, and an encoder-decoder's encoder: ``enc_blocks`` (its
    ``attn_mlp`` layers), ``enc_ln_final`` and the frames' positional
    embedding ``enc_pos`` (S_enc, d)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        pattern = model_pattern(cfg)
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
        if cfg.encdec is not None:
            self.enc_blocks = nn.ModuleList(
                init_layer(cfg, ENC_VARIANT, generator, device)
                for _ in range(cfg.encdec.n_enc_layers))
            self.enc_ln_final = init_norm(cfg.norm_type, cfg.d_model,
                                          device=device)
            self.enc_pos = param(randn(
                generator, (cfg.encdec.enc_seq, cfg.d_model), 0.02, dt,
                device))

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


def param_parts(model: nn.Module) -> dict:
    """``{parameter name: parts}`` of the leaves the port cuts part by part
    under a model axis (each module's ``SPLIT_PARTS``: the Mamba's
    ``w_in``, the mLSTM's ``w_up`` and gates, the sLSTM's gates): the last
    dimension is that many equal parts (``[x | z]``, ``[i | f]``, ``[z | i
    | f | o]``), and a rank holds its block of each
    (``rules.local_block(..., parts=)``), so that its channels or heads
    line up across them.  The reference cuts them whole and lets its
    partitioner move the halves; every other leaf is cut as the rules
    say."""
    out = {}
    for prefix, mod in model.named_modules():
        for leaf, n in getattr(mod, "SPLIT_PARTS", {}).items():
            out[f"{prefix}.{leaf}" if prefix else leaf] = n
    return out


def _block_hook(cfg: ModelConfig, rules):
    """A ``layers.param_hook`` that cuts each parameter of an
    ``LMModel(cfg)`` to this rank's block under ``rules``, in the order the
    modules make them (learned from a model made on the meta device)."""
    made = []
    with layers.param_hook(lambda p: made.append(p) or p):
        meta = LMModel(cfg, generator=torch.Generator(), device="meta")
    names = {id(p): n for n, p in meta.named_parameters()}
    specs, parts = param_specs(meta, rules), param_parts(meta)
    order = iter([(specs[names[id(p)]], parts.get(names[id(p)], 1))
                  for p in made])

    def hook(p):
        spec, n = next(order)
        block = local_block(p.data, spec, rules.mesh, parts=n)
        return p if block is p.data else nn.Parameter(block,
                                                      requires_grad=False)
    return hook


def build_model(cfg: ModelConfig, generator: torch.Generator, device,
                rules=None) -> LMModel:
    """``LMModel(cfg)`` drawn from ``generator`` on ``device``; under a mesh
    of more than one rank (``rules``, default the context's) each parameter
    is drawn whole, in the unsharded order, and cut to this rank's block
    as it is made: the device holds the blocks and at most one whole
    parameter at a time."""
    r = rules if rules is not None else current_rules()
    if active_mesh(r) is None:
        return LMModel(cfg, generator=generator, device=device)
    check_mesh(cfg, r)
    with layers.param_hook(_block_hook(cfg, r)):
        return LMModel(cfg, generator=generator, device=device)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device="cuda", rules=None) -> LMModel:
    """A model with random weights drawn from ``generator`` (else a host
    generator seeded with ``seed``), on ``device``: the card unless the
    caller asks for the CPU.  The same seed gives the same weights on every
    device; under a mesh (``rules``, default the context's) each rank holds
    its blocks of those same weights (:func:`build_model`)."""
    dev = require_device(device)
    gen = generator or torch.Generator().manual_seed(seed)
    return build_model(cfg, gen, dev, rules)


def cast_params(model: LMModel, cfg: ModelConfig) -> LMModel:
    """A model of ``cfg`` (``model``'s config in another dtype) on
    ``model``'s device holding ``model``'s weights, each cast to its own
    dtype in ``cfg``.  Every init draws in fp32 and casts, so for ``model =
    init_params(cfg32, seed=s)`` this is ``init_params(cfg, seed=s)``
    without drawing the weights a second time."""
    dev = model.embedding["table"].device
    out = build_model(cfg, torch.Generator(), "meta").to_empty(device=dev)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(src.pop(name))
    if src:
        raise ValueError(f"parameters {sorted(src)} have no place in {cfg}")
    return out


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` (its activations recomputed
    in the backward) when the config asks for per-layer remat and autograd
    records; the reference's ``jax.checkpoint`` of each layer."""
    if cfg.remat != "block" or not torch.is_grad_enabled():
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False, preserve_rng_state=False)


def run_encoder(model: LMModel, frames: torch.Tensor,
                policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """The encoder over stubbed frame embeddings (B, S_enc, d): ``frames +
    enc_pos``, every ``enc_blocks`` layer bidirectional (its attention's
    RoPE at positions ``arange(S_enc)``, as the reference's falls back
    to), then ``enc_ln_final``."""
    cfg = model.cfg
    x = frames + model.enc_pos[None].to(frames.dtype)
    for block in model.enc_blocks:
        def blk(x, block=block):
            return layer_forward(block, x, cfg, ENC_VARIANT, causal=False,
                                 policy=policy)[0]
        x = _maybe_remat(blk, cfg)(x)
    return norm(x, model.enc_ln_final, cfg.norm_type)


def hidden_states(model: LMModel, tokens: torch.Tensor, *,
                  frontend: Optional[torch.Tensor] = None,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  capture_kv: bool = False):
    """tokens (B, S) -> (hidden (B, P+S, d), prefix_len P, aux); under a
    mesh ``tokens`` and ``frontend`` are the whole batch and the hidden
    states this rank's rows of it (B split over "data" where it divides,
    ``batch_pspecs``).  The meta
    tokens, if any, then the stubbed modality embeddings ``frontend`` (B,
    F, d), if given (InternVL2's patches, llama4's fusion embeddings), are
    prepended (P of them in all) and every position is absolute (RoPE).
    An encoder-decoder takes ``frontend`` as the encoder's frames instead
    (no prefix) and returns the encoder's output in ``aux["enc_out"]``.
    ``aux["aux_loss"]`` and ``aux["drop_frac"]`` are the MoE layers' sums
    over the number of layers (0 without MoE); with ``capture_kv``,
    ``aux["layers"]`` holds each layer's captured ``{"kv"?, "cross_kv"?,
    "state"?}`` (:func:`layer_forward`)."""
    cfg = model.cfg
    check_mesh(cfg)
    tokens = shard_act(tokens, "tokens")
    b = tokens.shape[0]
    x = embed(model.embedding, tokens, cfg.vocab_size, cfg.d_model)
    enc_out = None
    pieces = []
    if cfg.encdec is not None:
        if frontend is None:
            raise ValueError("an encoder-decoder model needs encoder frames")
        enc_out = run_encoder(model, shard_act(frontend, "btd").to(x.dtype),
                              policy)
    else:
        if cfg.meta_tokens:
            pieces.append(model.meta_embeds(b))
        if frontend is not None:
            pieces.append(shard_act(frontend, "btd").to(x.dtype))
    prefix = sum(p.shape[1] for p in pieces)
    if pieces:
        x = torch.cat(pieces + [x], dim=1)
    total = x.shape[1]
    positions = torch.arange(total, device=x.device)[None].expand(b, total)
    aux = {k: torch.zeros((), device=x.device)
           for k in ("aux_loss", "drop_frac")}
    captured = []
    for i, block in enumerate(model.blocks):
        def blk(x, block=block, variant=model.variant(i)):
            return layer_forward(block, x, cfg, variant, positions=positions,
                                 xkv=enc_out, policy=policy,
                                 capture_kv=capture_kv)
        x, a = _maybe_remat(blk, cfg)(x)
        if "aux_loss" in a:
            aux = {k: aux[k] + a[k] for k in aux}
        if capture_kv:
            captured.append({k: a[k] for k in ("kv", "cross_kv", "state")
                             if k in a})
    x = norm(x, model.ln_final, cfg.norm_type)
    aux = {k: v / max(cfg.n_layers, 1) for k, v in aux.items()}
    if capture_kv:
        aux["layers"] = captured
    if enc_out is not None:
        aux["enc_out"] = enc_out
    return x, prefix, aux


def loss_fn(model: LMModel, batch: dict, *,
            policy: KernelPolicy = DEFAULT_POLICY):
    """batch: {tokens (B, S), labels (B, S) (-1 ignored) [, frontend]} on
    the model's device -> (loss, metrics): the mean token NLL of the
    hidden states after the prefix, over the tied or untied table, plus
    ``router_aux_weight * aux_loss`` for MoE; metrics ``nll``, ``tokens``,
    ``loss`` [, ``moe_aux``, ``moe_drop``], as the reference's.  Under a
    mesh the batch is the whole one and each rank takes its rows (the
    labels' as the tokens'; rows that do not divide over the batch axes
    are every rank's, each counted in one rank's share of the labels,
    ``rules.own_rows``); the NLL's sum and the token count are summed
    over the batch axes (one ``all_reduce``, the count carrying no
    gradient: ignored labels make the ranks' counts differ), so every
    rank's loss is the global mean, which the reference's ``n_tok`` gives
    under GSPMD (``repro/models/transformer.py:482-501``)."""
    cfg = model.cfg
    check_mesh(cfg, training=torch.is_grad_enabled())
    x, prefix, aux = hidden_states(model, batch["tokens"],
                                   frontend=batch.get("frontend"),
                                   policy=policy)
    x = x[:, prefix:, :]
    labels = own_rows(batch["labels"])
    nll_sum, n_tok = chunked_cross_entropy(
        x, model.unembed_table, labels, chunk=cfg.loss_chunk,
        vocab=cfg.vocab_size)
    for group in batch_groups():
        nll_sum, n_tok = collectives.all_reduce(
            torch.stack([nll_sum, n_tok.detach()]), group).unbind(0)
    loss = nll_sum / torch.clamp(n_tok, min=1.0)
    metrics = {"nll": loss, "tokens": n_tok}
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["aux_loss"]
        metrics["moe_aux"] = aux["aux_loss"]
        metrics["moe_drop"] = aux["drop_frac"]
    metrics["loss"] = loss
    return loss, metrics


def whole_shapes(cfg: ModelConfig) -> dict:
    """``{parameter name: shape}`` of an unsharded ``LMModel(cfg)`` (made on
    the meta device): what the sharding rules' spec functions read."""
    with layers.param_hook(None):
        meta = LMModel(cfg, generator=torch.Generator(), device="meta")
    return {n: tuple(p.shape) for n, p in meta.named_parameters()}
