"""Serving: cache construction, prefill, and the one-token decode step.
Counterpart of ``repro/serve/serve_step.py`` for the recurrent (xLSTM),
hybrid (hymba), attention-MLP (dense, VLM, MoE) and encoder-decoder
(whisper) models.

* :func:`prefill` — one full forward with per-layer state capture: the
  mLSTM ``(c, n, m)`` state carried out of the chunkwise scan, the sLSTM
  ``(c, n, h, m)`` state out of its loop, the Mamba ``(h, conv)`` state
  out of its chunked scan, each conv state (the last K-1 pre-conv inputs),
  and every attention layer's K/V (after RoPE) written into its cache by
  :func:`_ring_fill`; an encoder-decoder's prefill also runs the encoder
  and keeps each ``dec`` layer's cross attention K/V of its output.
  Under ``kv_quant`` each captured K/V vector is
  first quantized to int8 with its scale (``attention._quantize_vec``),
  which is what a decode step writes for it.  This departs from the
  reference, whose ``prefill`` casts the captured K/V straight to int8 and
  leaves the scales at zero (``repro/serve/serve_step.py:163-164``), so
  that its prefilled slots read back as zero: here the prefilled cache is
  what the reference's ``prefill_by_stepping`` writes.
* :func:`decode_step` — one token through every layer with its cache.
* :func:`prefill_by_stepping` — a loop of decode steps over the prompt,
  after the meta tokens primed the cache; the oracle for :func:`prefill`.
* :func:`decode_step_into` — the static-buffer form of :func:`decode_step`:
  it writes the new state into the cache it was given (each K/V slot in
  place, the rest copied at the end of the step) and the logits into a
  fixed buffer, and runs on any device.
* :func:`capture_decode_step` and :func:`capture_prefill` — the card's
  counterparts of the reference's ``jax.jit`` of the decode step and of
  the prefill (``repro/launch/serve.py:54,62``): each captures its step as
  a CUDA graph once per shape (:func:`repro_torch.graphs.capture`) and
  replays it.  Sampling stays outside the graph.

A cache is ``{"pos": (B,) int32, "layers": [one dict per layer]}``; an
attention layer's dict is ``{"k", "v": (B, S_c, Hkv, dh)}`` (int8 with
``"k_scale", "v_scale": (B, S_c, Hkv)`` fp32 under ``kv_quant``), a hymba
layer's adds ``"mamba": {"h", "conv"}``; S_c is the ring of ``window +
sink`` slots once ``max_len`` exceeds it (``transformer.cache_len``).
``max_len`` counts the prefix: the meta tokens and the frontend's
embeddings.  An encoder-decoder's cache adds ``"enc_k", "enc_v":
(n_layers, B, S_enc, Hkv, dh)`` in the model's dtype (never int8, also
under ``kv_quant``): written once by the prefill and only read by the
decode steps, which pass them on as they are.

Under a mesh (``sharding.rules.use_rules``) every rank runs these with
its blocks of the model: the tokens (and a frontend, or an
encoder-decoder's frames) come in whole and the logits go out whole on
every rank (the vocab blocks gathered over "model", the batch over
"data"), while each rank's cache holds its blocks, with the shapes
:func:`cache_layout` gives them: its batch rows, its block of each KV
cache's slots and of the encoder's frames where their number divides the
model axis (``cache_pspecs``, the reference's specs: flash-decoding), and
its block of each recurrent state: the Mamba state's and conv state's
channels, the mLSTM's and sLSTM's heads and their conv state's channels.
That last departs from the reference, which keeps the recurrent states
replicated: the port's layers run on the rank's channels and heads, so a
replicated state would need gathering every token.  A decode step of a
model with KV caches then needs ``max_len``, which says how many slots
the whole cache has.  The same functions, and the captures, run the
collectives; under NCCL a capture records them (their outputs are fresh
tensors of the capture's pool, and the static buffers are the cache's
blocks, which :func:`decode_step_into` writes at the same addresses).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models import transformer as T
from repro_torch.models.attention import _quantize_vec
from repro_torch.models.layers import embed, norm, unembed_logits
from repro_torch.sharding.rules import (P, act_spec, active_mesh,
                                        cache_pspecs, current_rules,
                                        gather_block, local_block,
                                        local_shape, model_shard, shard_act)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed cache.  ``max_len`` (the prefix included) bounds the
    attention caches; the recurrent layers' state does not depend on it.
    Under a mesh, this rank's blocks of the cache of ``batch`` sequences
    (:func:`cache_layout`)."""
    r = current_rules()
    if active_mesh(r) is not None:
        whole = _init_cache(cfg, batch, max_len, "meta")
        return _zeros_like_blocks(whole, cache_layout(whole, r), r.mesh,
                                  device)
    return _init_cache(cfg, batch, max_len, device)


#: The recurrent states' split dimension (after the batch) by leaf name:
#: the mLSTM's (c, n, m) and the sLSTM's (c, n, h, m) by head, every conv
#: state by channel; the Mamba state's h (B, d_inner, N) by channel.
_STATE_DIMS = {"c": 1, "n": 1, "m": 1, "h": 1, "conv": 2}


def cache_layout(cache, rules):
    """The port's specs of a whole cache under ``rules``:
    ``cache_pspecs`` (the reference's), with each recurrent state split
    over the model axis where its heads or channels divide: an xLSTM
    layer's leaves and a hymba layer's ``"mamba"`` state
    (:data:`_STATE_DIMS`)."""
    specs = cache_pspecs(cache, rules)
    tp = rules.model_axis
    if tp is None or rules.model_size == 1:
        return specs

    def split(leaf, spec, dim):
        if leaf.shape[dim] % rules.model_size:
            return spec
        return P(*spec[:dim], tp, *spec[dim + 1:])

    def states(layer, spec):
        return {k: split(v, spec[k], _STATE_DIMS[k]) for k, v in
                layer.items()}

    for i, layer in enumerate(cache["layers"]):
        if "mamba" in layer:
            specs["layers"][i]["mamba"] = states(layer["mamba"],
                                                 specs["layers"][i]["mamba"])
        elif "k" not in layer:                  # an mLSTM or sLSTM layer
            specs["layers"][i] = states(layer, specs["layers"][i])
    return specs


def _zeros_like_blocks(tree, specs, mesh, device):
    if isinstance(tree, dict):
        return {k: _zeros_like_blocks(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_blocks(v, sp, mesh, device)
                for v, sp in zip(tree, specs, strict=True)]
    return torch.zeros(local_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype, device=device)


def _init_cache(cfg: ModelConfig, batch: int, max_len: int,
                device) -> dict:
    pattern = T.model_pattern(cfg)
    cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=device),
             "layers": [T.init_layer_cache(cfg, pattern[i % len(pattern)],
                                           batch, max_len, device)
                        for i in range(cfg.n_layers)]}
    if cfg.encdec is not None:
        shape = (cfg.n_layers, batch, cfg.encdec.enc_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        for name in ("enc_k", "enc_v"):
            cache[name] = torch.zeros(shape, dtype=cfg.torch_dtype,
                                      device=device)
    return cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache's shapes and dtypes as ``meta``-device tensors (the
    reference's ``jax.eval_shape`` of ``init_cache``)."""
    return init_cache(cfg, batch, max_len, device="meta")


def _kv_lens(model: T.LMModel, max_len: Optional[int]) -> list:
    """Each layer's whole cache length where the caches may hold a block
    of their slots (a model axis of more than one rank), else None."""
    if model_shard()[0] == 1 or all(
            v.kind in ("mlstm", "slstm") for v in model.pattern):
        return [None] * len(model.blocks)
    if max_len is None:
        raise ValueError("a decode step on a model split over the model "
                         "axis needs max_len: the caches hold blocks of "
                         "their slots")
    return [T.cache_len(model.variant(i), max_len)
            for i in range(len(model.blocks))]


def _whole_batch(t: torch.Tensor, batch: int) -> torch.Tensor:
    """``t`` (b, ...) this rank's rows of ``batch``: every rank's rows,
    gathered over the batch axes where the batch was split."""
    if t.shape[0] == batch:
        return t
    r = current_rules()
    return gather_block(t, P(r.batch_axes, *[None] * (t.dim() - 1)), r.mesh)


def _layers_step(model: T.LMModel, cache: dict, x: torch.Tensor,
                 policy: KernelPolicy, in_place: bool = False,
                 max_len: Optional[int] = None):
    """x (B,1,d) through every layer at ``cache["pos"]`` -> (x', new
    cache at pos + 1).  The encoder's K/V pass through unchanged."""
    pos = cache["pos"]
    layers = []
    enc = {k: cache[k] for k in ("enc_k", "enc_v") if k in cache}
    for i, (block, kv_len) in enumerate(zip(model.blocks,
                                            _kv_lens(model, max_len))):
        x, c = T.layer_decode(block, x, cache["layers"][i], pos, model.cfg,
                              model.variant(i), policy=policy,
                              in_place=in_place, kv_len=kv_len,
                              enc_kv=(enc["enc_k"][i], enc["enc_v"][i])
                              if enc else None)
        layers.append(c)
    return x, {"pos": pos + 1, "layers": layers, **enc}


def decode_step(model: T.LMModel, cache: dict, tokens: torch.Tensor, *,
                policy: KernelPolicy = DEFAULT_POLICY,
                in_place: bool = False, max_len: Optional[int] = None):
    """tokens (B, 1) -> (logits (B, V) fp32, new cache).  ``in_place``
    writes each attention layer's new K/V into ``cache``'s own tensors,
    which the new cache then shares (:func:`decode_step_into`).  Under a
    mesh ``max_len`` is the cache's (:func:`init_cache`)."""
    cfg = model.cfg
    T.check_mesh(cfg)
    x = embed(model.embedding, shard_act(tokens, "tokens"),
              cfg.vocab_size, cfg.d_model)              # (B,1,d)
    x, new_cache = _layers_step(model, cache, x, policy, in_place, max_len)
    x = norm(x, model.ln_final, cfg.norm_type)
    logits = unembed_logits(x[:, 0], model.unembed_table, cfg.vocab_size)
    return _whole_batch(logits, tokens.shape[0]), new_cache


def _embedded_decode_step(model: T.LMModel, cache: dict,
                          x_embed: torch.Tensor,
                          policy: KernelPolicy = DEFAULT_POLICY,
                          max_len: Optional[int] = None) -> dict:
    """:func:`decode_step` from an embedding (B, 1, d) rather than a token,
    without the logits: how :func:`prefill_by_stepping` primes the cache
    with the meta tokens (hymba's).  Returns the new cache."""
    return _layers_step(model, cache, x_embed, policy, max_len=max_len)[1]


def _ring_fill(kv_full: torch.Tensor, s_c: int, sink: int) -> torch.Tensor:
    """Scatter full-sequence K or V (B, S, H, dh), or their int8 scales (B,
    S, H), into a cache of ``s_c`` slots (B, s_c, ...), matching
    ``attention_decode``'s slot function: padded when S fits, else slot r <
    sink holds position r and ring slot r the latest position p < S with
    ``ring_slot(p) == r``."""
    s = kv_full.shape[1]
    if s <= s_c:
        return F.pad(kv_full, (0, 0) * (kv_full.dim() - 2) + (0, s_c - s))
    # the slots' positions on the device: the prefill is captured
    r = torch.arange(s_c, device=kv_full.device)
    base = s - 1 - torch.remainder(s - 1 - r, s_c - sink)
    return kv_full.index_select(1, torch.where(r < sink, r, base))


def _frame_block(t: torch.Tensor, frames: int) -> torch.Tensor:
    """A layer's encoder K or V (b, S, Hkv, dh) as the cache holds it: the
    rank's block of the ``frames`` where ``t`` has every frame
    (:func:`_slot_block`); ``t`` where it is that block already (the cross
    attention hands it so where its heads split,
    ``attention._heads_to_frames``)."""
    return _slot_block(t) if t.shape[1] == frames else t


def _slot_block(t: torch.Tensor) -> torch.Tensor:
    """A layer's filled cache tensor (b, S_c, ...) (this rank's rows,
    every slot) cut to the rank's block of its slots under the cache's
    spec (the reference's ``"cache"`` kind); itself without a mesh."""
    r = current_rules()
    if active_mesh(r) is None:
        return t
    seq = act_spec(t.shape, "cache", r)[1]
    return local_block(t, P(None, seq, *[None] * (t.dim() - 2)), r.mesh)


def prefill(model: T.LMModel, tokens: torch.Tensor, *, max_len: int,
            frontend: Optional[torch.Tensor] = None,
            policy: KernelPolicy = DEFAULT_POLICY):
    """tokens (B, S) -> (last logits (B, V), cache primed to pos = P + S),
    P the prefix: the meta tokens and the stubbed modality embeddings
    ``frontend`` (B, F, d), if given.  An encoder-decoder takes
    ``frontend`` as its encoder's frames (B, S_enc, d) (P = 0) and its
    cache holds each layer's cross attention K/V of the encoder's
    output."""
    x, prefix, aux = T.hidden_states(model, tokens, frontend=frontend,
                                     policy=policy, capture_kv=True)
    b, s = x.shape[0], tokens.shape[1]
    layers = []
    for i, captured in enumerate(aux["layers"]):
        if "kv" not in captured:                        # mlstm / slstm
            layers.append(captured["state"])
            continue
        s_c = T.cache_len(model.variant(i), max_len)
        sink = model.variant(i).sink
        k, v = captured["kv"]
        full = {"k": k, "v": v}
        if model.cfg.kv_quant:
            (full["k"], full["k_scale"]), (full["v"], full["v_scale"]) = (
                _quantize_vec(k), _quantize_vec(v))
        layer = {name: _slot_block(_ring_fill(t, s_c, sink))
                 for name, t in full.items()}
        if "state" in captured:                         # hymba
            layer["mamba"] = captured["state"]
        layers.append(layer)
    cache = {"pos": torch.full((b,), prefix + s, dtype=torch.int32,
                               device=tokens.device),
             "layers": layers}
    if model.cfg.encdec is not None:
        dt, frames = model.cfg.torch_dtype, model.cfg.encdec.enc_seq
        for j, name in enumerate(("enc_k", "enc_v")):
            cache[name] = torch.stack([
                _frame_block(c["cross_kv"][j], frames)
                for c in aux["layers"]]).to(dt)
    logits = unembed_logits(x[:, -1], model.unembed_table,
                            model.cfg.vocab_size)
    return _whole_batch(logits, tokens.shape[0]), cache


def prefill_by_stepping(model: T.LMModel, tokens: torch.Tensor, *,
                        max_len: int,
                        policy: KernelPolicy = DEFAULT_POLICY):
    """Reference prefill: one decode step per meta token (from its
    embedding), then one per prompt token.  Like the reference's, it never
    runs an encoder: an encoder-decoder's cross attention reads the zeroed
    ``enc_k``/``enc_v`` of :func:`init_cache`, so it is no oracle for
    one."""
    b, s = tokens.shape
    cache = init_cache(model.cfg, b, max_len, tokens.device)
    if model.cfg.meta_tokens:
        meta = model.meta_embeds(b)
        for i in range(model.cfg.meta_tokens):
            cache = _embedded_decode_step(model, cache, meta[:, i:i + 1],
                                          policy, max_len)
    logits = torch.zeros((b, model.cfg.vocab_size), device=tokens.device)
    for t in range(s):
        logits, cache = decode_step(model, cache, tokens[:, t:t + 1],
                                    policy=policy, max_len=max_len)
    return logits, cache


def _clone_cache(cache):
    if isinstance(cache, dict):
        return {k: _clone_cache(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone_cache(v) for v in cache]
    return cache.clone()


def decode_step_into(model: T.LMModel, cache: dict, tokens: torch.Tensor,
                     logits: torch.Tensor, *,
                     policy: KernelPolicy = DEFAULT_POLICY,
                     max_len: Optional[int] = None):
    """:func:`decode_step` on static buffers: each attention layer's new
    K/V slot is written into ``cache``'s K/V in place; the rest of the
    step's new state (every recurrent and conv state, and ``pos``) is
    copied into ``cache``'s own tensors at the end of the step, and its
    logits into ``logits`` (B, V) fp32.  It reads and writes the same
    addresses every call, which is what a CUDA graph of it needs.
    Returns ``(logits, cache)``."""
    new_logits, new_cache = decode_step(model, cache, tokens, policy=policy,
                                        in_place=True, max_len=max_len)
    logits.copy_(new_logits)
    graphs.copy_tree_(cache, new_cache)
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
                graphs.copy_tree_(self.cache, cache)
            self.tokens.copy_(tokens)
            logits, _ = self.captured.replay()
            return logits.clone(), self.cache


def capture_decode_step(model: T.LMModel, batch: int, max_len: int, *,
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
            model, cache, tokens, logits, policy=policy, max_len=max_len),
            dev)
        # the warm-up and the first replay stepped the static cache
        graphs.copy_tree_(cache, init_cache(model.cfg, batch, max_len, dev))
    return CapturedDecodeStep(captured, tokens, cache)


def _check_shape(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape:
        raise ValueError(f"prefill captured for {name} of shape "
                         f"{tuple(want.shape)}, got {tuple(got.shape)}")


@dataclasses.dataclass
class CapturedPrefill:
    """A prefill captured as a CUDA graph for one (batch, prompt length,
    frontend length): ``(tokens (B, S)[, frontend (B, F, d)]) -> (last
    logits (B, V), cache)``, both copies of the graph's buffers, as
    :func:`prefill` returns them.  A graph captured with a frontend takes
    one at every call (its static :attr:`frontend` buffer), and one
    captured without refuses one."""
    captured: graphs.Captured
    tokens: torch.Tensor
    frontend: Optional[torch.Tensor] = None

    def __call__(self, tokens: torch.Tensor,
                 frontend: Optional[torch.Tensor] = None):
        _check_shape("tokens", tokens, self.tokens)
        if (frontend is None) != (self.frontend is None):
            raise ValueError("prefill captured "
                             + ("with" if self.frontend is not None
                                else "without") + " a frontend")
        with torch.inference_mode():
            self.tokens.copy_(tokens)
            if frontend is not None:
                _check_shape("frontend", frontend, self.frontend)
                self.frontend.copy_(frontend)
            logits, cache = self.captured.replay()
            return logits.clone(), _clone_cache(cache)


def capture_prefill(model: T.LMModel, batch: int, prompt_len: int, *,
                    max_len: Optional[int] = None, frontend_len: int = 0,
                    policy: KernelPolicy = DEFAULT_POLICY) -> CapturedPrefill:
    """Capture :func:`prefill` of ``batch`` prompts of ``prompt_len`` tokens
    (after ``frontend_len`` embeddings of a stubbed frontend, or an
    encoder-decoder's ``frontend_len`` encoder frames, read from a static
    buffer, when it is not 0) on the model's device, which must be the
    card; raises on the CPU.  The sLSTM loop over the prompt is captured
    with the rest, so the graph holds about 20 nodes a token for each
    sLSTM layer.  ``max_len`` defaults to the prefix and the prompt."""
    cfg = model.cfg
    dev = model.embedding["table"].device
    tokens = torch.zeros((batch, prompt_len), dtype=torch.int64, device=dev)
    frontend = (torch.zeros((batch, frontend_len, cfg.d_model),
                            dtype=cfg.torch_dtype, device=dev)
                if frontend_len else None)
    prefix = 0 if cfg.encdec is not None else cfg.meta_tokens + frontend_len
    max_len = max_len or prefix + prompt_len
    with torch.inference_mode():
        captured = graphs.capture(lambda: prefill(
            model, tokens, max_len=max_len, frontend=frontend,
            policy=policy), dev)
    return CapturedPrefill(captured, tokens, frontend)
