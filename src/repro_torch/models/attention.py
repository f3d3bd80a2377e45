"""GQA attention: dense, blockwise (online-softmax) and decode paths.
Counterpart of ``repro/models/attention.py``.

* Dense path — short sequences (the whole score matrix at once), plain
  autograd.
* Blockwise path — O(S·chunk) memory by an online softmax over a *static
  list of (q-chunk, kv-chunk) pairs* that enumerates only the causal (or
  sliding-window) lower triangle, so no fully masked block is computed.
  Pairs are row-major, so the softmax state carries one q chunk at a time.
  Its backward (:class:`_Flash`, the reference's ``_flash_vjp_bwd``)
  recomputes each pair's probabilities from the saved log-sum-exp rows:
  O(S) residuals, never the S x S scores.
* Decode path — one query token against a KV cache, optionally a
  StreamingLLM-style ring (``sink`` permanent slots and a ring of window
  slots).

Self-attention is causal or (whisper's encoder) bidirectional; cross
attention (whisper's decoder, ``xkv``) reads its K/V from the encoder's
output, unmasked and without RoPE.  Keys padded to a whole chunk are
masked.

The products are ``torch.einsum`` and a softmax in fp32, as the reference
leaves them to XLA; no TPU kernel exists for them.  The projections are
Linears, so they run on the ``pwconv`` kernel.  Supports GQA, qk-norm,
qkv-bias, sliding window with sink (meta) tokens, NoPE and the int8 KV
cache (``scales``: int8 vectors with a fp32 scale per (B, S, Hkv),
dequantized to bf16 whatever the model's dtype, as the reference does).

Tensor parallelism (under a mesh whose model axis has tp > 1 ranks; the
reference leaves all of it to GSPMD): ``w_q``, ``w_k`` and ``w_v`` are
column-parallel and ``w_o`` row-parallel (``layers.row_linear``), as the
sharding rules give them.  Where each rank's columns are whole heads,
attention runs on the rank's heads (a rank's KV heads being the ones its
query heads read); where they are not (smollm-360m at tp 2: 7.5 query
heads a rank; internvl2-1b at tp 4: half a KV head), the split
projections are gathered over the model axis before the heads are formed
(:func:`_project_qkv`).  The KV cache is split over its sequence (the
reference's ``"cache"`` kind, ``repro/models/attention.py:403-404,
472-484``) wherever its length divides: a prefill gathers K and V over
heads and keeps the rank's slots; a decode step is flash-decoding — the
query replicated (``"q_decode"``), each rank scoring its own slots into a
local max, sum and weighted V, combined by one ``all_reduce`` of the
maxima and one of the rescaled sums and outputs (:func:`_combine_slots`).
The new token's K and V are written by the rank that owns its slot, by a
masked write with no host branch.

Training under the model axis differentiates through those collectives
(``sharding/collectives.py``): the projections' shared input enters the
split region once (its gradient summed over the axis), split heads
gathered alike give back the rank's block of their gradient, and where
the rank's own query heads read KV heads every rank holds alike (the KV
columns gathered, or whole), those enter the split region too, as do the
qk-norm scales applied to the rank's own heads.

A training forward makes the serving forward's collectives (w_o's sum,
and one gather where the heads are not a rank's whole ones, as hymba's
query and KV columns at tp 2 and 4); its backward one all_reduce for the
input's ``copy_to_split`` (two for a cross attention: the query's input
and the encoder's output enter apart), and, where the heads were
gathered, one all_gather for ``w_o``'s ``split`` of its whole input.
The K/V of a training step never reach :func:`_heads_to_frames`, which
only a prefill's returned cache takes.

Under sequence parallelism (``layers.sequence_parallel``) the input is
the normed residual gathered whole (``layers.gather_seq``), so the
attention runs on every position at their global ``positions``, and
``w_o``'s partial sums are reduce-scattered to the rank's block of the
sequence (``layers.row_linear``); a cross attention reads the encoder's
output gathered whole once for every layer.  The K/V a prefill captures
are the whole sequence's, as without it.

Whisper's cross attention under the model axis: the encoder's K and V
are split by head (their columns), but the cache holds them split by
frame (``"enc_k"``, ``"enc_v"``: the reference's ``"cache"`` kind), so a
prefill turns the rank's heads of every frame into every head of its
frames with one ``all_to_all`` (:func:`_heads_to_frames`).  A decode
step's cross attention (:func:`cross_decode`) is flash-decoding over the
rank's frames, unmasked: the query gathered whole, the maxima and then
the sums reduced over the axis.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models.layers import (apply_rope, enter_model_axis,
                                       init_linear, init_norm, linear,
                                       rms_norm, row_linear)
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import model_shard

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The reference's ``init_attention``: ``w_q``, ``w_k``, ``w_v``,
    ``w_o`` (with biases for ``qkv_bias``) and, for ``qk_norm``,
    ``q_norm`` / ``k_norm`` scales."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, generator: torch.Generator,
                 qkv_bias: bool = False, qk_norm: bool = False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        lin = dict(dtype=dtype, device=device)
        self.w_q = init_linear(generator, d_model, n_heads * head_dim,
                               bias=qkv_bias, **lin)
        self.w_k = init_linear(generator, d_model, n_kv_heads * head_dim,
                               bias=qkv_bias, **lin)
        self.w_v = init_linear(generator, d_model, n_kv_heads * head_dim,
                               bias=qkv_bias, **lin)
        self.w_o = init_linear(generator, n_heads * head_dim, d_model, **lin)
        if qk_norm:
            self.q_norm = init_norm("rms", head_dim, device=device)
            self.k_norm = init_norm("rms", head_dim, device=device)


def _project_qkv(p: Attention, x, xkv, n_heads, n_kv_heads, head_dim, *,
                 qk_norm, policy, full_q: bool, kv_gathered: bool = False):
    """q from ``x``, k and v from ``xkv`` (``x`` itself for
    self-attention), as this rank attends with them: (q (B,S,hq,dh), k, v
    (B,Skv,hkv,dh), q0, kv_local).  Under a model axis of tp > 1 ranks the
    query is the rank's heads q0 .. q0+hq-1 where its columns are whole
    heads and ``full_q`` is false, else every head (gathered where it was
    split); k and v are the rank's KV heads (``kv_local``) where the query
    is local and the KV columns are whole heads too, else every KV head.
    The split projections that must be whole travel in one gather.  At
    tp 1 nothing is split: every head, q0 0, kv_local false."""
    tp, rank, group = model_shard()
    b, s, _ = x.shape
    skv = xkv.shape[1]
    q_split = p.w_q["w"].shape[1] != n_heads * head_dim
    kv_split = p.w_k["w"].shape[1] != n_kv_heads * head_dim
    # the split projections' inputs enter the split region once each, the
    # whole ones alike
    xs = enter_model_axis(x, split=q_split)
    xkvs = xs if (xkv is x and q_split == kv_split) else enter_model_axis(
        xkv, split=kv_split, gathered=kv_gathered)
    qc = linear(p.w_q, xs, policy=policy)
    kc = linear(p.w_k, xkvs, policy=policy)
    vc = linear(p.w_v, xkvs, policy=policy)
    q_local = not full_q and q_split and n_heads % tp == 0
    kv_local = q_local and kv_split and n_kv_heads % tp == 0
    if q_split and not q_local and kv_split and not kv_local:
        qc, kc, vc = collectives.all_gather_last([qc, kc, vc], group)
    elif q_split and not q_local:
        qc, = collectives.all_gather_last([qc], group)
    elif kv_split and not kv_local:
        kc, vc = collectives.all_gather_last([kc, vc], group)
    hq = qc.shape[-1] // head_dim
    q = qc.reshape(b, s, hq, head_dim)
    k = kc.reshape(b, skv, -1, head_dim)
    v = vc.reshape(b, skv, -1, head_dim)
    if qk_norm:
        # a replicated scale on the rank's own heads: its gradient is the
        # sum of the ranks' parts
        q = rms_norm(q, collectives.copy_to_split(p.q_norm["scale"], group)
                     if q_local else p.q_norm["scale"])
        k = rms_norm(k, collectives.copy_to_split(p.k_norm["scale"], group)
                     if kv_local else p.k_norm["scale"])
    return q, k, v, (rank * hq if q_local else 0), kv_local


def _kv_for_heads(k, v, q0: int, hq: int, group_size: int):
    """Every KV head (B,S,Hkv,dh) cut to what query heads q0 .. q0+hq-1
    read: the KV heads they share where the query block starts and ends on
    a group's edge, else one KV head per query head."""
    if q0 % group_size == 0 and hq % group_size == 0:
        sl = slice(q0 // group_size, (q0 + hq) // group_size)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.div(torch.arange(q0, q0 + hq, device=k.device), group_size,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def project_q(p: Attention, x, n_heads, head_dim, *, qk_norm, policy):
    """The query projection alone (with its qk-norm), every head (gathered
    where the columns are split): what a decode step's cross attention
    needs, its K/V being the encoder's, cached."""
    b, s, _ = x.shape
    qc = linear(p.w_q, x, policy=policy)
    if qc.shape[-1] != n_heads * head_dim:
        qc, = collectives.all_gather_last([qc], model_shard()[2])
    q = qc.reshape(b, s, n_heads, head_dim)
    return rms_norm(q, p.q_norm["scale"]) if qk_norm else q


def cross_decode(q, k, v, frames: int) -> torch.Tensor:
    """A decode step's cross attention: q (B,1,Hq,dh) every head against
    the encoder's cached k, v (B,S,Hkv,dh), unmasked -> (B,1,Hq,dh) in
    q's dtype.  Where the cache holds this rank's block of the ``frames``
    (S < frames), flash-decoding over the model axis."""
    if k.shape[1] == frames:
        return dense_attention(q, k, v, causal=False)
    scores = _gqa_scores(q, k) * (q.shape[-1] ** -0.5)     # (B,Hq,1,S)
    return _combine_slots(scores, v, model_shard()[2]).to(q.dtype)


def _heads_to_frames(k, v, tp: int, group):
    """The rank's heads of every frame, k and v (B,S,h,dh), as every head
    (tp * h) of the rank's block of S / tp frames, in one all_to_all:
    block j of the frames goes to rank j, which receives each rank's
    heads of them in rank order."""
    b, s, h, dh = k.shape
    kv = torch.stack([k, v]).reshape(2, b, tp, s // tp, h, dh)
    got = collectives.all_to_all(kv.permute(2, 0, 1, 3, 4, 5).contiguous(),
                                 group)                # (tp, 2, b, s/tp, h, dh)
    got = got.permute(1, 2, 3, 0, 4, 5).reshape(2, b, s // tp, tp * h, dh)
    return got[0], got[1]


# ---------------------------------------------------------------------------
# Dense attention (small S) — also the oracle for the blockwise path
# ---------------------------------------------------------------------------


def _gqa_scores(q, k):
    """q (B,Sq,Hq,dh), k (B,Sk,Hkv,dh) -> scores (B,Hq,Sq,Sk) fp32."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    return s.reshape(b, hkv * g, sq, k.shape[1])


def _gqa_out(probs, v):
    """probs (B,Hq,Sq,Sk), v (B,Sk,Hkv,dh) -> (B,Sq,Hq,dh) fp32."""
    b, hq, sq, sk = probs.shape
    hkv = v.shape[2]
    g = hq // hkv
    pg = probs.reshape(b, hkv, g, sq, sk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v.float())
    return out.reshape(b, sq, hq, v.shape[-1])


def dense_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    sink: int = 0) -> torch.Tensor:
    """Reference/simple path. Returns (B, Sq, Hq, dh) in q.dtype.

    sink: the first ``sink`` kv positions are always attendable (meta/sink
    tokens), even outside the sliding window.
    """
    sq, dh = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scores = _gqa_scores(q, k) * (dh ** -0.5)
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (kj > qi - window) | (kj < sink)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (online softmax over a static causal pair list)
# ---------------------------------------------------------------------------


def _pair_list(nq: int, nk: int, causal: bool, window_chunks: Optional[int],
               sink_chunks: int = 0) -> list:
    """Static (qi, ki) pairs, row-major, only not-fully-masked blocks."""
    pairs = []
    for qi in range(nq):
        for ki in range(nk):
            if causal and ki > qi:
                continue
            if (window_chunks is not None and ki < qi - window_chunks
                    and ki >= sink_chunks):
                continue
            pairs.append((qi, ki))
    return pairs


def _pair_flags(pairs) -> tuple:
    """(is_first, is_last): whether each pair opens / closes its q row."""
    rows = [qi for qi, _ in pairs]
    is_first = [i == 0 or rows[i - 1] != r for i, r in enumerate(rows)]
    is_last = [i == len(rows) - 1 or rows[i + 1] != r
               for i, r in enumerate(rows)]
    return is_first, is_last


def _block_mask(qi, ki, qc, kc, causal, window, sink, sk, device):
    qpos = qi * qc + torch.arange(qc, device=device)[:, None]
    kpos = ki * kc + torch.arange(kc, device=device)[None, :]
    mask = (kpos < sk).expand(qc, kc)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((kpos > qpos - window) | (kpos < sink))
    return mask


def _flash_fwd(q, k, v, statics):
    """The pair loop's forward.  q (B, nq*qc, Hq, dh), k/v (B, nk*kc, Hkv,
    dh), padded to whole chunks.  Returns out (B, nq*qc, Hq, dh) in q.dtype
    and the log-sum-exp rows lse (B, Hq, nq*qc) fp32 that the backward
    recomputes the probabilities from.

    A row's first pair starts the softmax state from its block alone: the
    reference's reset to (m = NEG_INF, l = 0, acc = 0) followed by the
    update gives those values exactly."""
    (causal, window, sink, qc, kc, sk, pairs, is_first, is_last) = statics
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    for (qi, ki), first, last in zip(pairs, is_first, is_last):
        qb = q[:, qi * qc:(qi + 1) * qc]
        vb = v[:, ki * kc:(ki + 1) * kc]
        s = _gqa_scores(qb, k[:, ki * kc:(ki + 1) * kc]) * scale
        mask = _block_mask(qi, ki, qc, kc, causal, window, sink, sk,
                           q.device)
        s = torch.where(mask, s, NEG_INF)                  # (B,Hq,qc,kc)
        if first:
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            l = p.sum(dim=-1)
            acc = _gqa_out(p, vb)
        else:
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.transpose(1, 2)[..., None] + _gqa_out(p, vb)
            m = m_new
        if last:
            lc = torch.clamp(l, min=1e-30)
            res = acc / lc.transpose(1, 2)[..., None]
            out[:, qi * qc:(qi + 1) * qc] = res.to(out.dtype)
            lse[:, :, qi * qc:(qi + 1) * qc] = m + torch.log(lc)
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, statics):
    """The reference's ``_flash_vjp_bwd``: for each block pair, P =
    exp(S - lse) from the saved rows; dV_j += P^T dO; dS = P (dO V^T - D)
    scale with D = rowsum(dO * O); dQ_i += dS K_j; dK_j += dS^T Q_i.  dK and
    dV accumulate in fp32 over the q rows, dQ over a row's pairs; each is
    cast to its input's dtype at the end."""
    (causal, window, sink, qc, kc, sk, pairs, is_first, is_last) = statics
    b, _, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    d_term = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for qi, ki in pairs:
        rows, cols = slice(qi * qc, (qi + 1) * qc), slice(ki * kc,
                                                          (ki + 1) * kc)
        qb, kb, vb = q[:, rows], k[:, cols], v[:, cols]
        s = _gqa_scores(qb, kb) * scale                    # (B,Hq,qc,kc)
        mask = _block_mask(qi, ki, qc, kc, causal, window, sink, sk,
                           q.device)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[:, :, rows, None])
        pg = p.reshape(b, hkv, g, qc, kc)
        dog = dout[:, rows].float().reshape(b, qc, hkv, g, dh)
        dv[:, cols] += torch.einsum("bhgqk,bqhgd->bkhd", pg, dog)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vb.float())
        dt = d_term[:, :, rows].reshape(b, hkv, g, qc)[..., None]
        ds = pg * (dp - dt) * scale
        dq[:, rows] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                    kb.float()).reshape(b, qc, hq, dh)
        dk[:, cols] += torch.einsum(
            "bhgqk,bqhgd->bkhd", ds, qb.float().reshape(b, qc, hkv, g, dh))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The blockwise attention with the reference's custom VJP
    (``_flash`` with ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``): residuals q,
    k, v, out and the lse rows."""

    @staticmethod
    def forward(ctx, q, k, v, statics):
        out, lse = _flash_fwd(q, k, v, statics)
        ctx.statics = statics
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout.contiguous(),
                            ctx.statics), None)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, sink: int = 0,
                        chunk: int = 1024) -> torch.Tensor:
    """Flash attention in plain PyTorch: an online softmax over a static
    causal (or, ``causal=False``, full) block-pair list, keys padded to a
    whole chunk masked; differentiable through :class:`_Flash`.  q
    (B,Sq,Hq,dh); k/v (B,Sk,Hkv,dh)."""
    sq, sk = q.shape[1], k.shape[1]
    qc, kc = min(chunk, sq), min(chunk, sk)
    pad_q, pad_k = (-sq) % qc, (-sk) % kc
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (sq + pad_q) // qc, (sk + pad_k) // kc
    wc = None if window is None else max(1, -(-window // kc))
    sc = 0 if not sink else -(-sink // kc)
    pairs = _pair_list(nq, nk, causal, wc, sc)
    statics = (causal, window, sink, qc, kc, sk, pairs, *_pair_flags(pairs))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, statics)[:, :sq]
    return _flash_fwd(q, k, v, statics)[0][:, :sq]


# ---------------------------------------------------------------------------
# Full attention layer (self / cross; train or prefill)
# ---------------------------------------------------------------------------


def attention(p: Attention, x, *, n_heads: int, n_kv_heads: int,
              head_dim: int, positions: Optional[torch.Tensor] = None,
              causal: bool = True, window: Optional[int] = None,
              sink: int = 0, rope_theta: Optional[float] = 1e4,
              qk_norm: bool = False, xkv: Optional[torch.Tensor] = None,
              xkv_gathered: bool = False, chunk: int = 1024,
              policy: KernelPolicy = DEFAULT_POLICY,
              return_kv: bool = False):
    """Attention over x (B, S, d): self-attention at absolute ``positions``
    (B, S) (``None``: ``arange(S)``, as the reference falls back to),
    causal unless ``causal=False``; or, with ``xkv`` (B, S_src, d), cross
    attention to it, unmasked and without RoPE.  Dense when both lengths
    fit one ``chunk``, else blockwise.  Returns the block's output (B, S,
    d_model) [, (k, v)]: the K/V (after RoPE), which prefill writes into
    the decode cache (a cross attention's: the encoder's cached K/V).
    Under a model axis the K/V returned hold every head: of every
    position, or, for a cross attention whose heads were split and whose
    S_src divides, of the rank's block of S_src / tp frames.
    ``xkv_gathered``: ``xkv`` is a sequence-parallel gather's output (the
    encoder's, ``layers.enter_model_axis``); ``x`` is one where a
    sequence-parallel layer is running."""
    b, s, _ = x.shape
    src = x if xkv is None else xkv
    tp, _, group = model_shard()
    q, k, v, q0, kv_local = _project_qkv(
        p, x, src, n_heads, n_kv_heads, head_dim, qk_norm=qk_norm,
        policy=policy, full_q=False, kv_gathered=xkv_gathered)
    if rope_theta is not None and xkv is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    causal = causal and xkv is None
    hq = q.shape[2]
    ka, va = k, v
    if hq != n_heads and not kv_local:     # the rank's queries, every KV head
        # every rank holds every KV head alike and reads its own part
        ka, va = _kv_for_heads(collectives.copy_to_split(k, group),
                               collectives.copy_to_split(v, group), q0, hq,
                               n_heads // n_kv_heads)
    if s <= chunk and src.shape[1] <= chunk:
        out = dense_attention(q, ka, va, causal=causal, window=window,
                              sink=sink)
    else:
        out = blockwise_attention(q, ka, va, causal=causal, window=window,
                                  sink=sink, chunk=chunk)
    out = out.reshape(b, s, hq * head_dim).contiguous()
    out = row_linear(p.w_o, out, n_heads * head_dim, d_out=x.shape[-1],
                     policy=policy)
    if return_kv and kv_local and xkv is not None and (
            src.shape[1] % tp == 0):       # the encoder's cache: frames
        k, v = _heads_to_frames(k, v, tp, group)
    elif return_kv and kv_local:           # the cache holds every KV head
        hkv, dh = k.shape[2:]
        k, v = (t.reshape(b, -1, tp * hkv, dh) for t in
                collectives.all_gather_last(
                    [k.reshape(b, -1, hkv * dh), v.reshape(b, -1, hkv * dh)],
                    group))
    return (out, (k, v)) if return_kv else out


# ---------------------------------------------------------------------------
# Decode: one token against a KV cache
# ---------------------------------------------------------------------------


def ring_slot(pos: torch.Tensor, smax: int, sink: int) -> torch.Tensor:
    """The ring cache's slot of position ``pos``: ``pos`` below ``smax``,
    else ``sink + (pos - sink) % (smax - sink)``; on the device, so a
    captured step reads ``pos`` from its cache."""
    return torch.where(pos < smax, pos,
                       sink + torch.remainder(pos - sink, smax - sink))


def _quantize_vec(x: torch.Tensor):
    """x (..., dh) -> (int8 values, fp32 scale (...,)): the vector's
    largest magnitude maps to 127.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                in_place: bool) -> torch.Tensor:
    """``new`` (B, 1, ...) written at sequence slot ``slot`` (B,) of
    ``cache`` (B, S, ...): a scatter into ``cache`` itself, or the
    reference's one-hot select into a new tensor.  A slot outside the
    cache (past ``max_len``, or another rank's block of a sequence-split
    cache: a slot here is local, and may be negative) writes nothing
    either way (the one-hot matches no slot; the scatter writes the
    nearest slot's own value back), so a step never indexes out of the
    cache."""
    if in_place:
        smax = cache.shape[1]
        shape = (-1, *[1] * (cache.dim() - 1))
        idx = torch.clamp(slot, 0, smax - 1).long().view(shape).expand_as(
            new)
        inside = (slot >= 0) & (slot < smax)
        new = torch.where(inside.view(shape), new,
                          torch.gather(cache, 1, idx))
        return cache.scatter_(1, idx, new)
    j = torch.arange(cache.shape[1], device=slot.device)
    wmask = (j[None, :] == slot[:, None]).view(*cache.shape[:2],
                                               *[1] * (cache.dim() - 2))
    return torch.where(wmask, new, cache)


def _combine_slots(scores, v, group) -> torch.Tensor:
    """Flash-decoding's combine: the masked scores (B,Hq,1,Sl) of this
    rank's slots and their V (B,Sl,Hkv,dh) -> the softmax-weighted V over
    every rank's slots (B,1,Hq,dh) fp32.  The maxima are reduced first, so
    each rank's weights exp(s - m) share one scale (a rank whose slots are
    all masked adds zeros); one sum then combines the weighted V and the
    weights' sums."""
    m = collectives.all_reduce(scores.amax(dim=-1), group, "max")
    w = torch.exp(scores - m[..., None])
    o = _gqa_out(w, v)                                       # (B,1,Hq,dh)
    b, _, hq, dh = o.shape
    both = collectives.all_reduce(
        torch.cat([o.reshape(b, hq * dh), w.sum(dim=-1).reshape(b, hq)],
                  dim=-1), group)
    return (both[:, :hq * dh].reshape(b, 1, hq, dh)
            / both[:, hq * dh:].reshape(b, 1, hq, 1))


def attention_decode(p: Attention, x_t, cache_k, cache_v, pos, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     window: Optional[int] = None,
                     rope_theta: Optional[float] = 1e4,
                     qk_norm: bool = False, ring: bool = False,
                     sink: int = 0, scales: Optional[tuple] = None,
                     policy: KernelPolicy = DEFAULT_POLICY,
                     in_place: bool = False, kv_len: Optional[int] = None):
    """x_t (B,1,d); cache_k/v (B,Sc,Hkv,dh); pos (B,) current index.

    ring=True: the cache is a StreamingLLM-style buffer: ``sink``
    permanent slots + a ring of (Sc - sink) sliding-window slots.
    Positions past the buffer wrap within the ring part; every populated
    slot is attendable.

    scales: ``(k_scale, v_scale)`` (B,Sc,Hkv) fp32 of an int8 cache: the
    new K/V vectors are quantized (:func:`_quantize_vec`) into their slot
    and the cache is read as bf16 ``int8 * scale``, which halves the
    cache's bytes a token against bf16.

    in_place: write the new K/V (and scales) into the cache's own tensors
    at their slot (one scatter each) and return those same tensors, where
    the reference (and the default here) returns new caches through a
    one-hot select.  The values are the same; the static-buffer decode
    step uses it, so that a token does not rewrite the whole cache.
    kv_len: the whole cache's slots where ``cache_k``/``cache_v`` hold
    this rank's block of them (the sequence split over the model axis):
    the token's slot is written by the rank that owns it and the softmax
    runs over every rank's slots (flash-decoding).
    Returns (out (B,1,d), new_k, new_v[, (new_k_scale, new_v_scale)]).
    """
    b = x_t.shape[0]
    _, rank, group = model_shard()
    # the query replicated: every rank scores its own slots
    q, k, v, _, _ = _project_qkv(p, x_t, x_t, n_heads, n_kv_heads, head_dim,
                                 qk_norm=qk_norm, policy=policy, full_q=True)
    if rope_theta is not None:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)
    smax = cache_k.shape[1]
    total = kv_len or smax
    split = total != smax
    first = rank * smax if split else 0          # the block's first slot
    slot = ring_slot(pos, total, sink) if ring else pos
    if split:
        slot = slot - first
    if scales is not None:
        k_scale, v_scale = scales
        (k8, ks_new), (v8, vs_new) = _quantize_vec(k), _quantize_vec(v)
        cache_k = _write_slot(cache_k, k8, slot, in_place)
        cache_v = _write_slot(cache_v, v8, slot, in_place)
        k_scale = _write_slot(k_scale, ks_new, slot, in_place)
        v_scale = _write_slot(v_scale, vs_new, slot, in_place)
        k_eff = cache_k.to(torch.bfloat16) * k_scale[..., None].to(
            torch.bfloat16)
        v_eff = cache_v.to(torch.bfloat16) * v_scale[..., None].to(
            torch.bfloat16)
    else:
        # (B,1,Hkv,dh) in the cache's dtype
        cache_k = _write_slot(cache_k, k.to(cache_k.dtype), slot, in_place)
        cache_v = _write_slot(cache_v, v.to(cache_v.dtype), slot, in_place)
        k_eff, v_eff = cache_k, cache_v
    scores = _gqa_scores(q, k_eff) * (head_dim ** -0.5)    # (B,Hq,1,Smax)
    j = first + torch.arange(smax, device=pos.device)[None, :]
    if ring:
        valid = j < torch.clamp(pos + 1, max=total)[:, None]
    else:
        valid = j <= pos[:, None]
        if window is not None:
            valid &= (j > (pos[:, None] - window)) | (j < sink)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    if split:
        out = _combine_slots(scores, v_eff, group).to(x_t.dtype)
    else:
        probs = torch.softmax(scores, dim=-1)
        out = _gqa_out(probs, v_eff).to(x_t.dtype)          # (B,1,Hq,dh)
    out = out.reshape(b, 1, n_heads * head_dim).contiguous()
    proj = row_linear(p.w_o, out, n_heads * head_dim, d_out=x_t.shape[-1],
                      policy=policy)
    if scales is not None:
        return proj, cache_k, cache_v, (k_scale, v_scale)
    return proj, cache_k, cache_v
