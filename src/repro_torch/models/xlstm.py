"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar
memory, sequential scan).  arXiv:2405.04517.  Counterpart of
``repro/models/xlstm.py``.

mLSTM stabilized exponential gating:
    m_t = max(logf_t + m_{t-1}, i_t)
    C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) k_t v_t^T
    n_t = exp(logf_t + m_{t-1} - m_t) n_{t-1} + exp(i_t - m_t) k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))

The recurrent cells are plain functions on tensors, with the reference's
semantics: ``mlstm_recurrent`` (a loop over time; decode and oracle),
``mlstm_chunkwise`` (log-space cumulative gates inside a chunk, the carried
(C, n, m) state between chunks) and ``slstm_scan``.  The running maxima
start at ``-inf`` and the chunk pad sets the input gate to ``NEG_INF``;
``exp(-inf)`` is 0 and no ``-inf - -inf`` is formed, so a fresh state or a
padded chunk gives no NaN, in the values or in their gradients (the
``-inf`` entries only ever reach an ``exp`` whose gradient is 0, and
``torch.maximum`` splits a tie's gradient in half, as ``lax.max`` does).

Both cells train: autograd differentiates them as they stand (no op
writes in place into a tensor autograd saved).  A chunk's cumulative log
forget gate is a product with a lower-triangular matrix of ones in fp64,
rounded once to fp32 (the sums ``torch.cumsum`` gives on the CPU, which
accumulates in fp64), rather than ``torch.cumsum``, which has no
deterministic CUDA implementation (training on the card runs with
deterministic algorithms).  Under autograd
``slstm_scan`` checkpoints its loop in chunks of ``chunk`` steps when
``L % chunk == 0 and L > chunk``, as the reference does
(``repro/models/xlstm.py:180-190``), so its gradient keeps one chunk's
activations at a time; the values are the plain loop's.

The blocks are ``nn.Module``s whose parameter names are the reference's
dict keys.  Every Linear runs through ``pointwise`` (the ``pwconv``
kernel on the card); the conv pre-activation through
``depthwise1d_causal`` (the ``dwconv1d`` kernel) over a sequence, and the
plain one-row ``depthwise1d_step`` in decode.  Operands handed to a kernel
are made contiguous (``torch.chunk`` halves are strided views).

Under a model axis of tp > 1 ranks (the sharding rules' layout; the heads
split whole, which ``transformer.check_mesh`` asks for) each rank runs its
heads, and the recurrent state it carries is their block:

* mLSTM: ``w_up`` is cut part by part (``SPLIT_PARTS``: block r of xv's
  columns and block r of xz's), so the rank's ``dwconv1d`` runs on its
  d_inner/tp channels of xv with no collective.  q, k, v and the gates
  read every channel: xv and the conv's output travel in one all_gather
  (1).  ``w_q``, ``w_k`` and ``w_v`` give the rank's heads, ``w_gates``
  (cut part by part, ``[i | f]``) their input and forget gates; the
  chunkwise and recurrent cells run on them.  The output norm, over all
  of d_inner, all-reduces each row's sum of squares (2)
  (``layers.rms_norm_split``); ``w_down`` is row-parallel (3).
* sLSTM: the rank's d_model/tp channels of the normalized input go
  through ``dwconv1d``; the conv's output is gathered (1); ``w_gates``
  and its bias, cut part by part (``[z | i | f | o]``), give each gate at
  the rank's heads, which ``r``'s block of heads matches; the recurrence
  runs on them, and its output is gathered (2) before the output norm.
  The FFN is column-parallel, ``w_ff_down`` row-parallel (3).

No collective sits in a time loop: the chunkwise cell's, the sLSTM's or
its chunk checkpoint's.  A prefill and a decode step make three a layer.

Training (the sharded convention of ``sharding/collectives.py``): the
normalized input enters the column-parallel ``w_up`` and FFN through
``copy_to_split``, and the sLSTM's conv takes its channels through
``split``; the gathers whose outputs feed the rank's heads (the mLSTM's
xv and conv output, one reduce-scatter for both; the sLSTM's conv
output) reduce-scatter their gradient, the sLSTM cell's output (used
alike) keeps the rank's block; the output norm's sums of squares enter
the rank's channels through ``copy_to_split`` and its scale's block is
``split`` off (``layers.rms_norm_split``).  A layer's training forward
makes the serving forward's three; the backward of an mLSTM layer 2
all_reduce, 1 all_gather and 1 reduce_scatter, of an sLSTM layer 1 of
each.

Under sequence parallelism (``layers.sequence_parallel``) a block's
residual is the rank's block of the sequence: its norms run on the block
(their scales through ``layers.seq_params``), the normed block is
gathered whole (``layers.gather_seq``) before ``w_up`` or the sLSTM's
channels and the FFN, so the recurrences run over the whole sequence on
the rank's heads as without it, and the row-parallel ``w_down`` /
``w_ff_down`` reduce-scatter to the block.  The sLSTM's cell output,
gathered over its channels, is cut to the rank's block of the sequence
(``layers.seq_block``) before the output norm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import XLSTMConfig
from repro_torch.core.dwconv import (conv_tail, depthwise1d_causal,
                                     depthwise1d_step)
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models.layers import (enter_model_axis, gather_seq,
                                       init_linear, init_norm, linear, param,
                                       randn, rms_norm, rms_norm_split,
                                       row_linear, seq_block, seq_params,
                                       seq_shard)
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import model_shard

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def init_mlstm_state(b: int, h: int, dh: int, device) -> tuple:
    """(c (B,H,dk,dv), n (B,H,dk), m (B,H)), fp32, m at -inf."""
    return (torch.zeros((b, h, dh, dh), device=device),
            torch.zeros((b, h, dh), device=device),
            torch.full((b, h), -float("inf"), device=device))


def mlstm_recurrent(q, k, v, igate, logf, state=None):
    """q/k/v: (B, L, H, dh); igate/logf: (B, L, H). Returns (h, state)."""
    b, l, h, dh = q.shape
    scale = dh ** -0.5
    c, n, m = state if state is not None else init_mlstm_state(
        b, h, dh, q.device)
    qf, kf, vf, i_f, f_f = (t.float() for t in (q, k, v, igate, logf))
    hs = []
    for t in range(l):
        qt, kt, vt, it, ft = qf[:, t], kf[:, t], vf[:, t], i_f[:, t], f_f[:, t]
        m_new = torch.maximum(ft + m, it)
        fac_f = torch.exp(ft + m - m_new)[..., None]
        fac_i = torch.exp(it - m_new)[..., None]
        c = fac_f[..., None] * c + fac_i[..., None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fac_f * n + fac_i * kt
        qs = qt * scale
        num = torch.einsum("bhkv,bhk->bhv", c, qs)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qs).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (c, n, m)


def mlstm_step(q1, k1, v1, i1, f1, state):
    """One decode step. q1/k1/v1 (B,H,dh); i1/f1 (B,H)."""
    h, state = mlstm_recurrent(q1[:, None], k1[:, None], v1[:, None],
                               i1[:, None], f1[:, None], state)
    return h[:, 0], state


def mlstm_chunkwise(q, k, v, igate, logf, *, chunk: int = 128, state=None):
    """Chunkwise-parallel mLSTM, equal to :func:`mlstm_recurrent`."""
    b, l, h, dh = q.shape
    scale = dh ** -0.5
    chunk = min(chunk, l)
    pad = (-l) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        igate = F.pad(igate, (0, 0, 0, pad), value=NEG_INF)
        logf = F.pad(logf, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    c0, n0, m0 = state if state is not None else init_mlstm_state(
        b, h, dh, q.device)

    def to_chunks(t):
        return t.float().reshape(b, nc, chunk, *t.shape[2:])

    qs_, ks_, vs_, is_, fs_ = (to_chunks(t) for t in (q, k, v, igate, logf))
    tri = torch.ones((chunk, chunk), dtype=torch.float64,
                     device=q.device).tril()
    mask = tri.bool()[None, :, :, None]
    outs = []
    for j in range(nc):
        qc, kc, vc, ic, fc = (t[:, j] for t in (qs_, ks_, vs_, is_, fs_))
        fcum = torch.matmul(tri, fc.double()).float()  # F_i inclusive (B,c,H)
        # intra log-decay D[i,j] = F_i - F_j + i_j  (j <= i)
        d = fcum[:, :, None] - fcum[:, None, :] + ic[:, None, :]
        d = torch.where(mask, d, NEG_INF)              # (B,c,c,H)
        m_intra = d.amax(dim=2)                        # (B,c,H)
        m_inter = fcum + m0[:, None]                   # (B,c,H)
        m_i = torch.maximum(m_intra, m_inter)

        qsc = qc * scale
        s = torch.einsum("bihd,bjhd->bijh", qsc, kc)   # (B,c,c,H)
        w = s * torch.exp(d - m_i[:, :, None])
        num = torch.einsum("bijh,bjhv->bihv", w, vc)
        den = w.sum(dim=2)                             # (B,c,H)

        inter_fac = torch.exp(m_inter - m_i)           # (B,c,H)
        num = num + inter_fac[..., None] * torch.einsum(
            "bhkv,bihk->bihv", c0, qsc)
        den = den + inter_fac * torch.einsum("bhk,bihk->bih", n0, qsc)
        outs.append(num / torch.maximum(den.abs(),
                                        torch.exp(-m_i))[..., None])

        # state to the next chunk
        g = fcum[:, -1]                                # (B,H) total decay
        dk_ = g[:, None] - fcum + ic                   # (B,c,H)
        m_new = torch.maximum(g + m0, dk_.amax(dim=1))
        kfac = torch.exp(dk_ - m_new[:, None])         # (B,c,H)
        decay = torch.exp(g + m0 - m_new)
        c0 = (decay[..., None, None] * c0
              + torch.einsum("bjh,bjhk,bjhv->bhkv", kfac, kc, vc))
        n0 = decay[..., None] * n0 + torch.einsum("bjh,bjhk->bhk", kfac, kc)
        m0 = m_new
    return torch.cat(outs, dim=1)[:, :l], (c0, n0, m0)


# ---------------------------------------------------------------------------
# sLSTM cell (sequential)
# ---------------------------------------------------------------------------


def init_slstm_state(b: int, h: int, dh: int, device) -> tuple:
    """(c, n, h, m), each (B, H, dh) fp32, m at -inf."""
    z = lambda: torch.zeros((b, h, dh), device=device)  # noqa: E731
    return z(), z(), z(), torch.full((b, h, dh), -float("inf"), device=device)


def _slstm_steps(xs, r, c, n, hprev, m):
    """The sLSTM recurrence over xs (T, H, B, 4dh) from the state (c, n,
    hprev, m), each (H, B, dh): (the T outputs (T, H, B, dh), c, n, hprev,
    m)."""
    hs = []
    for t in range(xs.shape[0]):
        pre = xs[t] + torch.bmm(hprev, r)
        z_t, i_t, f_t, o_t = torch.chunk(pre, 4, dim=-1)
        z = torch.tanh(z_t)
        o = torch.sigmoid(o_t)
        fm = F.logsigmoid(f_t) + m
        m_new = torch.maximum(fm, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(fm - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        hprev = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, dim=0), c, n, hprev, m


def slstm_scan(zg, ig, fg, og, r_weights, *, state=None, chunk: int = 128):
    """Gate pre-activations zg/ig/fg/og: (B, L, H, dh).  Recurrent weights
    r_weights: (H, dh, 4*dh), block-diagonal per head.  Returns (h, state)
    with state = (c, n, h, m), each (B, H, dh).

    The loop runs head-major, (H, B, ...), so each step's recurrent product
    is one ``bmm`` on contiguous operands and one add takes all four gates
    (``rec``'s chunks are z, i, f, o in that order).  A step is ~20 small
    launches, and they set the time of a long prompt on the card.  Under
    autograd, with ``L % chunk == 0 and L > chunk``, each chunk of steps
    runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): recomputed in the backward, the same values."""
    b, l, h, dh = zg.shape
    if state is None:
        state = init_slstm_state(b, h, dh, zg.device)
    carry = tuple(s.transpose(0, 1) for s in state)
    r = r_weights.float()
    xs = torch.cat([zg, ig, fg, og], dim=-1).float().permute(1, 2, 0, 3)
    xs = xs.contiguous()                               # (L, H, B, 4dh)
    chunk = min(chunk, l)
    if torch.is_grad_enabled() and l % chunk == 0 and l > chunk:
        outs = []
        for j in range(0, l, chunk):
            out, *carry = torch.utils.checkpoint.checkpoint(
                _slstm_steps, xs[j:j + chunk], r, *carry,
                use_reentrant=False, preserve_rng_state=False)
            outs.append(out)
        out = torch.cat(outs, dim=0)
    else:
        out, *carry = _slstm_steps(xs, r, *carry)
    return (out.permute(2, 0, 1, 3),                   # (B, L, H, dh)
            tuple(s.transpose(0, 1) for s in carry))


def slstm_step(zg, ig, fg, og, r_weights, state):
    """One decode step; gate pre-activations (B, H, dh)."""
    h, state = slstm_scan(zg[:, None], ig[:, None], fg[:, None],
                          og[:, None], r_weights, state=state)
    return h[:, 0], state


# ---------------------------------------------------------------------------
# Blocks.  mLSTM: pre-up-projection; sLSTM: post-FFN.
# ---------------------------------------------------------------------------


class MLSTMBlock(nn.Module):
    """x (B, L, d) -> (B, L, d) with residual (``repro``'s
    ``init_mlstm_block`` / ``mlstm_block`` / ``mlstm_block_step``)."""

    #: Leaves cut part by part under a model axis: ``w_up``'s ``[xv |
    #: xz]`` and the gates' ``[i | f]``.
    SPLIT_PARTS = {"w_up.w": 2, "w_gates.w": 2, "w_gates.b": 2}

    def __init__(self, d_model: int, n_heads: int, cfg: XLSTMConfig, *,
                 generator: torch.Generator, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        di = int(d_model * cfg.proj_factor)
        self.d_model, self.n_heads, self.cfg = d_model, n_heads, cfg
        self.di = di
        lin = dict(dtype=dtype, device=device)
        self.norm = init_norm("rms", d_model, device=device)
        self.w_up = init_linear(generator, d_model, 2 * di, **lin)
        self.conv = param(randn(generator, (cfg.conv_k, di),
                                cfg.conv_k ** -0.5, torch.float32, device))
        self.w_q = init_linear(generator, di, di, **lin)
        self.w_k = init_linear(generator, di, di, **lin)
        self.w_v = init_linear(generator, di, di, **lin)
        self.w_gates = init_linear(generator, di, 2 * n_heads, bias=True,
                                   **lin)
        self.out_norm = init_norm("rms", di, device=device)
        self.w_down = init_linear(generator, di, d_model, **lin)

    def _whole(self, xv, xc):
        """xv and the conv's output, every channel: gathered in one
        all_gather where they are the rank's block.  They feed the rank's
        heads (column-parallel q, k, v and gates), so their gradient is
        the ranks' parts summed (``alike=False``: a reduce-scatter)."""
        if xv.shape[-1] == self.di:
            return xv, xc
        return tuple(collectives.all_gather_last(
            [xv, xc], model_shard()[2], alike=False))

    def _project(self, xv, xc, shape, policy):
        """q, k, v (``shape`` + (heads, dh): the rank's heads) and the
        input and log forget gates (``shape`` + (heads,)) from xv and the
        conv's output, both of every channel."""
        dh = self.di // self.n_heads
        h = self.w_q["w"].shape[-1] // dh
        q = linear(self.w_q, xc, policy=policy).reshape(*shape, h, dh)
        k = linear(self.w_k, xc, policy=policy).reshape(*shape, h, dh)
        v = linear(self.w_v, xv, policy=policy).reshape(*shape, h, dh)
        gates = linear(self.w_gates, xc, policy=policy).float()
        igate, fraw = torch.chunk(gates, 2, dim=-1)
        return q, k, v, igate, F.logsigmoid(fraw)

    def _qkv_gates(self, xv, policy):
        b, l, _ = xv.shape
        xc = depthwise1d_causal(xv, self.conv.to(xv.dtype), policy=policy)
        xc = F.silu(xc)
        return self._project(*self._whole(xv, xc), (b, l), policy)

    def forward(self, x, *, chunk: int = 128,
                policy: KernelPolicy = DEFAULT_POLICY,
                return_cache: bool = False):
        xn = enter_model_axis(
            gather_seq(rms_norm(x, seq_params(self.norm)["scale"])),
            split=self.conv.shape[-1] != self.di)     # the rank's columns
        up = linear(self.w_up, xn, policy=policy)
        xv, xz = torch.chunk(up, 2, dim=-1)           # (B,L,di)
        xv = xv.contiguous()
        q, k, v, igate, logf = self._qkv_gates(xv, policy)
        h, (c, n, m) = mlstm_chunkwise(q, k, v, igate, logf, chunk=chunk)
        b, l = xn.shape[:2]
        h = rms_norm_split(h.reshape(b, l, -1).to(x.dtype),
                           self.out_norm["scale"])
        h = h * F.silu(xz)
        out = x + row_linear(self.w_down, h, self.di, d_out=self.d_model,
                             policy=policy)
        if return_cache:
            return out, {"c": c, "n": n, "m": m,
                         "conv": conv_tail(xv, self.cfg.conv_k)}
        return out

    def step(self, x_t, cache: dict, *,
             policy: KernelPolicy = DEFAULT_POLICY):
        """x_t (B, 1, d) -> (B, 1, d); cache from :func:`init_mlstm_cache`."""
        b = x_t.shape[0]
        xn = rms_norm(x_t, self.norm["scale"])
        up = linear(self.w_up, xn, policy=policy)
        xv, xz = torch.chunk(up, 2, dim=-1)
        xv = xv[:, 0].contiguous()                    # (B, di)
        conv_state, xc = depthwise1d_step(
            cache["conv"].to(xv.dtype), xv, self.conv.to(xv.dtype))
        xc = F.silu(xc)
        q, k, v, igate, logf = self._project(*self._whole(xv, xc), (b,),
                                             policy)
        h, (c, n, m) = mlstm_step(q, k, v, igate, logf,
                                  (cache["c"], cache["n"], cache["m"]))
        h = rms_norm_split(h.reshape(b, 1, -1).to(x_t.dtype),
                           self.out_norm["scale"])
        h = h * F.silu(xz)
        out = x_t + row_linear(self.w_down, h, self.di, d_out=self.d_model,
                               policy=policy)
        return out, {"c": c, "n": n, "m": m, "conv": conv_state.float()}


def init_mlstm_cache(batch: int, d_model: int, n_heads: int,
                     cfg: XLSTMConfig, device="cuda") -> dict:
    di = int(d_model * cfg.proj_factor)
    c, n, m = init_mlstm_state(batch, n_heads, di // n_heads, device)
    return {"c": c, "n": n, "m": m,
            "conv": torch.zeros((batch, max(cfg.conv_k - 1, 1), di),
                                device=device)}


class SLSTMBlock(nn.Module):
    """x (B, L, d) -> (B, L, d): the sLSTM cell, then a post-up-projection
    GLU FFN (factor 4/3), each with a residual (``repro``'s
    ``init_slstm_block`` / ``slstm_block`` / ``slstm_block_step``)."""

    #: Leaves cut part by part under a model axis: the gates' ``[z | i |
    #: f | o]``.
    SPLIT_PARTS = {"w_gates.w": 4, "w_gates.b": 4}

    def __init__(self, d_model: int, n_heads: int, cfg: XLSTMConfig, *,
                 generator: torch.Generator, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dh = d_model // n_heads
        ff = int(d_model * 4 / 3 / 64) * 64 or d_model
        self.d_model, self.n_heads, self.cfg, self.ff = (d_model, n_heads,
                                                         cfg, ff)
        lin = dict(dtype=dtype, device=device)
        self.norm = init_norm("rms", d_model, device=device)
        self.conv = param(randn(generator, (cfg.conv_k, d_model),
                                cfg.conv_k ** -0.5, torch.float32, device))
        self.w_gates = init_linear(generator, d_model, 4 * d_model, bias=True,
                                   **lin)
        self.r = param(randn(generator, (n_heads, dh, 4 * dh), dh ** -0.5,
                             torch.float32, device))
        self.out_norm = init_norm("rms", d_model, device=device)
        self.ffn_norm = init_norm("rms", d_model, device=device)
        self.w_ff_gate = init_linear(generator, d_model, ff, **lin)
        self.w_ff_up = init_linear(generator, d_model, ff, **lin)
        self.w_ff_down = init_linear(generator, ff, d_model, **lin)

    def _ffn(self, x, policy):
        xn = enter_model_axis(
            gather_seq(rms_norm(x, seq_params(self.ffn_norm)["scale"])),
            split=self.w_ff_gate["w"].shape[1] != self.ff)
        g = linear(self.w_ff_gate, xn, activation="silu", policy=policy)
        u = linear(self.w_ff_up, xn, policy=policy)
        return x + row_linear(self.w_ff_down, g * u, self.ff,
                              d_out=self.d_model, policy=policy)

    def _channels(self, xn):
        """The conv's input: the rank's block of ``xn``'s channels,
        contiguous (``xn`` itself where the filter is whole; ``split``, so
        that the gradient is gathered whole, or, where ``xn`` is a
        sequence-parallel gather's output, the block's gradient alone)."""
        if self.conv.shape[-1] == self.d_model:
            return enter_model_axis(xn, split=False)
        return collectives.split(xn, model_shard()[2], dim=-1,
                                 gathered=seq_shard() is not None)

    def _whole(self, t, alike: bool = True):
        """``t`` (..., width) at every channel: gathered where it holds
        the rank's block of d_model.  The cell's output is used alike by
        every rank; the conv's feeds the rank's heads of the gates
        (``alike=False``: its gradient's parts summed)."""
        if t.shape[-1] == self.d_model:
            return t
        return collectives.all_gather(t, model_shard()[2], dim=-1,
                                      alike=alike)

    def _gates(self, xc, shape, policy):
        """The four gates' pre-activations at the rank's heads (``shape``
        + (heads, dh)) from the conv's output."""
        dh = self.d_model // self.n_heads
        gates = linear(self.w_gates, self._whole(xc, alike=False),
                       policy=policy).float()
        h = gates.shape[-1] // (4 * dh)
        return tuple(g.reshape(*shape, h, dh)
                     for g in torch.chunk(gates, 4, dim=-1))

    def forward(self, x, *, chunk: int = 128,
                policy: KernelPolicy = DEFAULT_POLICY,
                return_cache: bool = False):
        xn = self._channels(gather_seq(rms_norm(
            x, seq_params(self.norm)["scale"])))
        b, l, _ = xn.shape
        xc = F.silu(depthwise1d_causal(xn, self.conv.to(xn.dtype),
                                       policy=policy))
        zg, ig, fg, og = self._gates(xc, (b, l), policy)
        h, (c, n, hs, m) = slstm_scan(zg, ig, fg, og, self.r, chunk=chunk)
        h = seq_block(self._whole(h.reshape(b, l, -1).to(x.dtype)))
        out = self._ffn(x + rms_norm(h, seq_params(self.out_norm)["scale"]),
                        policy)
        if return_cache:
            return out, {"c": c, "n": n, "h": hs, "m": m,
                         "conv": conv_tail(xn, self.cfg.conv_k)}
        return out

    def step(self, x_t, cache: dict, *,
             policy: KernelPolicy = DEFAULT_POLICY):
        """x_t (B, 1, d) -> (B, 1, d); cache from :func:`init_slstm_cache`."""
        b = x_t.shape[0]
        xn = self._channels(rms_norm(x_t, self.norm["scale"]))
        conv_state, xc = depthwise1d_step(
            cache["conv"].to(xn.dtype), xn[:, 0], self.conv.to(xn.dtype))
        zg, ig, fg, og = self._gates(F.silu(xc), (b,), policy)
        h, (c, n, hs, m) = slstm_step(
            zg, ig, fg, og, self.r,
            (cache["c"], cache["n"], cache["h"], cache["m"]))
        h = self._whole(h.reshape(b, 1, -1).to(x_t.dtype))
        out = self._ffn(x_t + rms_norm(h, self.out_norm["scale"]), policy)
        return out, {"c": c, "n": n, "h": hs, "m": m,
                     "conv": conv_state.float()}


def init_slstm_cache(batch: int, d_model: int, n_heads: int,
                     cfg: XLSTMConfig, device="cuda") -> dict:
    c, n, h, m = init_slstm_state(batch, n_heads, d_model // n_heads, device)
    return {"c": c, "n": n, "h": h, "m": m,
            "conv": torch.zeros((batch, max(cfg.conv_k - 1, 1), d_model),
                                device=device)}
