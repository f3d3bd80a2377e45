"""Selective SSM (Mamba-style) mixer — the DWConv-1d consumer.
Counterpart of ``repro/models/ssm.py``, used by hymba-1.5b's Mamba heads.

The conv pre-activation is the paper's depthwise convolution
(``core/dwconv.depthwise1d_causal``: the ``dwconv1d`` kernel on the card;
decode takes the plain one-row ``depthwise1d_step``, as the reference
does).  Its four Linears run through ``pointwise`` (the ``pwconv``
kernel).  The selective scan has no TPU kernel: it is plain PyTorch,
chunked as the reference chunks it: a loop over time chunks carrying the
(B, d_inner, N) state, with a log-depth scan inside each chunk, which
bounds the (B, chunk, d_inner, N) discretized tensors.  It is never a
loop over tokens: a captured prefill holds every node of it.

Training differentiates each chunk's scan through :class:`ChunkScanFn`:
its forward is the serving scan on fresh tensors (the same bits), its
backward the reverse linear recurrence ``g_t = dh_t + a_{t+1} g_{t+1}``
(``db_t = g_t``, ``da_t = g_t h_{t-1}``, the carried state's ``a_0 g_0``)
by the same doubling steps run from the chunk's end.  It keeps the chunk's
states, one (B, chunk, d_inner, N) fp32 tensor, where autograd through the
doubling steps would keep two for every step.

Under a model axis of tp > 1 ranks (the sharding rules' layout, the
paper's DWConv split over channels: ``conv``, ``a_log``, ``d_skip`` and
``dt_bias`` hold the rank's block of d_inner/tp channels) each rank runs
the mixer on its channels, with the collectives at the layer's edges:

* ``w_in`` is cut part by part (``SPLIT_PARTS``): the rank holds block r
  of x's columns and block r of z's, side by side, so its ``xz`` is its
  channels of x and of z and the projection needs no collective;
* ``dwconv1d`` runs on the rank's (B, L, d_inner/tp) block, contiguous;
  the selective scan on its channels, the state (B, d_inner/tp, N) its
  block: no collective inside either;
* ``w_bcdt`` reads every channel: the conv's output is gathered once
  (all_gather 1); where its 2N + dt_rank columns split, the rank's
  columns of ``bcdt`` are gathered too (all_gather 2);
* ``w_dt`` is row-parallel (``layers.row_linear``: the rank's rows of
  dt_rank, fp32 partial sums all-reduced, all_reduce 3), and the rank
  keeps its channels of the sum;
* ``w_out`` is row-parallel on the rank's channels (all_reduce 4), so the
  mixer's output is whole on every rank.

A prefill and a decode step make the same four collectives a layer, at
any length.

Training differentiates through them under the sharded convention
(``sharding/collectives.py``: every rank's loss is the global scalar).
``x`` enters ``w_in``'s rank columns through ``copy_to_split``; the
conv's gathered output feeds ``w_bcdt``'s rank columns, so that gather's
backward reduce-scatters; b and c, whole on every rank, enter the rank's
channels of the scan through ``copy_to_split``; the rank's channels of
``w_dt``'s whole output are ``split`` off.  A training forward makes the
serving forward's four (2 all_reduce, 2 all_gather); its backward 2
all_reduce (x's and b, c's sums), 2 all_gather (``w_dt``'s input and
output splits) and 1 reduce_scatter.  ``dwconv1d``'s forward and its
backward run on the rank's (B, L, d_inner/tp) block, contiguous.

Under sequence parallelism (``layers.sequence_parallel``) the mixer takes
the normed residual gathered whole (``layers.gather_seq``): the scan runs
over the whole sequence on the rank's channels as without it, and
``w_out``'s partial sums are reduce-scattered to the rank's block of the
sequence in place of all_reduce 4 (``w_dt``'s sum stays an all_reduce:
its output feeds the scan).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.core.dwconv import (conv_tail, depthwise1d_causal,
                                     depthwise1d_step)
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models.layers import (enter_model_axis, init_linear,
                                       linear, param, rand, randn,
                                       row_linear)
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import model_shard


class Mamba(nn.Module):
    """The mixer's parameters (the reference's ``init_mamba``): ``w_in``
    (d -> 2 d_inner), ``conv`` (K, d_inner) fp32, ``w_bcdt`` (d_inner ->
    2N + dt_rank), ``w_dt`` (dt_rank -> d_inner), ``dt_bias`` fp32 (so that
    softplus(bias) spans [dt_min, dt_max]), ``a_log`` (d_inner, N) fp32,
    ``d_skip`` fp32 and ``w_out`` (d_inner -> d)."""

    #: Leaves cut part by part under a model axis: ``w_in``'s ``[x | z]``.
    SPLIT_PARTS = {"w_in.w": 2}

    def __init__(self, d_model: int, cfg: SSMConfig, *,
                 generator: torch.Generator, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        di, n = d_model * cfg.expand, cfg.d_state
        dt_rank = max(1, d_model // 16)
        self.d_inner, self.dt_rank = di, dt_rank
        lin = dict(dtype=dtype, device=device)
        self.w_in = init_linear(generator, d_model, 2 * di, **lin)
        self.conv = param(randn(generator, (cfg.conv_k, di),
                                cfg.conv_k ** -0.5, torch.float32, device))
        self.w_bcdt = init_linear(generator, di, 2 * n + dt_rank, **lin)
        self.w_dt = init_linear(generator, dt_rank, di, **lin)
        self.w_out = init_linear(generator, di, d_model, **lin)
        u = rand(generator, (di,), device)
        lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
        dt0 = torch.exp(u * (hi - lo) + lo)
        self.dt_bias = param(dt0 + torch.log(-torch.expm1(-dt0)))
        self.a_log = param(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).expand(
                di, n).clone())
        self.d_skip = param(torch.ones(di, device=device))


def _chunk_scan(da: torch.Tensor, dbu: torch.Tensor) -> torch.Tensor:
    """``h_t = da_t * h_{t-1} + dbu_t`` along dim 1 from ``h_{-1} = 0``, for
    every t of the chunk: log2(chunk) doubling steps, each combining every
    element with the one ``k`` before it by the reference's associative
    operator ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``.  Overwrites its
    arguments; returns ``dbu`` holding every h_t."""
    a, h = da, dbu
    n, k = h.shape[1], 1
    while k < n:
        h[:, k:].add_(a[:, k:] * h[:, :-k])
        if 2 * k < n:
            a[:, k:].copy_(a[:, k:] * a[:, :-k])
        k *= 2
    return h


def _chunk_scan_rev(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g_t = g_t + a_t * g_{t+1}`` along dim 1 from the chunk's end, for
    every t: :func:`_chunk_scan` mirrored, each element combined with the
    one ``k`` after it.  Overwrites its arguments; returns ``g``."""
    n, k = g.shape[1], 1
    while k < n:
        g[:, :-k].add_(a[:, :-k] * g[:, k:])
        if 2 * k < n:
            a[:, :-k].copy_(a[:, :-k] * a[:, k:])
        k *= 2
    return g


class ChunkScanFn(torch.autograd.Function):
    """One chunk's states ``h_t = da_t h_{t-1} + dbu_t`` (``h_{-1}`` the
    carried state h, (B, di, N)) for da, dbu (B, chunk, di, N), with their
    gradients."""

    @staticmethod
    def forward(ctx, da, dbu, h):
        hs = dbu.clone()
        hs[:, 0].addcmul_(da[:, 0], h)
        _chunk_scan(da.clone(), hs)
        ctx.save_for_backward(da, hs, h)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        da, hs, h = ctx.saved_tensors
        a = torch.empty_like(da)
        a[:, :-1].copy_(da[:, 1:])
        a[:, -1].zero_()
        g = _chunk_scan_rev(a, dhs.clone())
        dda = torch.empty_like(g)
        torch.mul(g[:, 1:], hs[:, :-1], out=dda[:, 1:])
        torch.mul(g[:, 0], h, out=dda[:, 0])
        dh = da[:, 0] * g[:, 0] if ctx.needs_input_grad[2] else None
        return dda, g, dh


def selective_scan(u, dt, a, b, c, d_skip, *, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None):
    """u (B, L, di) conv+silu output; dt (B, L, di) softplus'd step sizes;
    a (di, N) negative; b, c (B, L, N); d_skip (di,); h0 (B, di, N).
    Returns (y (B, L, di) fp32, h_last (B, di, N) fp32).

    Each chunk folds the carried state into its first step (``h_0 = da_0
    h_carry + dbu_0``), where the reference adds ``a_cum * h_carry`` to
    every step after its scan: the same sums, rounded in another order.
    The padded tail has dt = 0, so it carries the state through
    unchanged.  Under autograd each chunk's scan is :class:`ChunkScanFn`
    (the same bits); otherwise it runs in place on the chunk's tensors."""
    nb, l, di = u.shape
    chunk = min(chunk, l)
    pad = (-l) % chunk
    uf, dtf, bf, cf = (F.pad(t.float(), (0, 0, 0, pad))
                       for t in (u, dt, b, c))
    h = (torch.zeros((nb, di, a.shape[1]), device=u.device) if h0 is None
         else h0.float())
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (u, dt, a, b, c, h0))
    ys = []
    for j in range(0, l + pad, chunk):
        uc, dtc, bc, cc = (t[:, j:j + chunk] for t in (uf, dtf, bf, cf))
        da = torch.exp(dtc[..., None] * a)                     # (nb,c,di,N)
        dbu = (dtc * uc)[..., None] * bc[:, :, None, :]        # (nb,c,di,N)
        if grad:
            hs = ChunkScanFn.apply(da, dbu, h)
        else:
            dbu[:, 0].addcmul_(da[:, 0], h)
            hs = _chunk_scan(da, dbu)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, cc))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :l] + uf[:, :l] * d_skip
    return y, h.clone()


def selective_step(h, u_t, dt_t, a, b_t, c_t, d_skip):
    """One decode step. h (B,di,N); u_t/dt_t (B,di); b_t/c_t (B,N)."""
    da = torch.exp(dt_t[..., None] * a)                        # (B,di,N)
    dbu = (dt_t * u_t)[..., None] * b_t[:, None, :]
    h = da * h + dbu
    y = torch.einsum("bdn,bn->bd", h, c_t) + u_t * d_skip
    return h, y


def _proj_scan_inputs(p: Mamba, xi: torch.Tensor, cfg: SSMConfig, policy):
    """xi (..., di) conv+silu output (under a model axis the rank's
    channels) -> (dt at the same channels, b, c), fp32.  The dt columns
    of ``w_bcdt``'s output are copied out before ``w_dt``'s kernel reads
    them (a column slice is a strided view).

    Gradients under the model axis: the gathered channels feed
    ``w_bcdt``'s rank columns, so their gradient is the ranks' parts
    summed (the gather's backward a reduce-scatter, ``alike=False``); b
    and c, whole on every rank, enter the rank's own channels of the scan
    (``copy_to_split``); the rank's channels of ``w_dt``'s whole output
    are ``split`` off (their gradient gathered whole)."""
    n = cfg.d_state
    group = model_shard()[2]
    width = xi.shape[-1]
    local = width != p.d_inner
    cols = p.w_bcdt["w"].shape[-1] != 2 * n + p.dt_rank
    xin = (collectives.all_gather(xi, group, dim=-1, alike=not cols)
           if local else xi)
    bcdt = linear(p.w_bcdt, xin, policy=policy)
    if cols:                                    # the rank's columns
        bcdt = collectives.all_gather(bcdt, group, dim=-1)
    bc, dt_low = torch.split(bcdt.float(), [2 * n, p.dt_rank], dim=-1)
    if local:
        bc = collectives.copy_to_split(bc, group)
    b, c = torch.split(bc, [n, n], dim=-1)
    dt = row_linear(p.w_dt, dt_low.to(xi.dtype).contiguous(), p.dt_rank,
                    d_out=p.d_inner, policy=policy, seq_out=False)
    if local:                                   # the rank's channels
        dt = collectives.split(dt, group, dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    return dt, b, c


def mamba_mixer(p: Mamba, x: torch.Tensor, cfg: SSMConfig, *,
                policy: KernelPolicy = DEFAULT_POLICY,
                h0: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence mixer. x (B, L, d) -> (B, L, d); under a model axis
    ``x`` and the output are whole and the state is the rank's channels
    (``x`` entering ``w_in``'s rank columns through ``copy_to_split``).

    return_state: also return the decode cache {h, conv} after the last
    position (conv = last K-1 *pre-conv* inputs, matching
    :func:`mamba_mixer_step`)."""
    x = enter_model_axis(x, split=p.conv.shape[-1] != p.d_inner)
    xz = linear(p.w_in, x, policy=policy)
    xi_raw, z = torch.chunk(xz, 2, dim=-1)                     # (B, L, di)
    xi_raw = xi_raw.contiguous()
    xi = F.silu(depthwise1d_causal(xi_raw, p.conv.to(xi_raw.dtype),
                                   policy=policy))
    dt, b, c = _proj_scan_inputs(p, xi, cfg, policy)
    a = -torch.exp(p.a_log)
    y, h_last = selective_scan(xi, dt, a, b, c, p.d_skip, chunk=cfg.chunk,
                               h0=h0)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = row_linear(p.w_out, y, p.d_inner, d_out=x.shape[-1],
                     policy=policy)
    if return_state:
        return out, {"h": h_last, "conv": conv_tail(xi_raw,
                                                    p.conv.shape[0])}
    return out


def init_mamba_state(batch: int, d_model: int, cfg: SSMConfig,
                     device="cuda") -> dict:
    di = d_model * cfg.expand
    return {"h": torch.zeros((batch, di, cfg.d_state), device=device),
            "conv": torch.zeros((batch, max(cfg.conv_k - 1, 1), di),
                                device=device)}


def mamba_mixer_step(p: Mamba, x_t: torch.Tensor, state: dict,
                     cfg: SSMConfig, *,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """One decode step. x_t (B, 1, d); state from :func:`init_mamba_state`."""
    xz = linear(p.w_in, x_t[:, 0], policy=policy)              # (B, 2di)
    xi, z = torch.chunk(xz, 2, dim=-1)
    conv_state, xi = depthwise1d_step(state["conv"].to(xi.dtype), xi,
                                      p.conv.to(xi.dtype))
    xi = F.silu(xi)
    dt, b, c = _proj_scan_inputs(p, xi, cfg, policy)
    a = -torch.exp(p.a_log)
    h, y = selective_step(state["h"], xi.float(), dt, a, b, c, p.d_skip)
    y = (y * F.silu(z.float())).to(x_t.dtype)
    out = row_linear(p.w_out, y, p.d_inner, d_out=x_t.shape[-1],
                     policy=policy)[:, None, :]
    return out, {"h": h, "conv": conv_state.float()}
