"""Mixture-of-Experts with expert parallelism (EP).  Counterpart of
``repro/models/moe.py``: the reference's per-device body (``_moe_local``)
and its ``moe_forward``.  Under a mesh the experts are split over the
model axis (``w_*_e`` (E, ., .) -> the rank's E/tp experts) and, where the
rules give them the data axis too (``expert_fsdp_axis``), over their dim 1,
which is gathered over "data" before use (the all-gather that the
reference's ``shard_map`` in_specs imply).  The tokens enter split over the
batch (data) and, where the sequence divides, over the sequence (model);
each rank routes its own tokens, and two ``all_to_all_single`` exchanges
over the model axis carry the routed copies (with their local expert ids,
as payload bytes) to their experts' owners and the outputs back.  On one
device, or an axis of one rank, both exchanges are the identity.

Dispatch is the reference's sort-free rank-by-position scheme with fixed
capacities: each routed copy of a token takes the rank of its position
among the copies bound for the same expert; copies ranked past the
expert's capacity are dropped.  Every shape is static and nothing reads a
value back to the host (no boolean indexing, ``nonzero`` or ``.item()``),
so a prefill or decode step with MoE layers captures as a CUDA graph.
The reference scatters with ``mode="drop"``; here a dropped copy is
written to a dump row past the end of the buffer, which is then cut off.

The router is a plain fp32 product, as the reference's (``moe.py:145``),
not a ``pwconv`` launch.  The expert GEMMs are batched ``torch.bmm``s over
the capacity buffers: the reference computes them as plain einsums outside
any Pallas kernel, with fp32 products (``preferred_element_type``), so
here both operands are upcast to fp32 (exact for bf16) and the product is
fp32.  The shared expert is an :class:`~repro_torch.models.mlp.MLP`, whose
three projections run on the ``pwconv`` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.models.layers import init_linear, param, randn
from repro_torch.models.mlp import MLP
from repro_torch.sharding import collectives


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """The reference's ``init_moe``: ``router`` (a fp32 Linear ``{"w"}``,
    d -> E), ``w_gate_e`` / ``w_up_e`` (E, d, ff), ``w_down_e`` (E, ff, d)
    and, with shared experts, ``shared`` (an MLP of width ``d_ff_shared``)."""

    def __init__(self, d_model: int, cfg: MoEConfig, d_ff_shared: int, *,
                 generator: torch.Generator, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        e, ff = cfg.n_experts, cfg.d_ff_expert
        std = d_model ** -0.5
        self.router = init_linear(generator, d_model, e, dtype=torch.float32,
                                  device=device)
        self.w_gate_e = param(randn(generator, (e, d_model, ff), std, dtype,
                                    device))
        self.w_up_e = param(randn(generator, (e, d_model, ff), std, dtype,
                                  device))
        self.w_down_e = param(randn(generator, (e, ff, d_model), ff ** -0.5,
                                    dtype, device))
        if cfg.n_shared:
            self.shared = MLP(d_model, d_ff_shared, generator=generator,
                              dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def router_topk(logits: torch.Tensor, top_k: int, norm_topk: bool):
    """logits (T, E) -> (weights (T,k) f32, ids (T,k) int64, probs (T,E)
    f32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    return weights, ids, probs


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """ids (...) -> (..., n) bool, by comparison: ``F.one_hot`` may read
    the ids' range back to the host, which a capture forbids."""
    return ids[..., None] == torch.arange(n, device=ids.device)


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    f = _one_hot(ids, n_experts).float().sum(1).mean(0)
    pbar = probs.mean(0)
    return n_experts * torch.sum(f * pbar)


def _router_logits(p: MoE, xt: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    return xt.float() @ (p.router["w"] if w is None else w)


# ---------------------------------------------------------------------------
# Dense reference (exact; no capacity) — test oracle
# ---------------------------------------------------------------------------


def moe_dense_ref(p: MoE, x: torch.Tensor, cfg: MoEConfig,
                  policy: KernelPolicy = DEFAULT_POLICY):
    """x (..., d).  Computes every expert for every token in fp32 and
    combines by router weights.  O(E) flops — oracle only."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    weights, ids, probs = router_topk(_router_logits(p, xt), cfg.top_k,
                                      cfg.norm_topk)
    xf = xt.float()
    g = torch.einsum("td,edf->tef", xf, p.w_gate_e.float())
    u = torch.einsum("td,edf->tef", xf, p.w_up_e.float())
    h = F.silu(g) * u
    y_all = torch.einsum("tef,efd->ted", h, p.w_down_e.float())
    onehot = _one_hot(ids, cfg.n_experts).float()
    cw = (onehot * weights[..., None]).sum(1)            # (T, E)
    y = torch.einsum("te,ted->td", cw, y_all)
    out = y.to(x.dtype).reshape(*lead, d)
    if cfg.n_shared:
        out = out + p.shared(x, policy=policy)
    aux = load_balance_loss(probs, ids, cfg.n_experts)
    return out, {"aux_loss": aux,
                 "drop_frac": torch.zeros((), device=x.device)}


# ---------------------------------------------------------------------------
# Capacity dispatch: sort-free ranks, fixed capacities, all_to_all
# ---------------------------------------------------------------------------


def _ranks_by_group(group_ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Rank of each element within its group (stable, by position)."""
    onehot = _one_hot(group_ids, n_groups).long()           # (N, G)
    ranks = torch.cumsum(onehot, dim=0) - 1                 # (N, G)
    return torch.gather(ranks, 1, group_ids[:, None])[:, 0]


def _capacity(n: int, share: int, capacity_factor: float) -> int:
    """The reference's capacity of ``share`` equal parts of ``n`` copies:
    the balanced share times the capacity factor, rounded up to a multiple
    of 8 (at least 8) and at most ``n``."""
    cap = int(-(-n // share) * capacity_factor)
    return min(max(8, (cap + 7) // 8 * 8), n)


def _scatter_rows(rows: torch.Tensor, index: torch.Tensor,
                  n: int) -> torch.Tensor:
    """A (n, ...) buffer of zeros with ``rows[i]`` at row ``index[i]``; an
    index of ``n`` (a dropped row) lands in a dump row that is cut off (the
    reference's ``.at[].set(mode="drop")``)."""
    buf = rows.new_zeros((n + 1, *rows.shape[1:]))
    buf.index_copy_(0, index, rows)
    return buf[:n]


def _pack_exchange(x: torch.Tensor, ids: torch.Tensor, group):
    d = x.shape[1]
    raw = torch.cat([x.detach().contiguous().view(torch.uint8),
                     ids.to(torch.int32)[:, None].view(torch.uint8)], dim=1)
    raw = collectives.all_to_all(raw, group)
    width = d * x.element_size()
    return (raw[:, :width].contiguous().view(x.dtype),
            raw[:, width:].contiguous().view(torch.int32)[:, 0].long())


class _Exchange(torch.autograd.Function):
    """The packed exchange with the gradient of the rows: the same
    exchange of it, the other way (the ids carry none)."""

    @staticmethod
    def forward(ctx, x, ids, group):
        ctx.group = group
        out, got = _pack_exchange(x, ids, group)
        ctx.mark_non_differentiable(got)
        return out, got

    @staticmethod
    def backward(ctx, g, _):
        return collectives.all_to_all(g.contiguous(), ctx.group), None, None


def _exchange(x: torch.Tensor, ids: torch.Tensor, group):
    """The dispatch's all_to_all: rows of ``x`` (N, d) and their int ids
    (N,) travel in one exchange, each id as four bytes beside its row;
    differentiable in ``x`` (:class:`_Exchange`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Exchange.apply(x, ids, group)
    return _pack_exchange(x, ids, group)


def _moe_local(p: MoE, xt: torch.Tensor, cfg: MoEConfig, tp: int = 1,
               group=None, experts: tuple = None,
               router_w: Optional[torch.Tensor] = None):
    """The reference's per-device MoE body: xt (T_l, d) local tokens ->
    (y (T_l, d) f32, aux loss, drop fraction), both fp32 scalars on the
    device.  ``tp`` ranks of the model axis (``group``, None for one) own
    E/tp experts each; ``experts`` are this rank's (w_gate_e, w_up_e,
    w_down_e) whole (default: ``p``'s own), ``router_w`` the router's
    weight (default ``p``'s).  Collectives: 2x ``all_to_all`` over
    ``group``."""
    t_l, d = xt.shape
    e = cfg.n_experts
    e_local = e // tp
    k = cfg.top_k
    wg, wu, wd = experts or (p.w_gate_e, p.w_up_e, p.w_down_e)

    weights, ids, probs = router_topk(_router_logits(p, xt, router_w), k,
                                      cfg.norm_topk)
    aux = load_balance_loss(probs, ids, e)

    # ---- copies -> destination slots --------------------------------------
    n_copies = t_l * k
    flat_ids = ids.reshape(-1)                       # expert id per copy
    flat_w = weights.reshape(-1)
    src_token = torch.arange(n_copies, device=xt.device) // k
    owner = flat_ids // e_local                      # destination device
    cap_send = _capacity(n_copies, tp, cfg.capacity_factor)
    rank = _ranks_by_group(owner, tp)
    keep = rank < cap_send
    slot = owner * cap_send + torch.clamp(rank, 0, cap_send - 1)
    t_r = tp * cap_send
    send_slot = torch.where(keep, slot, t_r)
    send_x = _scatter_rows(xt[src_token], send_slot, t_r)
    # metadata: local expert id (+1, 0 = invalid)
    send_e = _scatter_rows(flat_ids % e_local + 1, send_slot, t_r)

    # ---- all_to_all to expert owners ---------------------------------------
    if group is not None:
        recv_x, recv_e = _exchange(send_x, send_e, group)
    else:
        recv_x, recv_e = send_x, send_e

    # ---- pack into per-expert capacity buffers ----------------------------
    cap_e = _capacity(t_r, max(e_local, 1), cfg.capacity_factor)
    valid_r = recv_e > 0
    eloc = torch.clamp(recv_e - 1, 0, e_local - 1)
    rank_e = _ranks_by_group(torch.where(valid_r, eloc, e_local),
                             e_local + 1)
    keep_r = valid_r & (rank_e < cap_e)
    pos = eloc * cap_e + torch.clamp(rank_e, 0, cap_e - 1)
    ebuf = _scatter_rows(recv_x, torch.where(keep_r, pos, e_local * cap_e),
                         e_local * cap_e)

    # ---- expert compute (batched over local experts), fp32 products -------
    eb = ebuf.reshape(e_local, cap_e, d).float()
    g = torch.bmm(eb, wg.float())
    u = torch.bmm(eb, wu.float())
    h = (F.silu(g) * u).to(xt.dtype)
    y_e = torch.bmm(h.float(), wd.float())
    # the routed outputs in the payload dtype; the combine stays fp32
    y_e = y_e.to(xt.dtype).reshape(e_local * cap_e, d)

    # ---- route back ---------------------------------------------------------
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    y_recv = torch.where(keep_r[:, None],
                         y_e[torch.clamp(pos, 0, e_local * cap_e - 1)], zero)
    y_send = collectives.all_to_all(y_recv, group)
    y_copy = torch.where(keep[:, None],
                         y_send[torch.clamp(slot, 0, t_r - 1)].float(), 0.0)
    # combine: copy c of token t sits at row t*k + c, so the reference's
    # scatter-add over src_token is a sum over each token's k rows
    y = (y_copy * flat_w[:, None]).reshape(t_l, k, d).sum(1)
    send_keep = keep.float().mean()
    recv_keep = keep_r.float().sum() / torch.clamp(valid_r.float().sum(),
                                                   min=1.0)
    drop = 1.0 - send_keep * recv_keep
    return y, aux, drop


def moe_forward(p: MoE, x: torch.Tensor, cfg: MoEConfig, *, mesh=None,
                data_axes: tuple = (), model_axis: Optional[str] = None,
                expert_axis: Optional[str] = None,
                policy: KernelPolicy = DEFAULT_POLICY):
    """x (B, S, d) -> (y (B, S, d), {"aux_loss", "drop_frac"}).  EP over
    ``model_axis`` of ``mesh`` (a ``launch.mesh.Mesh``; None: one device),
    ``x`` being this rank's batch block (split over ``data_axes``): the
    sequence is split over the model axis where ``s % tp == 0 and s >=
    tp`` (else, as in a decode step, every rank routes all its tokens) and
    the outputs gathered back; the experts' dim 1 is gathered over
    ``expert_axis`` where the rules split it; ``aux_loss`` and
    ``drop_frac`` are averaged over the data and model axes (the
    reference's ``pmean``).

    Gradients (training under the mesh) follow the collectives'
    (``sharding/collectives.py``): the rank's block of the sequence is a
    ``split`` (its gradient gathered back), the router's replicated weight
    enters the split region (``copy_to_split``: each rank's tokens give a
    part of its gradient), both ``all_to_all``s carry the gradient back the
    other way, the experts' fsdp gather reduce-scatters theirs over "data",
    and the outputs' gather over the model axis keeps the rank's block.
    Where the sequence does not split, every rank routes all the tokens of
    its rows, as the reference's ``shard_map`` does at ``seq_spec`` None:
    each expert then receives a copy of every token from each rank of the
    model axis, capacity included (the reference's own arithmetic); ``x``
    enters through ``copy_to_split`` and the output leaves through
    ``computed_alike``, so each rank's routing takes 1/tp of the output's
    gradient and the ranks' parts of ``x``'s and the router's sum back
    (the reference's transpose of an output replicated over the axis)."""
    b, s, d = x.shape
    if mesh is None or model_axis is None:
        y, aux, drop = _moe_local(p, x.reshape(-1, d), cfg)
        out = y.to(x.dtype).reshape(b, s, d)
    else:
        tp = mesh.shape[model_axis]
        group = mesh.group(model_axis)
        if cfg.n_experts % tp:
            raise ValueError(f"{cfg.n_experts} experts do not split over "
                             f"{tp} ranks")
        split = s % tp == 0 and s >= tp
        xl = (collectives.split(x, group, dim=1) if split
              else collectives.copy_to_split(x, group))
        full = {"w_gate_e": d, "w_up_e": d, "w_down_e": cfg.d_ff_expert}
        experts = tuple(
            collectives.all_gather(getattr(p, n), mesh.group(expert_axis),
                                   dim=1, alike=False)
            if getattr(p, n).shape[1] != full[n] else getattr(p, n)
            for n in full)
        y, aux, drop = _moe_local(
            p, xl.reshape(-1, d), cfg, tp=tp, group=group, experts=experts,
            router_w=collectives.copy_to_split(p.router["w"], group))
        out = y.to(x.dtype).reshape(xl.shape)
        out = (collectives.all_gather(out, group, dim=1) if split
               else collectives.computed_alike(out, group))
        groups = [mesh.group(a) for a in (*data_axes, model_axis)]
        aux, drop = collectives.pmean(torch.stack([aux, drop]), groups)
    if cfg.n_shared:
        out = out + p.shared(x, policy=policy)
    return out, {"aux_loss": aux, "drop_frac": drop}
