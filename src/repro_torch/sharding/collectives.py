"""The collectives of sharded serving and training, over
``torch.distributed``.

The reference writes none of these: GSPMD inserts them where its
partitioner needs them, and the MoE's ``shard_map`` names its two
``all_to_all``s (``repro/models/moe.py:201-205, 235-238``).  The port
holds local tensors, so the layers call them where the reference's
partitioner would place them (``models/layers.py``, ``attention.py``,
``moe.py``):

* :func:`all_reduce` — sum or max over a group (row-parallel partial
  sums, the vocab-parallel embedding and cross-entropy, flash-decoding's
  softmax state, the MoE's metrics, the loss's sums);
* :func:`all_gather` — blocks side by side along one dimension (split
  heads, the logits' vocab blocks, a batch over "data", FSDP's weights
  and the experts' fsdp dimension); :func:`all_gather_last` gathers
  several tensors in one call;
* :func:`reduce_scatter` — the sum over a group, each rank keeping its
  block along one dimension (FSDP's gradients);
* :func:`all_to_all` — equal row blocks exchanged along dim 0 (the
  MoE's dispatch and return);
* :func:`copy_to_split` and :func:`split` — no collective in the
  forward: a replicated tensor entering a computation each rank does on
  its own part (a column-parallel Linear; the rank's slice of the
  input).

Gradients.  Training differentiates through every op, as GSPMD's
transpose does, under one convention: every rank's loss is the same
global scalar, so a tensor every rank of a group holds alike also holds
the same, whole gradient on every rank.  Each backward follows from what
the op's output feeds:

* an ``all_reduce`` (sum) whose output every rank uses alike passes the
  gradient through unchanged;
* :func:`copy_to_split` (identity) sums the gradient over the group:
  each rank's part of the computation gives a part of it;
* :func:`split` (the rank's block) gathers the blocks' gradients back;
* :func:`computed_alike` (identity) divides the gradient by the group's
  size: every rank computed the tensor on its own from inputs held alike;
* an ``all_gather`` whose output every rank uses alike (``alike=True``)
  keeps the rank's block of the gradient; one whose output each rank
  uses on its own data (``alike=False``: FSDP's weights over "data")
  reduce-scatters it (sum);
* an ``all_to_all``'s backward is the same exchange the other way.

A group of None (no mesh, or an axis of one rank) makes each op return its
input untouched.  Every other call counts itself in :data:`launches`, in
the forward and in the backward alike (``repro_torch.graphs`` registers
the counters beside the kernels'; the NCCL kernels they launch are named
in ``measure._KERNEL_COUNTERS``).

Under NCCL the ops are safe to capture in a CUDA graph: no host sync, and
outputs from ``torch.empty``.  NCCL builds a communicator at a group's
first collective, so a capture's warm-up (``graphs.capture``) runs each op
once before the recording.  Under gloo a collective on CUDA tensors goes
through host copies (:func:`transport` names the path): the tensor is
copied to the host, the collective runs there and the result is copied
back, which syncs the stream and cannot be captured, so gloo runs eager.
``all_gather`` and ``all_to_all`` move bytes (any dtype travels as
``uint8``); gloo's ``all_reduce`` and ``reduce_scatter`` sum a 16-bit
float in fp32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: Collective calls so far in this process, by op (``graphs`` snapshots,
#: restores and resets them).
launches = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0,
            "reduce_scatter": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def transport(group, device: torch.device) -> str:
    """How a collective over ``group`` moves tensors on ``device``:
    ``"nccl"``, ``"gloo"`` (host tensors) or ``"gloo via host copies"``
    (CUDA tensors staged through the host); ``"none"`` without a group."""
    if group is None:
        return "none"
    backend = dist.get_backend(group)
    if backend == "gloo" and device.type == "cuda":
        return "gloo via host copies"
    return backend


def _host_staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _gloo_fp32(group, x: torch.Tensor) -> bool:
    """Whether a sum over ``group`` runs on a fp32 host copy of ``x``:
    CUDA tensors under gloo, and 16-bit floats, which gloo sums in fp32."""
    return _host_staged(group, x) or (
        x.dtype in (torch.bfloat16, torch.float16)
        and dist.get_backend(group) == "gloo")


def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    launches["all_reduce"] += 1
    if _gloo_fp32(group, x):
        h = x.detach().to("cpu", torch.float32 if x.is_floating_point()
                          else x.dtype)
        dist.all_reduce(h, _OPS[op], group=group)
        return h.to(x.device, x.dtype)
    out = torch.empty_like(x)
    out.copy_(x)
    dist.all_reduce(out, _OPS[op], group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """A sum every rank of the group uses alike: the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over ``group``, a new
    tensor.  Differentiable for "sum" (its output used alike by every
    rank: the gradient passes through); a "max" carries no gradient."""
    if _size(group) == 1:
        return x
    if _differentiable(x):
        if op != "sum":
            raise ValueError(f"all_reduce {op!r} has no gradient: detach "
                             f"its input")
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x, group, op)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n) contiguous as a uint8 view (..., n * itemsize)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dim() else x.reshape(1).view(torch.uint8)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """Blocks of ``group``'s ranks stacked along a new dim 0, in rank
    order: (n, *x.shape)."""
    n = _size(group)
    b = _as_bytes(x)
    staged = _host_staged(group, x)
    src = b.cpu() if staged else b
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=torch.uint8,
                      device=src.device)
    # torch 2.13 renames all_gather_into_tensor to all_gather_single and
    # deprecates the old name (a FutureWarning); torch 2.11 has the old
    # name alone
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, src, group=group)
    if staged:
        out = out.to(x.device)
    return out.view(x.dtype).reshape(n, *x.shape)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    launches["all_gather"] += 1
    parts = _gather0(x, group)                        # (n, *x.shape)
    if dim == 0:
        return parts.reshape(-1, *x.shape[1:])
    return torch.cat(parts.unbind(0), dim=dim)


def _block(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's block of ``g`` along ``dim`` (one of the group's equal
    blocks), contiguous."""
    n = g.shape[dim] // _size(group)
    return g.narrow(dim, _rank(group) * n, n).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, alike):
        ctx.group, ctx.dim, ctx.alike = group, dim, alike
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.alike:
            return _block(g, ctx.group, ctx.dim), None, None, None
        return reduce_scatter(g, ctx.group, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, group, dim: int = 0, *,
               alike: bool = True) -> torch.Tensor:
    """``group``'s blocks concatenated along ``dim`` in rank order.  Its
    gradient: the rank's block of the output's where every rank uses the
    output alike (``alike``), else (each rank uses it on its own data, as
    FSDP's weight gather over "data") the rank's block of the sum over the
    group (:func:`reduce_scatter`)."""
    if _size(group) == 1:
        return x
    dim = dim % x.dim()
    if _differentiable(x):
        return _AllGather.apply(x, group, dim, alike)
    return _all_gather(x, group, dim)


def _all_gather_last(tensors, group) -> tuple:
    launches["all_gather"] += 1
    widths = [t.shape[-1] for t in tensors]
    parts = _gather0(torch.cat(tensors, dim=-1), group)  # (n, ..., sum w)
    out, at = [], 0
    for w in widths:
        out.append(torch.cat(parts[..., at:at + w].unbind(0), dim=-1))
        at += w
    return tuple(out)


class _AllGatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return _all_gather_last(tensors, group)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(None if g is None else _block(g, ctx.group, -1)
                        for g in grads))


def all_gather_last(tensors: list, group) -> list:
    """Each of ``tensors`` (the same leading dims) gathered along its last
    dim, in one collective: they travel side by side.  Every rank uses the
    outputs alike: the gradient of each is the rank's block."""
    if _size(group) == 1:
        return list(tensors)
    if any(_differentiable(t) for t in tensors):
        return list(_AllGatherLast.apply(group, *tensors))
    return list(_all_gather_last(tensors, group))


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group`` along which rank r keeps block r
    of ``dim`` (the transpose of FSDP's gather; no gradient of its own).
    NCCL runs ``reduce_scatter_tensor`` (torch 2.11's name;
    ``reduce_scatter_single`` in torch 2.13, which deprecates the older).
    gloo runs ``reduce_scatter_single`` where torch has it (2.13); with
    torch 2.11's gloo, which may lack the op, it is an ``all_reduce`` and
    the rank's block.  A 16-bit float or a CUDA tensor under gloo is
    summed on a fp32 host copy, as :func:`all_reduce` sums it."""
    if _size(group) == 1:
        return x
    dim = dim % x.dim()
    launches["reduce_scatter"] += 1
    n = _size(group)
    src = (x.movedim(dim, 0) if dim else x).contiguous()
    staged = _gloo_fp32(group, x)
    if staged:
        src = src.to("cpu", torch.float32)
    single = getattr(dist, "reduce_scatter_single", None)
    if dist.get_backend(group) == "gloo" and single is None:
        src = src if staged else src.clone()
        dist.all_reduce(src, group=group)
        out = _block(src, group, 0)
    else:
        out = torch.empty((src.shape[0] // n, *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        (single or dist.reduce_scatter_tensor)(out, src, group=group)
    if staged:
        out = out.to(x.device, x.dtype)
    return (out.movedim(0, dim) if dim else out).contiguous()


class _CopyToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, "sum"), None


def copy_to_split(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, held alike by every rank of ``group``, as it enters a
    computation each rank does on its own part (a column-parallel Linear,
    the rank's heads, the rank's tokens): the identity, whose backward
    sums the ranks' parts of the gradient (``all_reduce``), so that ``x``
    holds its whole gradient on every rank.  No collective in the
    forward."""
    if _size(group) == 1 or not _differentiable(x):
        return x
    return _CopyToSplit.apply(x, group)


class _ComputedAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def computed_alike(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, which every rank of ``group`` computed on its own from
    inputs it holds alike (each model rank routing every token of its
    rows): the identity, whose backward gives each rank's computation an
    even share of the gradient (divided by the group's size), which the
    ``copy_to_split`` its inputs entered through sums back.  The
    reference's ``shard_map`` transposes an output replicated over an axis
    so.  No collective."""
    if _size(group) == 1 or not _differentiable(x):
        return x
    return _ComputedAlike.apply(x, _size(group))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


def split(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The rank's block along ``dim`` of ``x``, which every rank of
    ``group`` holds alike (a contiguous copy); its backward gathers the
    blocks' gradients, so that ``x`` holds its whole gradient on every
    rank.  No collective in the forward."""
    if _size(group) == 1:
        return x
    dim = dim % x.dim()
    if _differentiable(x):
        return _Split.apply(x, group, dim)
    return _block(x, group, dim)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    launches["all_to_all"] += 1
    b = _as_bytes(x)
    staged = _host_staged(group, x)
    src = b.cpu() if staged else b
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    if staged:
        out = out.to(x.device)
    return out.view(x.dtype).reshape(x.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n * c, ...) cut into ``group``'s n row blocks: block i goes
    to rank i, and the result holds block r of every rank, in rank order
    (``jax.lax.all_to_all(x.reshape(n, c, ...), axis, 0, 0)``).  Its
    backward is the same exchange of the gradient."""
    if _size(group) == 1:
        return x
    if _differentiable(x):
        return _AllToAll.apply(x, group)
    return _all_to_all(x, group)


def pmean(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over the ranks of every group in ``groups`` (the
    reference's ``pmean`` over several axes)."""
    n = 1
    for g in groups:
        x = all_reduce(x, g)
        n *= _size(g)
    return x if n == 1 else x / n
