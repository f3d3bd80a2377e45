"""The collectives of sharded serving, over ``torch.distributed``.

The reference writes none of these: GSPMD inserts them where its
partitioner needs them, and the MoE's ``shard_map`` names its two
``all_to_all``s (``repro/models/moe.py:201-205, 235-238``).  The port
holds local tensors, so the layers call them where the reference's
partitioner would place them (``models/layers.py``, ``attention.py``,
``moe.py``):

* :func:`all_reduce` — sum or max over a group (row-parallel partial
  sums, the vocab-parallel embedding, flash-decoding's softmax state, the
  MoE's metrics);
* :func:`all_gather` — blocks side by side along one dimension (split
  heads, the logits' vocab blocks, a batch over "data", experts' fsdp
  dimension); :func:`all_gather_last` gathers several tensors in one call;
* :func:`all_to_all` — equal row blocks exchanged along dim 0 (the
  MoE's dispatch and return).

A group of None (no mesh, or an axis of one rank) makes each op return its
input untouched.  Every other call counts itself in :data:`launches`
(``repro_torch.graphs`` registers the counters beside the kernels'; the
NCCL kernels they launch are named in ``measure._KERNEL_COUNTERS``).

Under NCCL the ops are safe to capture in a CUDA graph: no host sync, and
outputs from ``torch.empty``.  NCCL builds a communicator at a group's
first collective, so a capture's warm-up (``graphs.capture``) runs each op
once before the recording.  Under gloo a collective on CUDA tensors goes
through host copies (:func:`transport` names the path): the tensor is
copied to the host, the collective runs there and the result is copied
back, which syncs the stream and cannot be captured, so gloo runs eager.
``all_gather`` and ``all_to_all`` move bytes (any dtype travels as
``uint8``); gloo's ``all_reduce`` sums a 16-bit float in fp32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: Collective calls so far in this process, by op (``graphs`` snapshots,
#: restores and resets them).
launches = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


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


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over ``group``, a new
    tensor."""
    if _size(group) == 1:
        return x
    launches["all_reduce"] += 1
    if _host_staged(group, x) or (
            x.dtype in (torch.bfloat16, torch.float16)
            and dist.get_backend(group) == "gloo"):
        h = x.detach().to("cpu", torch.float32 if x.is_floating_point()
                          else x.dtype)
        dist.all_reduce(h, _OPS[op], group=group)
        return h.to(x.device, x.dtype)
    out = torch.empty_like(x)
    out.copy_(x)
    dist.all_reduce(out, _OPS[op], group=group)
    return out


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


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``group``'s blocks concatenated along ``dim`` in rank order."""
    if _size(group) == 1:
        return x
    launches["all_gather"] += 1
    dim = dim % x.dim()
    parts = _gather0(x, group)                        # (n, *x.shape)
    if dim == 0:
        return parts.reshape(-1, *x.shape[1:])
    return torch.cat(parts.unbind(0), dim=dim)


def all_gather_last(tensors: list, group) -> list:
    """Each of ``tensors`` (the same leading dims) gathered along its last
    dim, in one collective: they travel side by side."""
    if _size(group) == 1:
        return list(tensors)
    launches["all_gather"] += 1
    widths = [t.shape[-1] for t in tensors]
    parts = _gather0(torch.cat(tensors, dim=-1), group)  # (n, ..., sum w)
    out, at = [], 0
    for w in widths:
        out.append(torch.cat(parts[..., at:at + w].unbind(0), dim=-1))
        at += w
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n * c, ...) cut into ``group``'s n row blocks: block i goes
    to rank i, and the result holds block r of every rank, in rank order
    (``jax.lax.all_to_all(x.reshape(n, c, ...), axis, 0, 0)``)."""
    if _size(group) == 1:
        return x
    launches["all_to_all"] += 1
    b = _as_bytes(x)
    staged = _host_staged(group, x)
    src = b.cpu() if staged else b
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    if staged:
        out = out.to(x.device)
    return out.view(x.dtype).reshape(x.shape)


def pmean(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over the ranks of every group in ``groups`` (the
    reference's ``pmean`` over several axes)."""
    n = 1
    for g in groups:
        x = all_reduce(x, g)
        n *= _size(g)
    return x if n == 1 else x / n
