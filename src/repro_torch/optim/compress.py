"""Gradient compression with error feedback (counterpart of
``repro/optim/compress.py``), for the cross-node data parallelism: the
residual of the compression is added back into the next step's gradient,
so convergence is kept (Karimireddy et al. 2019).

* top-k sparsification: the k largest-|g| entries; the error-feedback
  invariant ``compressed + new error == g + old error`` holds exactly.
* int8 stochastic rounding: a per-tensor scale, unbiased.

Each compressor is the whole tensor's, as the reference's is: its
gradient is the logical, global one (under GSPMD too), and its tensor is
a stack: it stacks each layer variant's parameters along a leading
layers axis, so the layers of a stack (``stacks``,
``models.transformer.param_stacks``) are compressed as one tensor of that
leading dimension (k of the stack, its max).  Under a mesh (``layout``, a
``sharding.rules.StateLayout``) each gradient is the rank's block of its
parameter's; without one, the block is the whole parameter.

* top-k keeps the whole tensor's k = max(1, int(numel * frac)) largest,
  ties at the threshold going to the lower global flat index (as
  ``lax.top_k`` orders them).  Each entry's key is its |g|'s bits above
  its inverted global index (:func:`_sort_keys`; exact for tensors below
  2^32 entries, beyond which ties order by the index's low 32 bits).  The
  rank keeps a running top ``k`` of its stack's keys, member by member
  (the top k of a union is the top k of the parts' top k, so no more
  than 2k candidates are alive), those are gathered over the axes the
  leaf is split on, one after the other (``collectives.top_keys``), and
  the k-th of the union is the threshold: the rank keeps its entries at
  or above it.
* int8 scales by the whole tensor's max (``collectives.max_over``), and
  its noise is a counter-based draw (:func:`_uniform`, integer hashing in
  plain torch ops) of (key, the stack's name, each entry's global
  coordinates): it depends on no generator state and not on the mesh, so
  replicas of a block draw the same bits, every cut of a tensor draws
  the same noise for the same entry, and no rank makes a temporary of
  the whole tensor.  ``key`` (an int or a 0-d integer tensor on the
  card, which a captured step reads inside its graph) is required.  The
  bits are not JAX's threefry's; what holds is the unbiasedness and the
  invariant.

The compressors run on the reduced gradient (the reference compresses
the summed gradient, not what enters the reduction), so no byte on the
wire is saved here.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch

from repro_torch.sharding import collectives


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"            # none | topk | int8
    topk_frac: float = 0.01       # fraction of entries kept (topk)


def init_error(params: dict) -> dict:
    """A zeroed fp32 error of every parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantize(g: torch.Tensor, scale: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale



# ---------------------------------------------------------------------------
# The counter-based noise and the top-k keys of global positions
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit mixing function on int64 tensors holding values below
    2^32 (multipliers below 2^31, so no product overflows int64)."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x3A8F05C5) & _M32
    return h ^ (h >> 16)


def _leaf_hash(name: str) -> int:
    """The noise's stable number of a parameter name."""
    return zlib.crc32(name.encode())


def _uniform(key, leaf: int, coords: list, device) -> torch.Tensor:
    """U[0, 1) (fp32, 24 bits) at every entry of a block whose dimensions
    sit at the global ``coords`` (1-D int64 a dimension): a hash of
    ``key``, ``leaf`` and the entry's coordinates, whatever block of the
    tensor holds it."""
    if not torch.is_tensor(key):
        key = torch.tensor(key, dtype=torch.int64, device=device)
    h = _fmix((key.to(device, torch.int64) & _M32) ^ leaf)
    for c in coords:
        h = _fmix((h[..., None] * 0x2545F491 + c) & _M32)
    return (h >> 8).float() * (1.0 / (1 << 24))


def _flat_index(coords: list, whole: tuple, device) -> torch.Tensor:
    """The global row-major flat index (int64) of every entry of a block
    at ``coords`` of a tensor of shape ``whole``."""
    flat = torch.zeros((), dtype=torch.int64, device=device)
    stride = [1] * len(whole)
    for d in range(len(whole) - 2, -1, -1):
        stride[d] = stride[d + 1] * whole[d + 1]
    for c, s in zip(coords, stride):
        flat = flat[..., None] + c * s
    return flat


def _sort_keys(a: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys of |g| ``a`` (fp32, >= 0) at the global flat ``index``
    whose order is |g| descending, then the index ascending: the value's
    bits above the inverted low 32 bits of the index."""
    return ((a.view(torch.int32).to(torch.int64) << 32)
            | (_M32 - (index & _M32)))


# ---------------------------------------------------------------------------
# The compressors of the whole stacked tensors
# ---------------------------------------------------------------------------


def _check(cfg: CompressionConfig, key) -> None:
    if cfg.kind == "int8" and key is None:
        raise ValueError("int8 compression draws its noise from a key; "
                         "pass one")
    if cfg.kind not in ("topk", "int8"):
        raise ValueError(cfg.kind)


def _place(name: str, g: torch.Tensor, layout, stack: tuple):
    """(coords, whole shape, axes split over) of the block ``g`` of the
    parameter ``name`` as part of its stack (``(index, count)``: the
    stacked tensor's leading dimension, where the reference stacks the
    layers), under the layout or whole."""
    if layout is None:
        coords = [torch.arange(n, device=g.device) for n in g.shape]
        whole, axes = tuple(g.shape), ()
    else:
        coords, whole = layout.positions(name, tuple(g.shape), g.device)
        axes = layout.split_order(name)
    index, count = stack
    lead = torch.full((1,), index, dtype=torch.int64, device=g.device)
    return [lead, *coords], (count, *whole), axes


def _stacks(names, stacks: Optional[dict]) -> dict:
    """``{stack name: [member names in stack order]}`` of ``names``: each
    name's entry of ``stacks`` (``{name: (stack name, index)}``), or a
    stack of its own."""
    out: dict = {}
    for n in names:
        key, index = (stacks or {}).get(n, (n, 0))
        out.setdefault(key, []).append((index, n))
    return {k: [n for _, n in sorted(v)] for k, v in out.items()}


def _top(keys: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(keys, min(k, keys.numel())).values


def _global_stats(sums: dict, cfg: CompressionConfig, layout,
                  groups: dict) -> dict:
    """``{name: (stat, place, stack name)}`` over the whole stacked
    tensors of the blocks ``sums`` (the fp32 gradients plus the old
    errors; each made by a callable, so that no more than one leaf's sum
    is alive) grouped in ``groups`` (:func:`_stacks`): int8's max |g|, or
    top-k's threshold key (the rank's candidates a running top k of the
    stack's members)."""
    local, places, ks, axes = {}, {}, {}, {}
    for key, members in groups.items():
        for i, name in enumerate(members):
            g = sums[name]()
            places[name] = _place(name, g, layout, (i, len(members)))
            coords, whole, axes[key] = places[name]
            if cfg.kind == "int8":
                stat = g.abs().max()
                if i:
                    stat = torch.maximum(local[key], stat)
            else:
                n = 1
                for size in whole:
                    n *= size
                ks[key] = k = max(1, int(n * cfg.topk_frac))
                index = _flat_index(coords, whole, g.device)
                stat = _top(_sort_keys(g.abs(), index.reshape(g.shape))
                            .reshape(-1), k)
                del index
                if i:
                    stat = _top(torch.cat([local[key], stat]), k)
            local[key] = stat
            del g, stat
    if layout is not None:
        mesh = layout.mesh
        for axis in mesh.axis_names:
            keys = [k for k in local if axis in axes[k]]
            if not keys:
                continue
            group = mesh.group(axis)
            if cfg.kind == "int8":
                red = collectives.max_over(
                    torch.stack([local[k] for k in keys]), [group])
                local.update(zip(keys, red.unbind(0)))
            else:
                local.update(zip(keys, collectives.top_keys(
                    [local[k] for k in keys], [ks[k] for k in keys],
                    [group])))
    if cfg.kind == "topk":
        local = {k: top[-1] for k, top in local.items()}
    return {n: (local[key], places[n], key)
            for key, members in groups.items() for n in members}


def _compress_global(g: torch.Tensor, stat, cfg: CompressionConfig,
                     key) -> torch.Tensor:
    value, (coords, whole, _), stack = stat
    if cfg.kind == "int8":
        scale = torch.clamp(value, min=1e-12) / 127.0
        noise = _uniform(key, _leaf_hash(stack), coords, g.device) - 0.5
        return _quantize(g, scale, noise.reshape(g.shape))
    index = _flat_index(coords, whole, g.device).reshape(g.shape)
    return g * (_sort_keys(g.abs(), index) >= value)


def _global(grads: dict, error: dict, cfg: CompressionConfig, key,
            layout, stacks, write) -> None:
    """The compressors of the whole stacked tensors (see the module's
    docstring): each leaf's sum made once for its statistics and once
    more for its compression (the same bits), ``write(name, sum,
    compressed)`` called leaf by leaf."""
    _check(cfg, key)
    stats = _global_stats(
        {n: (lambda n=n: grads[n].float() + error[n]) for n in grads},
        cfg, layout, _stacks(grads, stacks))
    for name in grads:
        g = grads[name].float() + error[name]
        write(name, g, _compress_global(g, stats[name], cfg, key))


def compress(grads: dict, error: dict, cfg: CompressionConfig, *,
             key=None, layout=None, stacks: Optional[dict] = None):
    """Returns (compressed grads, new error), both fp32: the compressors
    of the whole tensors (the module's docstring), the tensors of a stack
    (``stacks``: ``{name: (stack name, index)}``, the reference's stacked
    layers, ``transformer.param_stacks``; a name it lacks is a stack of
    its own) compressed as one.  Under ``layout`` the gradients are the
    rank's blocks.  ``int8`` draws its rounding noise from ``key``
    (required)."""
    if cfg.kind == "none":
        return grads, error
    comp, new_err = {}, {}

    def write(name, g, c):
        comp[name], new_err[name] = c, g - c
    _global(grads, error, cfg, key, layout, stacks, write)
    return comp, new_err


def compress_(grads: dict, error: dict, cfg: CompressionConfig, *,
              key=None, layout=None, stacks: Optional[dict] = None) -> dict:
    """:func:`compress` with the new error written into ``error``'s own
    tensors (the same bits, the same draws); returns the compressed
    grads."""
    if cfg.kind == "none":
        return grads
    comp = {}

    def write(name, g, c):
        comp[name] = c
        torch.sub(g, c, out=error[name])
    _global(grads, error, cfg, key, layout, stacks, write)
    return comp
