"""Sharding rules: logical parameter/activation axes -> mesh axes.
Counterpart of ``repro/sharding/rules.py``, ported whole: the same fields,
kinds and spec functions, over the port's parameter names.

Train mode (FSDP + TP + optional pod-DP):
* 2-D weights are column-parallel by default: (in, out) -> P(fsdp, tp); the
  "down"/output projections are row-parallel: (in, out) -> P(tp, fsdp).
* Expert weights (E, ., .) -> P(tp, fsdp?, None) (expert parallelism).
* Embedding/unembedding table (V, d) -> P(tp, fsdp): vocab-sharded.
* Activations: batch over (pod, data); KV caches: batch over data,
  sequence over tp (flash-decoding style).

Serve mode: TP only (no fsdp) for the dense weights; the experts keep
their extra (data) axis (``launch/dryrun.py::make_rules``).

The port holds one module per layer where the reference stacks the layers
of each pattern variant along leading axes (``convert.lm_leaves`` maps the
two), so a port parameter's spec is the reference's with the stacked
leading entries dropped.  A spec is a :class:`Spec`, a tuple that equals
the reference's ``PartitionSpec`` turned into one.

At run time the port holds local tensors, not global arrays under a
partitioner: :func:`local_block` cuts a rank's block of a full tensor
under a spec (the reference's ``named`` placement) and
:func:`gather_block` puts the blocks back together over the mesh's
process groups.  :func:`shard_act` is the reference's activation
constraint: a no-op without a context; with one, this rank's block of a
full activation.  The model code reads the rules from the context
(:func:`current_rules`), as the reference's does; the launcher sets it
around the model's construction and every step.
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Optional

import torch
from torch import nn


def _norm_entry(entry):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a tuple
    of one axis is that axis' name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


class Spec(tuple):
    """A partition spec: one entry a dimension, each None (replicated), a
    mesh axis name, or a tuple of names (the dimension split over their
    product, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


P = Spec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Optional[object]                 # launch.mesh.Mesh
    batch_axes: tuple = ("data",)          # + "pod" on the multi-pod mesh
    model_axis: Optional[str] = "model"
    fsdp_axis: Optional[str] = "data"      # None in serve mode
    seq_axis: Optional[str] = None         # sequence-parallel activations
    # experts may need the extra (data) axis even at serve time
    expert_fsdp_axis: Optional[str] = None

    @property
    def expert_fsdp(self) -> Optional[str]:
        return self.expert_fsdp_axis or self.fsdp_axis

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def fsdp_size(self) -> int:
        if self.mesh is None or self.fsdp_axis is None:
            return 1
        return self.mesh.shape[self.fsdp_axis]


_CURRENT: list = [None]


def current_rules() -> Optional[ShardingRules]:
    return _CURRENT[0]


@contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = _CURRENT[0]
    _CURRENT[0] = rules
    try:
        yield rules
    finally:
        _CURRENT[0] = prev


def active_mesh(rules: Optional[ShardingRules] = None):
    """The mesh the model runs on under ``rules`` (default: the context's),
    or None where there is none or it has one rank: then every layer takes
    its one-device path."""
    r = rules if rules is not None else current_rules()
    if r is None or r.mesh is None or r.mesh.size == 1:
        return None
    return r.mesh


def model_shard(rules: Optional[ShardingRules] = None) -> tuple:
    """(tensor-parallel size, this rank's index on the model axis, the
    axis' process group or None); (1, 0, None) without a mesh."""
    r = rules if rules is not None else current_rules()
    mesh = active_mesh(r)
    if mesh is None or r.model_axis is None or r.model_size == 1:
        return 1, 0, None
    return (r.model_size, mesh.coords[r.model_axis],
            mesh.group(r.model_axis))


def fsdp_shard(rules: Optional[ShardingRules] = None) -> tuple:
    """(fsdp size, this rank's index on the fsdp axis, the axis' process
    group or None); (1, 0, None) without a mesh or an fsdp axis."""
    r = rules if rules is not None else current_rules()
    mesh = active_mesh(r)
    if mesh is None or r.fsdp_axis is None or r.fsdp_size == 1:
        return 1, 0, None
    return (r.fsdp_size, mesh.coords[r.fsdp_axis],
            mesh.group(r.fsdp_axis))


def batch_groups(rules: Optional[ShardingRules] = None) -> list:
    """The process groups of the batch axes that have more than one rank
    (the groups a loss's sums over the batch run over); [] without a
    mesh."""
    r = rules if rules is not None else current_rules()
    mesh = active_mesh(r)
    if mesh is None:
        return []
    return [mesh.group(a) for a in r.batch_axes if mesh.shape[a] > 1]


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def act_spec(shape, kind: str, r: ShardingRules) -> Spec:
    """The spec of an activation of ``shape`` and ``kind`` (the reference's
    ``shard_act`` kinds): btd (B,S,d) · heads4 (B,S,H,dh) · cache
    (B,Smax,Hkv,dh) · q_decode · scores_decode (B,Hq,1,S) · logits (B,S,V)
    · tokens (B,S) · rows (B, ...: the batch alone split, as an input a
    sequence-parallel stream takes whole before it cuts its block).  The batch is split over the batch axes where it
    divides, else every rank holds every row (``batch_pspecs``'s rule):
    the reference's partitioner pads an uneven split instead, which local
    blocks cannot, and :func:`own_rows` keeps such rows from counting more
    than once in a loss."""
    tp = r.model_axis
    b = _batch_axes_if(r, shape[0])
    if kind == "btd":
        seq = r.seq_axis if (r.seq_axis and _div(
            shape[1], r.mesh.shape[r.seq_axis])) else None
        return P(b, seq, None)
    if kind == "heads4":
        h_ok = tp is not None and _div(shape[2], r.model_size)
        return P(b, None, tp if h_ok else None, None)
    if kind == "cache":
        s_ok = tp is not None and _div(shape[1], r.model_size)
        return P(b, tp if s_ok else None, None, None)
    if kind == "q_decode":
        return P(b, None, None, None)
    if kind == "scores_decode":
        s_ok = tp is not None and _div(shape[-1], r.model_size)
        return P(b, None, None, tp if s_ok else None)
    if kind == "logits":
        v_ok = tp is not None and _div(shape[-1], r.model_size)
        return P(b, None, tp if v_ok else None)
    if kind == "tokens":
        return P(b, None)
    if kind == "rows":
        return P(b, *([None] * (len(shape) - 1)))
    raise ValueError(kind)


def seq_group(total: int, rules: Optional[ShardingRules] = None):
    """The process group over which a residual stream of ``total``
    positions is held as the rank's block of its sequence (sequence
    parallelism: ``seq_axis`` set, the kind "btd" splitting dim 1, which
    it does where ``total`` divides over the axis), or None where the
    stream is whole on every rank.  The port runs sequence parallelism
    over the model axis only (the reference's ``make_rules`` sets no
    other: ``repro/launch/dryrun.py:46-59``)."""
    r = rules if rules is not None else current_rules()
    mesh = active_mesh(r)
    if mesh is None or r.seq_axis is None:
        return None
    if r.seq_axis != r.model_axis:
        raise ValueError(f"sequence parallelism runs over the model axis "
                         f"({r.model_axis!r}), not {r.seq_axis!r}")
    if not _div(total, mesh.shape[r.seq_axis]):
        return None
    return mesh.group(r.seq_axis)


def shard_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """This rank's block of the full activation ``x`` under its kind's spec
    (:func:`act_spec`); a no-op without a context."""
    r = current_rules()
    if r is None or r.mesh is None:
        return x
    return local_block(x, act_spec(x.shape, kind, r), r.mesh)


def own_rows(labels: torch.Tensor) -> torch.Tensor:
    """This rank's labels of the whole batch's ``labels`` (B, S), for a
    loss summed over the batch axes: its block of the rows where B divides
    over them (:func:`shard_act`, kind "tokens"); else every row, of which
    this rank's share (blocks of ceil(B / n) in rank order over the n ranks
    of the batch axes, the last shorter or empty, as the reference's padded
    split places them) keeps its labels and the rest are ignored (-1), so
    that each row counts once in the loss, its token count and the
    gradients summed over the batch axes."""
    local = shard_act(labels, "tokens")
    r = current_rules()
    mesh = active_mesh(r)
    if mesh is None or _batch_axes_if(r, labels.shape[0]) is not None:
        return local
    idx, n = _block_index(tuple(r.batch_axes), mesh, mesh.coords)
    if n == 1:
        return local
    size = -(-labels.shape[0] // n)
    rows = torch.arange(labels.shape[0], device=labels.device) // size
    return torch.where((rows == idx)[:, None], local,
                       torch.full_like(local, -1))


# ---------------------------------------------------------------------------
# Parameter specs (path-based)
# ---------------------------------------------------------------------------

_ROW_PARALLEL_KEYS = {"w_o", "w_down", "w_ff_down", "w_out", "w_dt"}
_EXPERT_KEYS = {"w_gate_e", "w_up_e", "w_down_e"}
_REPLICATED_PARENTS = {"router"}


def _leaf_spec(keys, shape, rules: ShardingRules) -> Spec:
    """The spec of the parameter at path ``keys`` (its names, outermost
    first) of ``shape``; any leading dims beyond a leaf's own are stacked
    layers and stay replicated (the reference's ``_leaf_spec``)."""
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    tp, fsdp = rules.model_axis, rules.fsdp_axis
    ndim = len(shape)

    def tp_if(n):
        return tp if (tp and _div(n, rules.model_size)) else None

    def fsdp_if(n):
        return fsdp if (fsdp and _div(n, rules.fsdp_size)) else None

    lead = 0
    if name in _EXPERT_KEYS or parent in _EXPERT_KEYS:
        # (., E, a, b): E -> tp (EP), dim1 -> the experts' fsdp axis, which
        # the layer gathers before use (the reference's shard_map in_specs)
        lead = ndim - 3
        ef = rules.expert_fsdp
        ef_ok = ef and rules.mesh is not None and _div(
            shape[lead + 1], rules.mesh.shape[ef])
        core_spec = (tp_if(shape[lead]), ef if ef_ok else None, None)
    elif parent in _REPLICATED_PARENTS or name in _REPLICATED_PARENTS:
        return P(*([None] * ndim))
    elif name == "table":  # embedding (V, d)
        return P(tp_if(shape[0]), fsdp_if(shape[1]))
    elif name == "w" or name == "b":
        lead = max(ndim - (1 if name == "b" else 2), 0)
        if name == "b":
            core_spec = ((None,) if parent in _ROW_PARALLEL_KEYS
                         else (tp_if(shape[lead]),))
        elif parent in _ROW_PARALLEL_KEYS:
            core_spec = (tp_if(shape[lead]), fsdp_if(shape[lead + 1]))
        else:
            core_spec = (fsdp_if(shape[lead]), tp_if(shape[lead + 1]))
    elif name == "conv":  # (K, D) depthwise filter: channel = tp (paper!)
        lead = ndim - 2
        core_spec = (None, tp_if(shape[lead + 1]))
    elif name == "a_log":  # (di, N)
        lead = ndim - 2
        core_spec = (tp_if(shape[lead]), None)
    elif name in ("d_skip", "dt_bias"):
        lead = ndim - 1
        core_spec = (tp_if(shape[lead]),)
    elif name == "r":  # slstm recurrent (H, dh, 4dh)
        lead = ndim - 3
        core_spec = (tp_if(shape[lead]), None, None)
    else:  # norms, scalars, meta tokens
        return P(*([None] * ndim))
    return P(*([None] * lead), *core_spec)


def _shapes(params) -> dict:
    """``{dotted name: shape}`` of a module's parameters or of a mapping of
    names to tensors or shapes."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_specs(params, rules: ShardingRules) -> dict:
    """``{name: Spec}`` of a model's parameters (an ``nn.Module``, or a
    mapping of dotted names to tensors or shapes)."""
    return {name: _leaf_spec(name.split("."), shape, rules)
            for name, shape in _shapes(params).items()}


def zero1_specs(params, specs: dict, rules: ShardingRules) -> dict:
    """Optimizer-state specs: param spec + fsdp sharding of the largest
    currently-unsharded dim (ZeRO-1).  Falls back to the param spec."""
    fsdp = rules.fsdp_axis
    if fsdp is None or rules.fsdp_size <= 1:
        return dict(specs)

    def upgrade(shape, spec: Spec) -> Spec:
        if not shape:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if fsdp in parts:
            return spec
        cands = [(shape[i], i) for i in range(len(shape))
                 if parts[i] is None and shape[i] % rules.fsdp_size == 0]
        if not cands:
            return spec
        _, i = max(cands)
        parts[i] = fsdp
        return P(*parts)

    return {name: upgrade(shape, specs[name])
            for name, shape in _shapes(params).items()}


def split_axes(spec: Spec) -> tuple:
    """The mesh axes each dimension of a tensor under ``spec`` is split
    over, by dimension: a tuple of tuples of axis names, () where the
    dimension is whole (what a gradient's reduction, the global norm and
    ZeRO-1 read)."""
    return tuple(_entry_axes(e) for e in spec)


def spec_axes(spec: Spec) -> frozenset:
    """Every mesh axis ``spec`` splits some dimension over."""
    return frozenset(a for axes in split_axes(spec) for a in axes)


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """How a train state's leaves lie over ``mesh``: ``params`` the
    parameters' specs (:func:`param_specs`) and ``moments`` AdamW's
    moments' (:func:`zero1_specs`), by parameter name; ``parts`` the
    leaves cut part by part (``models.transformer.param_parts``).  A
    moment whose spec adds ``zero1_axis`` to its parameter's on one
    dimension (:meth:`zero1_dim`) is the rank's block of that dimension
    of the rank's parameter block."""
    mesh: object
    params: dict
    moments: dict
    zero1_axis: Optional[str] = "data"
    parts: dict = dataclasses.field(default_factory=dict)

    def axes(self, name: str) -> frozenset:
        """The axes the parameter ``name``'s block is split over."""
        return spec_axes(self.params[name])

    def split_order(self, name: str) -> tuple:
        """The axes the parameter ``name`` is split over, in the mesh's
        order: the ranks that hold different blocks of it differ on these
        axes; ranks that differ on the others hold the same block (its
        replicas)."""
        axes = self.axes(name)
        return tuple(a for a in self.mesh.axis_names if a in axes
                     and self.mesh.shape[a] > 1)

    def positions(self, name: str, shape: tuple, device=None) -> tuple:
        """``(coordinates, whole shape)`` of the rank's block (of
        ``shape``) of the parameter ``name``: each dimension's global
        coordinates in the whole tensor, a 1-D int64 tensor a dimension,
        the last of a fused projection part by part (as
        :func:`local_block` cuts it: the rank's block of each part, side
        by side)."""
        spec = list(self.params[name]) + [None] * (len(shape) - len(
            self.params[name]))
        parts = self.parts.get(name, 1)
        if not any(_entry_axes(e) for e in spec):
            parts = 1
        out, whole = [], []
        for dim, (size, entry) in enumerate(zip(shape, spec)):
            idx, n = _block_index(_entry_axes(entry), self.mesh,
                                  self.mesh.coords)
            local = torch.arange(size, device=device)
            if dim == len(shape) - 1 and parts > 1:
                w = size // parts            # the rank's width of a part
                part, within = local // w, local % w
                out.append(part * (w * n) + idx * w + within)
            else:
                out.append(idx * size + local)
            whole.append(size * n)
        return out, tuple(whole)

    def zero1_dim(self, name: str) -> Optional[int]:
        """The dimension the moments of ``name`` split further over
        ``zero1_axis`` than the parameter does, or None."""
        p, m = split_axes(self.params[name]), split_axes(self.moments[name])
        for dim, (a, b) in enumerate(zip(p, m)):
            if a != b:
                if b != a + (self.zero1_axis,) or self.zero1_axis in a:
                    raise ValueError(f"{name}: moments {self.moments[name]}"
                                     f" are not {self.params[name]} cut "
                                     f"over {self.zero1_axis!r}")
                return dim
        return None

    def zero1_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's ZeRO-1 block of ``t`` (the rank's block of the
        parameter ``name``, or its gradient): its part of the moments'
        extra cut, a view; ``t`` itself where the moments add none."""
        dim = self.zero1_dim(name)
        if dim is None:
            return t
        n = self.mesh.shape[self.zero1_axis]
        size = t.shape[dim] // n
        return t.narrow(dim, self.mesh.coords[self.zero1_axis] * size, size)

    def zero1_gather(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """The rank's parameter block of which ``block`` is the rank's
        ZeRO-1 block (:meth:`zero1_block`), gathered over ``zero1_axis``;
        ``block`` itself where the moments add no cut."""
        from repro_torch.sharding import collectives
        dim = self.zero1_dim(name)
        if dim is None:
            return block
        return collectives.all_gather(block, self.mesh.group(
            self.zero1_axis), dim=dim)

    def whole(self, name: str, t: torch.Tensor,
              moment: bool = False) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block: of the
        parameter ``name`` (its gradient, a compression error), or with
        ``moment`` of its ZeRO-1 moments; a fused projection put back
        part by part.  Every rank of the mesh takes part."""
        if moment:
            t = self.zero1_gather(name, t)
        return gather_block(t, self.params[name], self.mesh,
                            parts=self.parts.get(name, 1))

    def block(self, name: str, t: torch.Tensor,
              moment: bool = False) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` (the inverse of
        :meth:`whole`), contiguous."""
        b = local_block(t, self.params[name], self.mesh,
                        parts=self.parts.get(name, 1))
        if moment:
            b = self.zero1_block(name, b)
        return b.contiguous()


def train_layout(params, rules: ShardingRules,
                 parts: Optional[dict] = None) -> Optional[StateLayout]:
    """The :class:`StateLayout` of a model's parameters (an ``nn.Module``
    or ``{name: tensor or shape}`` of whole shapes) under ``rules``, its
    fused projections cut in ``parts`` (``{name: parts}``), or None where
    no mesh of more than one rank is in force."""
    if active_mesh(rules) is None:
        return None
    specs = param_specs(params, rules)
    return StateLayout(rules.mesh, specs, zero1_specs(params, specs, rules),
                       rules.fsdp_axis, dict(parts or {}))


# ---------------------------------------------------------------------------
# Batch / cache input specs
# ---------------------------------------------------------------------------


def _batch_axes_if(rules: ShardingRules, n: int):
    total = math.prod(rules.mesh.shape[a] for a in rules.batch_axes)
    return rules.batch_axes if (total > 1 and n % total == 0) else None


def batch_pspecs(batch: dict, rules: ShardingRules) -> dict:
    """Specs for {tokens, labels, frontend, pos}: batch dim over data
    axes."""
    return {k: P(_batch_axes_if(rules, t.shape[0]),
                 *([None] * (t.dim() - 1))) for k, t in batch.items()}


def cache_pspecs(cache, rules: ShardingRules, stacked: bool = False):
    """Decode-cache specs, in the cache's own tree: batch over data axes;
    KV sequence over the model axis (flash-decoding layout).
    ``stacked=True``: every leaf but ``pos`` carries a leading layers dim
    (the reference's stacked layout); the port's own cache has one only on
    ``enc_k`` / ``enc_v`` (n_layers, B, S_enc, Hkv, dh)."""
    tp = rules.model_axis

    def seq_if(n):
        return tp if (tp and _div(n, rules.model_size)) else None

    def one(name: str, leaf, lead: int) -> Spec:
        shape = tuple(leaf.shape)
        if name == "pos":
            return P(_batch_axes_if(rules, shape[0]))
        if len(shape) < 1 + lead:
            return P(*([None] * len(shape)))
        bspec = _batch_axes_if(rules, shape[lead])
        pre = (None,) * lead
        if name in ("k", "v", "enc_k", "enc_v") and len(shape) == 4 + lead:
            return P(*pre, bspec, seq_if(shape[lead + 1]), None, None)
        if name in ("k_scale", "v_scale") and len(shape) == 3 + lead:
            return P(*pre, bspec, seq_if(shape[lead + 1]), None)
        return P(*pre, bspec, *([None] * (len(shape) - 1 - lead)))

    def walk(node, name: str):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        lead = 1 if (stacked or name in ("enc_k", "enc_v")) else 0
        return one(name, node, lead if name != "pos" else 0)

    return walk(cache, "")


# ---------------------------------------------------------------------------
# Blocks: a rank's part of a full tensor, and back
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_index(axes: tuple, mesh, coords: dict) -> tuple:
    """(index of this rank's block, number of blocks) of a dimension split
    over ``axes``, the first outermost."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of one rank's block of a tensor of ``shape``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} blocks ({spec})")
        out[dim] //= n
    return tuple(out)


def local_block(t: torch.Tensor, spec: Spec, mesh,
                coords: Optional[dict] = None,
                parts: int = 1) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (the rank
    at ``coords``, default the mesh's own): a contiguous copy that holds no
    reference to ``t``'s storage, or ``t`` itself where the spec
    replicates it.  ``parts`` > 1: ``t``'s last dimension is that many
    equal parts side by side (a fused projection's ``[x | z]``), each cut
    on its own and the rank's blocks of them put side by side (the port's
    per-part cut, ``models.transformer.param_parts``)."""
    if parts > 1 and any(_entry_axes(e) for e in spec):
        return torch.cat([local_block(p, spec, mesh, coords)
                          for p in t.chunk(parts, dim=-1)], dim=-1)
    coords = mesh.coords if coords is None else coords
    out = t
    for dim, entry in enumerate(spec):
        idx, n = _block_index(_entry_axes(entry), mesh, coords)
        if n == 1:
            continue
        size = out.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks ({spec})")
        out = out.narrow(dim, idx * (size // n), size // n)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def gather_block(t: torch.Tensor, spec: Spec, mesh,
                 parts: int = 1) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's block under ``spec``
    (of ``parts`` parts, as :func:`local_block` cuts them): the inverse of
    :func:`local_block`, by all-gathers over the mesh's process groups
    (each dimension's axes innermost first)."""
    from repro_torch.sharding import collectives
    if parts > 1 and any(_entry_axes(e) for e in spec):
        return torch.cat([gather_block(p, spec, mesh)
                          for p in t.chunk(parts, dim=-1)], dim=-1)
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            t = collectives.all_gather(t, mesh.group(a), dim=dim)
    return t
