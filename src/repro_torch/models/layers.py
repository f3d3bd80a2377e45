"""Primitive layers: norms, Linear (routed through the paper's PWConv),
RoPE, the embedding, the chunked cross-entropy and the separable-conv
backbone wrappers (:func:`init_backbone`, :func:`backbone`: thin layers
over the CNN side's ``core/network.py``).  Counterpart of
``repro/models/layers.py``.

Parameters live in ``nn.ParameterDict``s keyed as the reference's dicts
are (``{"scale"}``, ``{"w", "b"}``, ``{"table"}``), so a module's
``state_dict`` names are the reference's parameter paths joined by dots.
Every init draws from an explicit ``torch.Generator``, on the generator's
own device (the host unless the caller hands a CUDA generator, which
draws billions of weights in a fraction of the host's time), and moves
the result to ``device``, so a host generator's seed gives the same
weights on every device.  On the ``meta`` device nothing is drawn: the
parameters only get their shapes and dtypes (``transformer.cast_params``
fills them from a model drawn once).  Parameters are built with
``requires_grad=False``, which serving keeps; training turns them on
with :func:`trainable_`.

Under a mesh every parameter is one rank's block of the unsharded one:
:func:`param_hook` lets ``transformer.init_params`` cut each parameter as
it is made (drawn whole, in the unsharded order, then cut), and the
layers here are the sharded forms the rest of the stack calls: the
vocab-parallel embedding (:func:`embed` with ``vocab``), the row-parallel
Linear (:func:`row_linear`), the RMS norm of a split width
(:func:`rms_norm_split`), the unembedding's gather of its vocab blocks
(:func:`unembed_logits` with ``vocab``) and the vocab-parallel
cross-entropy (:func:`chunked_cross_entropy` with ``vocab``).  A
column-parallel Linear is :func:`linear` on the local columns, its input
entering the split region through ``collectives.copy_to_split`` (done
once by the caller for the Linears that share an input).  Under FSDP (the
train rules, or serving's ``serve_weight_fsdp``) a weight's dimension
split over "data" is gathered at its use (:func:`fsdp_gather`: the
input rows of a column-parallel Linear, the output columns of a
row-parallel one, the embedding table's width), and its gradient
reduce-scattered back; under per-layer remat the gather runs again in
the recomputed forward.  Without a mesh, or on one of one rank, each is
the one-device op.

Sequence parallelism (``seq_axis`` in the rules, over the model axis):
a layer runs inside :func:`sequence_parallel` (``transformer.layer_
forward`` sets it where the residual stream is held as the rank's block
of the sequence).  There the residual norms run on the block, their
replicated scales entering through :func:`seq_params` (each rank's
tokens give a part of the gradient); :func:`gather_seq` gathers the
normed block before the column-parallel projections (its backward a
reduce-scatter, so the projections take it through
:func:`enter_model_axis`, which knows it is gathered);
:func:`row_linear` reduce-scatters its fp32 partial
sums to the rank's block (``collectives.scatter_seq``) where it would
all-reduce them; and :func:`seq_block` cuts the block of a tensor every
rank holds whole.  Outside the context each is the identity, or the
ordinary op.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy, pointwise
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import fsdp_shard, model_shard

_PARAM_HOOK: list = [None]


def param(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a frozen parameter, passed through the :func:`param_hook`
    in force, if any."""
    p = nn.Parameter(t, requires_grad=False)
    hook = _PARAM_HOOK[0]
    return p if hook is None else hook(p)


@contextmanager
def param_hook(hook: Callable[[nn.Parameter], nn.Parameter]):
    """Every :func:`param` made inside the block goes through ``hook``, in
    the order the modules make them (how ``transformer.init_params`` learns
    that order on the meta device, then cuts each parameter to its
    rank's block)."""
    prev = _PARAM_HOOK[0]
    _PARAM_HOOK[0] = hook
    try:
        yield
    finally:
        _PARAM_HOOK[0] = prev


_SEQ: list = [None]


@contextmanager
def sequence_parallel(group):
    """Inside the block the layer being run holds its residual stream as
    the rank's block of the sequence over ``group`` (the model axis'), or
    (None) whole.  Set inside the function a per-layer remat recomputes,
    so the recomputed forward runs under it too."""
    prev = _SEQ[0]
    _SEQ[0] = group
    try:
        yield
    finally:
        _SEQ[0] = prev


def seq_shard():
    """The group the residual stream is split over (the sequence-parallel
    layer being run), or None."""
    return _SEQ[0]


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """Under sequence parallelism the whole sequence of the rank's block
    ``x`` (``collectives.gather_seq``: the input of the column-parallel
    projections, its backward a reduce-scatter); else ``x``."""
    group = _SEQ[0]
    return x if group is None else collectives.gather_seq(x, group)


def enter_model_axis(x: torch.Tensor, *, split: bool,
                     gathered: Optional[bool] = None) -> torch.Tensor:
    """``x`` as it enters a computation over the model axis: each rank's
    own columns, heads or vocab rows (``split``), or one every rank does
    alike.  Where ``x`` came through :func:`gather_seq` (``gathered``; by
    default whether a sequence-parallel layer is running, whose normed
    input comes so) its backward already sums the ranks' parts: split, it
    passes as it is, and alike its gradient is divided over the ranks
    (``collectives.computed_alike``), so that it counts once.  Else split
    is ``collectives.copy_to_split`` and alike ``x`` itself."""
    group = model_shard()[2]
    if gathered is None:
        gathered = _SEQ[0] is not None
    if gathered:
        return x if split else collectives.computed_alike(x, group)
    return collectives.copy_to_split(x, group) if split else x


def seq_block(x: torch.Tensor) -> torch.Tensor:
    """Under sequence parallelism the rank's block of the sequence of
    ``x``, which every rank holds whole (``collectives.split_seq``: its
    backward a gather); else ``x``."""
    group = _SEQ[0]
    return x if group is None else collectives.split_seq(x, group)


def seq_params(p):
    """A norm's parameters (``{"scale"[, "bias"]}``) as they apply to the
    residual stream: under sequence parallelism each enters the split
    region (``collectives.copy_to_split``: the rank's tokens give a part
    of its gradient, the parts summed over the axis); else ``p``."""
    group = _SEQ[0]
    if group is None:
        return p
    return {k: collectives.copy_to_split(v, group) for k, v in p.items()}


def trainable_(module: nn.Module) -> nn.Module:
    """Turn on ``requires_grad`` for every parameter of ``module``, in
    place (what training calls; serving never does).  Returns ``module``."""
    for p in module.parameters():
        p.requires_grad_(True)
    return module


def _is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def randn(generator: torch.Generator, shape, std: float, dtype, device):
    """N(0, std^2) drawn in fp32 on the generator's device, then cast and
    moved."""
    if _is_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return t.mul_(std).to(device=device, dtype=dtype)


def rand(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) drawn in fp32 on the generator's device, then moved."""
    if _is_meta(device):
        return torch.empty(shape, device=device)
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


# ---------------------------------------------------------------------------
# Norms (fp32 internals regardless of activation dtype)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` over a last dimension of ``scale``'s width, where
    ``x`` holds the rank's block of it (split over the model axis): each
    row's sum of squares is all-reduced, and the rank's block of ``scale``
    applies.  :func:`rms_norm` where ``x`` is whole.

    Its gradient: each rank uses the summed squares on its own block, so
    the sum enters the split region (``copy_to_split``: the ranks' parts
    of its gradient summed, where a plain ``all_reduce`` would pass each
    rank's part alone), and the scale's block is ``split`` off (its
    gradient gathered whole)."""
    width, whole = x.shape[-1], scale.shape[-1]
    if width == whole:
        return rms_norm(x, scale, eps)
    group = model_shard()[2]
    xf = x.float()
    sq = collectives.copy_to_split(collectives.all_reduce(
        xf.square().sum(dim=-1, keepdim=True), group), group)
    y = xf * torch.rsqrt(sq / whole + eps)
    block = collectives.split(scale, group, dim=-1)
    return (y * (1.0 + block.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps) * (1.0 + scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm(x: torch.Tensor, params, kind: str = "rms") -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params.get("bias"))


def init_norm(kind: str, d: int, with_bias: bool = False,
              device="cuda") -> nn.ParameterDict:
    p = {"scale": param(torch.zeros(d, device=device))}
    if kind == "layer" and with_bias:
        p["bias"] = param(torch.zeros(d, device=device))
    return nn.ParameterDict(p)


# ---------------------------------------------------------------------------
# Linear == the paper's PWConv
# ---------------------------------------------------------------------------


def init_linear(generator: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32,
                scale: Optional[float] = None,
                device="cuda") -> nn.ParameterDict:
    std = scale if scale is not None else d_in ** -0.5
    p = {"w": param(randn(generator, (d_in, d_out), std, dtype, device))}
    if bias:
        p["b"] = param(torch.zeros(d_out, dtype=dtype, device=device))
    return nn.ParameterDict(p)


def fsdp_gather(w: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """``w`` whole along ``dim`` (``whole`` wide): where it holds the
    rank's block of that dimension over the fsdp axis, the blocks gathered
    over it (each data rank uses the weight on its own rows, so the
    gradient is reduce-scattered back: ``collectives.all_gather`` with
    ``alike=False``); else ``w``."""
    if w.shape[dim] == whole:
        return w
    return collectives.all_gather(w, fsdp_shard()[2], dim=dim, alike=False)


def linear(p, x: torch.Tensor, *, activation: Optional[str] = None,
           policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """``x @ w + b`` on the ``pwconv`` kernel; ``w``'s input rows gathered
    over the fsdp axis where they are split (:func:`fsdp_gather`)."""
    w = fsdp_gather(p["w"], 0, x.shape[-1])
    return pointwise(x, w, p.get("b"), activation=activation, policy=policy)


def row_linear(p, x: torch.Tensor, d_in: int, *,
               d_out: Optional[int] = None,
               policy: KernelPolicy = DEFAULT_POLICY,
               seq_out: bool = True) -> torch.Tensor:
    """A Linear of ``d_in`` inputs whose rows may be split over the model
    axis (``w_o``, ``w_down``): where ``p["w"]`` holds the rank's block of
    rows, the rank's slice of ``x`` (its local part already, or cut here
    from the whole ``d_in``: ``collectives.split``) times those rows,
    stored in fp32 by the kernel, is summed over the axis, the bias added
    once and the sum cast once.  Where the rows are whole it is
    :func:`linear` on the whole ``x``.  ``d_out``: the output width, whose
    columns are gathered over the fsdp axis where they are split.

    Under sequence parallelism (:func:`sequence_parallel`) an output that
    joins the residual stream (``seq_out``; not the Mamba's ``w_dt``) is
    the rank's block of the sequence: the partial sums are
    reduce-scattered (``collectives.scatter_seq``) and the bias, entering
    the split region, added to the block; with whole rows the rank's
    block of the output is cut (:func:`seq_block`)."""
    w = p["w"]
    seq = _SEQ[0] if seq_out else None
    if d_out is not None:
        w = fsdp_gather(w, 1, d_out)
    if w.shape[0] == d_in:
        y = pointwise(x, w, p.get("b"), policy=policy)
        return y if seq is None else collectives.split_seq(y, seq)
    group = model_shard()[2]
    if x.shape[-1] == d_in:
        x = collectives.split(x, group, dim=-1)
    part = pointwise(x, w, policy=policy, out_dtype=torch.float32)
    if seq is None:
        y = collectives.all_reduce(part, group)
        b = p.get("b")
    else:
        y = collectives.scatter_seq(part, seq)
        b = p.get("b")
        b = None if b is None else collectives.copy_to_split(b, seq)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                       # (dh/2,)
    angles = positions[..., None].float() * freqs                # (B,S,dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cuda") -> nn.ParameterDict:
    return nn.ParameterDict(
        {"table": param(randn(generator, (vocab, d), d ** -0.5, dtype,
                              device))})


def embed(p, tokens: torch.Tensor, vocab: Optional[int] = None,
          width: Optional[int] = None, seq=None) -> torch.Tensor:
    """Rows of ``p["table"]`` at ``tokens``.  Where the table holds the
    rank's block of a ``vocab``-row table (vocab-parallel), each rank looks
    up the tokens in its rows, zeroes the others and the rows are summed
    over the model axis (exactly one rank holds each token).  ``width``:
    the embedding's width, gathered over the fsdp axis where the table's
    columns are split.  ``seq`` (a group: sequence parallelism) returns
    the rank's block of the sequence: the vocab-parallel sum
    reduce-scattered instead (``collectives.scatter_seq``), a whole
    table's rows cut (``collectives.split_seq``)."""
    table = p["table"]
    if width is not None:
        table = fsdp_gather(table, 1, width)
    if vocab is None or table.shape[0] == vocab:
        x = table[tokens]
        return x if seq is None else collectives.split_seq(x, seq)
    _, rank, group = model_shard()
    rows = table.shape[0]
    local = tokens - rank * rows
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, 0)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    if seq is not None:
        return collectives.scatter_seq(x, seq)
    return collectives.all_reduce(x, group)


def unembed_logits(x: torch.Tensor, table: torch.Tensor,
                   vocab: Optional[int] = None) -> torch.Tensor:
    """x (..., d) @ table.T (V, d) -> (..., V) in fp32: the operands upcast,
    which is the reference's bf16 x bf16 product with fp32 accumulation.
    A plain product outside any kernel, left to ``torch.matmul`` as the
    reference leaves it to XLA.  Where ``table`` is the rank's block of a
    ``vocab``-row table, its logits are gathered over the model axis; its
    columns are gathered over the fsdp axis where they are split."""
    table = fsdp_gather(table, 1, x.shape[-1])
    logits = torch.matmul(x.float(), table.float().T)
    if vocab is None or table.shape[0] == vocab:
        return logits
    return collectives.all_gather(logits, model_shard()[2], dim=-1)


def _chunk_loss(xc: torch.Tensor, table: torch.Tensor, lc: torch.Tensor,
                vocab: Optional[int] = None):
    """One chunk's (sum NLL, valid tokens, sum lse^2) from its fp32 logits
    (B, chunk, V).  Where ``table`` holds the rank's block of a
    ``vocab``-row table, the logits stay split over the model axis
    (vocab-parallel): the rows' maxima are reduced (max, no gradient),
    then each row's sum of exp(logit - max) and its target's logit (held
    by one rank, zero on the others) in one sum; the log-sum-exp is the
    max plus the log of the sum."""
    logits = torch.matmul(xc.float(), table.float().T)
    valid = (lc >= 0).float()
    if vocab is None or table.shape[0] == vocab:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           torch.clamp(lc, min=0).long()[..., None])[..., 0]
    else:
        _, rank, group = model_shard()
        rows = table.shape[0]
        m = collectives.all_reduce(logits.detach().amax(dim=-1), group,
                                   "max")
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        local = lc.long() - rank * rows
        inside = (local >= 0) & (local < rows)
        tgt = torch.gather(logits, -1,
                           torch.clamp(local, 0, rows - 1)[..., None])[..., 0]
        tgt = torch.where(inside, tgt, torch.zeros((), device=tgt.device))
        sumexp, tgt = collectives.all_reduce(torch.stack([sumexp, tgt]),
                                             group).unbind(0)
        lse = m + torch.log(sumexp)
    return ((lse - tgt) * valid).sum(), valid.sum(), (lse.square()
                                                      * valid).sum()


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          z_loss: float = 0.0, vocab: Optional[int] = None,
                          gathered: bool = False):
    """(sum NLL, token count) of hidden states x (B, S, d) against
    ``labels`` (B, S) (-1 ignored) over the unembedding ``table`` (V, d),
    in sequence chunks of ``chunk``: the sequence padded with ignored
    labels to whole chunks, each chunk's (B, chunk, V) fp32 logits
    recomputed in the backward (``torch.utils.checkpoint``), never the
    whole (B, S, V).  ``z_loss`` adds ``z_loss * sum(lse^2)`` over the
    valid tokens to the sum.  The reference's, chunk for chunk.  Under a
    mesh the table's columns split over the fsdp axis are gathered once
    for every chunk (and their gradient reduce-scattered once), and a
    table of the rank's block of ``vocab`` rows runs the vocab-parallel
    cross-entropy (:func:`_chunk_loss`); the sums are this rank's rows'.
    ``gathered``: ``x`` is a sequence-parallel gather's output
    (:func:`enter_model_axis`)."""
    b, s, _ = x.shape
    table = fsdp_gather(table, 1, x.shape[-1])
    # every rank's x times its own vocab rows, or times the whole table
    # alike
    x = enter_model_axis(x, split=vocab is not None
                         and table.shape[0] != vocab, gathered=gathered)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    nll_sum = n_tok = zsum = torch.zeros((), device=x.device)
    for c in range(0, s + pad, chunk):
        xc, lc = x[:, c:c + chunk], labels[:, c:c + chunk]
        if torch.is_grad_enabled():
            nll, nv, zs = torch.utils.checkpoint.checkpoint(
                _chunk_loss, xc, table, lc, vocab, use_reentrant=False,
                preserve_rng_state=False)
        else:
            nll, nv, zs = _chunk_loss(xc, table, lc, vocab)
        nll_sum, n_tok, zsum = nll_sum + nll, n_tok + nv, zsum + zs
    if z_loss:
        nll_sum = nll_sum + z_loss * zsum
    return nll_sum, n_tok


# ---------------------------------------------------------------------------
# Separable-conv backbones (the paper's workload, network-level)
# ---------------------------------------------------------------------------


def init_backbone(net, generator: Optional[torch.Generator] = None, *,
                  seed: int = 0, dtype: torch.dtype = torch.float32,
                  device="cuda") -> dict:
    """Parameters of a declared separable backbone (a
    ``core.network.NetworkSpec``, e.g. ``mobilenet_v2_spec()``):
    ``{"blocks": init_network(...)}``, on the card unless the caller asks
    for the CPU (``repro/models/layers.py:169-173``)."""
    from repro_torch.core import network
    return {"blocks": network.init_network(net, generator, seed=seed,
                                           dtype=dtype, device=device)}


def backbone(p: dict, x: torch.Tensor, *, net,
             policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Run a declared separable-conv backbone end to end:
    ``execute_network`` on ``p["blocks"]`` (every block's plan resolved
    once; on the card one CUDA graph a forward) (``repro/models/
    layers.py:176-180``)."""
    from repro_torch.core import network
    return network.execute_network(net, p["blocks"], x, policy=policy)
