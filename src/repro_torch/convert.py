"""Convert the JAX package's parameters into the port's.

CNN bodies: the reference keeps per-block lists of per-stage dicts of
arrays (DW ``f`` (Hf, Wf, C), PW ``w`` (Ci, Co), biases (C,)); the port
keeps the same structure and layouts, so nothing is transposed.  The block
shims' flat dicts (``dw_filter``, ``pw_weight``, ...) likewise.

LM stack: the reference keeps nested dicts whose layer variants are
stacked along a leading groups axis (``blocks_v0`` = mLSTM, ``blocks_v1``
= sLSTM for xLSTM; ``blocks_v0`` = the hymba layer or whisper's ``dec``
layer); the port's modules name their parameters by the same keys joined
with dots (``meta``, the meta tokens, and whisper's ``enc_pos`` and
``enc_ln_final`` included), layer ``g*period + vi`` takes
``blocks_v{vi}[g]`` and encoder layer ``g`` ``enc_blocks[g]``.

Under a mesh (``rules``) each rank loads its block of every leaf
(``sharding.rules.param_specs``), cut from the whole array on the host;
the fused projections part by part (``models.transformer.param_parts``:
the Mamba's ``w_in``, the mLSTM's ``w_up`` and gates, the sLSTM's gates),
as ``init_params`` cuts them, so a rank loaded from the reference holds
what a rank drawn by ``init_params`` holds.

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts (a JAX
array converts on the host); this module imports neither JAX nor the
reference package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One leaf as a tensor of the same dtype.  bf16 arrays (which numpy
    holds through ml_dtypes) travel through fp32, which is exact."""
    arr = np.asarray(a)
    name = arr.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if name not in _DTYPES:
        raise ValueError(f"unsupported parameter dtype {name}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def dict_from_numpy(params: dict, device="cuda") -> dict:
    """A flat ``{name: array}`` (the block shims' parameters,
    ``core/separable.py``) as ``{name: tensor}`` on ``device``."""
    return {k: tensor_from_numpy(v, device) for k, v in params.items()}


def params_from_numpy(jax_params, device="cuda") -> list:
    """Reference network params (blocks -> stages -> {name: array}) as the
    port's (the same structure, tensors on ``device``)."""
    return [[{k: tensor_from_numpy(v, device) for k, v in stage.items()}
             for stage in block] for block in jax_params]


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict of leaves as ``{"a.b.c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_tree_(module: nn.Module, leaves: dict) -> nn.Module:
    """Copy ``{dotted name: array or tensor}`` into ``module``'s parameters
    of the same names, in place.  The names, shapes and dtypes must match
    exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(leaves):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(params) - set(leaves))}, unexpected "
                         f"{sorted(set(leaves) - set(params))}")
    for name, p in params.items():
        leaf = leaves[name]
        t = (leaf.to(p.device) if isinstance(leaf, torch.Tensor)
             else tensor_from_numpy(np.array(leaf), p.device))
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(t.shape)} {t.dtype}, "
                             f"port {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)
    return module


def lm_leaves(jax_params, period: int) -> dict:
    """Reference LM params (or anything of their tree, e.g. their
    gradients) as ``{port parameter name: leaf}`` for a model whose
    pattern has ``period`` layers."""
    leaves = {}
    for key, sub in jax_params.items():
        if key == "enc_blocks":
            stacked, period_of, vi = "enc_blocks", 1, 0
        elif key.startswith("blocks_v"):
            stacked, period_of = "blocks", period
            vi = int(key[len("blocks_v"):])
        else:
            leaves.update(flatten_tree({key: sub}))
            continue
        for name, arr in flatten_tree(sub).items():
            arr = np.asarray(arr)
            for g in range(arr.shape[0]):
                leaves[f"{stacked}.{g * period_of + vi}.{name}"] = arr[g]
    return leaves


def lm_params_from_numpy(jax_params, cfg, device="cuda", rules=None):
    """Reference LM params (``repro.models.transformer.init_params``) as the
    port's ``LMModel`` on ``device``; under the mesh of ``rules`` (default:
    the context's) this rank's blocks of them."""
    from repro_torch.core.network import require_device
    from repro_torch.models.transformer import build_model, param_parts
    from repro_torch.sharding.rules import (active_mesh, current_rules,
                                            local_block, param_specs)
    dev = require_device(device)
    r = rules if rules is not None else current_rules()
    model = build_model(cfg, torch.Generator(), "meta", r).to_empty(
        device=dev)
    leaves = lm_leaves(jax_params, len(model.pattern))
    if active_mesh(r) is not None:
        specs = param_specs({n: np.shape(a) for n, a in leaves.items()}, r)
        parts = param_parts(model)
        leaves = {n: local_block(tensor_from_numpy(np.array(a), "cpu"),
                                 specs[n], r.mesh, parts=parts.get(n, 1))
                  for n, a in leaves.items()}
    return load_tree_(model, leaves)
