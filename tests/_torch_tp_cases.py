"""The sharded-serving cases of ``tests/test_torch_tp_serve.py``, shared by
its reference oracle (``_torch_tp_oracle.py``, JAX on forced host devices)
and its port worlds (``_torch_tp_world.py``, gloo ranks).  Plain data and
numpy: this module imports neither JAX nor torch."""
from __future__ import annotations

import dataclasses

import numpy as np

#: name -> the case: ``arch`` (a smoke config, fp32), ``mesh`` (data,
#: model), ``prompt`` tokens, ``max_len``, and optionally ``frontend`` (the
#: config's stubbed embeddings), ``capacity`` (the MoE's capacity factor,
#: low enough that copies drop) and ``kv_quant`` (the int8 cache, prefilled
#: by stepping: the reference's own prefill leaves its scales at zero).
CASES = {
    # every head whole at tp 2; at tp 4 the KV heads split (8 of 16 cols)
    "qwen3_tp2": dict(arch="qwen3-1.7b", mesh=(1, 2), prompt=16, max_len=32),
    "qwen3_tp4": dict(arch="qwen3-1.7b", mesh=(1, 4), prompt=16, max_len=32),
    "qwen3_dp2_tp2": dict(arch="qwen3-1.7b", mesh=(2, 2), prompt=16,
                          max_len=32),
    # 1.5 query heads and half a KV head a rank
    "smollm_tp2": dict(arch="smollm-360m", mesh=(1, 2), prompt=16,
                       max_len=32),
    # a query head a rank, half a KV head a rank, the frontend's prefix
    "internvl2_tp4": dict(arch="internvl2-1b", mesh=(1, 4), prompt=16,
                          max_len=32, frontend=True),
    "qwen3moe_tp2": dict(arch="qwen3-moe-235b-a22b", mesh=(1, 2), prompt=16,
                         max_len=32),
    "qwen3moe_tp4": dict(arch="qwen3-moe-235b-a22b", mesh=(1, 4), prompt=16,
                         max_len=32),
    "qwen3moe_drop_tp2": dict(arch="qwen3-moe-235b-a22b", mesh=(1, 2),
                              prompt=16, max_len=32, capacity=0.5),
    # 8 + 30 tokens wrap the sliding-window layers' 32-slot rings
    "llama4_ring_tp2": dict(arch="llama4-maverick-400b-a17b", mesh=(1, 2),
                            prompt=30, max_len=48, frontend=True),
    "llama4_drop_dp2_tp2": dict(arch="llama4-maverick-400b-a17b",
                                mesh=(2, 2), prompt=30, max_len=48,
                                frontend=True, capacity=0.5),
    "qwen3_int8_tp2": dict(arch="qwen3-1.7b", mesh=(1, 2), prompt=10,
                           max_len=20, kv_quant=True),
}
MESHES = sorted({c["mesh"] for c in CASES.values()})
BATCH = 2
STEPS = 4
SEED = 0


def config(cfg, case: dict):
    """A package's smoke config of ``case["arch"]`` as the case runs it
    (fp32, the int8 cache, the capacity factor)."""
    cfg = dataclasses.replace(cfg, dtype="float32",
                              kv_quant=bool(case.get("kv_quant")))
    if case.get("capacity"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return cfg


def inputs(cfg, case: dict, seed: int = SEED):
    """(tokens (B, S) int32, frontend (B, F, d) fp32 or None), seeded."""
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, case["prompt"]))
    frontend = None
    if case.get("frontend"):
        frontend = (rng.standard_normal((BATCH, cfg.fusion_tokens,
                                         cfg.d_model)) * 0.5)
        frontend = frontend.astype(np.float32)
    return tokens.astype(np.int32), frontend


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as ``{"a.b.c": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for name, a in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out
