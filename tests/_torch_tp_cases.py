"""The sharded cases of ``tests/test_torch_tp_serve.py``,
``tests/test_torch_tp_recurrent.py`` and ``tests/test_torch_tp_train.py``,
shared by their reference oracle
(``_torch_tp_oracle.py``, JAX on forced host devices) and their port
worlds (``_torch_tp_world.py``, gloo ranks).  Plain data and numpy: this
module imports neither JAX nor torch."""
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
#: The recurrent and encoder-decoder families' cases
#: (``tests/test_torch_tp_recurrent.py``), in a dict of their own so that
#: ``test_torch_tp_serve.py`` does not run them.  ``widths``: the smoke
#: config's fields replaced so that every leaf the rules split at the
#: family's published widths at the case's tp splits here too (hymba:
#: ``w_bcdt``'s 2N + dt_rank columns and ``w_dt``'s dt_rank rows, and an
#: odd vocabulary, replicated as 32001 is; xLSTM: 4 heads, which split at
#: tp 4; whisper: an odd vocabulary, replicated as 51865 is).
_HYMBA = dict(d_model=64, d_head=16, vocab_size=129)
_XLSTM = dict(d_model=64, n_heads=4, n_kv_heads=4)
_WHISPER = dict(vocab_size=127)
RECURRENT_CASES = {
    # 8 meta + 30 tokens in the 40-slot ring (32 window + 8 sink slots):
    # the decode steps wrap it
    "hymba_ring_tp2": dict(arch="hymba-1.5b", mesh=(1, 2), prompt=30,
                           max_len=48, widths=_HYMBA),
    "hymba_ring_tp4": dict(arch="hymba-1.5b", mesh=(1, 4), prompt=30,
                           max_len=48, widths=_HYMBA),
    "xlstm_tp2": dict(arch="xlstm-125m", mesh=(1, 2), prompt=16, max_len=32,
                      widths=_XLSTM),
    "xlstm_tp4": dict(arch="xlstm-125m", mesh=(1, 4), prompt=16, max_len=32,
                      widths=_XLSTM),
    "xlstm_dp2_tp2": dict(arch="xlstm-125m", mesh=(2, 2), prompt=16,
                          max_len=32, widths=_XLSTM),
    # the encoder's 24 frames: 12 / 6 a rank in the cross attention's cache
    "whisper_tp2": dict(arch="whisper-small", mesh=(1, 2), prompt=16,
                        max_len=32, widths=_WHISPER),
    "whisper_tp4": dict(arch="whisper-small", mesh=(1, 4), prompt=16,
                        max_len=32, widths=_WHISPER),
}
#: The sharded-training cases (``tests/test_torch_tp_train.py``): a
#: smoke config (``dtype``, fp32 unless given) on its (data, model) mesh
#: under the train rules, a global batch of ``TRAIN_BATCH`` x
#: ``TRAIN_SEQ`` tokens (some labels ignored) in ``microbatches``; the
#: reference's sharded loss and gradients, AdamW step on them and jitted
#: train step.  qwen3's 2 KV heads do not split over 4 ranks; smollm's
#: table is tied and its 3 heads split over no tp; the MoE routes each
#: shard's tokens with its own capacity.  ``serve``: the serving case of
#: ``serve_weight_fsdp`` (a prefill and ``SERVE_FSDP_STEPS`` decode steps);
#: ``oracle=False``: held against the port's own one-rank step (bf16,
#: whose dots the reference cannot jit on this CPU).
TRAIN_CASES = {
    "qwen3_dp2_tp2": dict(arch="qwen3-1.7b", mesh=(2, 2)),
    "qwen3_dp4": dict(arch="qwen3-1.7b", mesh=(4, 1)),
    "qwen3_tp4": dict(arch="qwen3-1.7b", mesh=(1, 4)),
    "smollm_dp2_tp2": dict(arch="smollm-360m", mesh=(2, 2)),
    "qwen3moe_dp2_tp2": dict(arch="qwen3-moe-235b-a22b", mesh=(2, 2)),
    "qwen3moe_tp2": dict(arch="qwen3-moe-235b-a22b", mesh=(1, 2)),
    "qwen3_mb2_dp2_tp2": dict(arch="qwen3-1.7b", mesh=(2, 2),
                              microbatches=2),
    "qwen3_bf16_dp2_tp2": dict(arch="qwen3-1.7b", mesh=(2, 2),
                               dtype="bfloat16", oracle=False),
    "qwen3_serve_fsdp": dict(arch="qwen3-1.7b", mesh=(2, 2), serve=True,
                             prompt=16, max_len=32),
}
TRAIN_BATCH = 8
TRAIN_SEQ = 32
#: Sharded training on batches that do not split evenly
#: (``tests/test_torch_tp_uneven.py``), each case with its own global
#: ``batch`` x ``seq``: rows that do not divide over "data" (in a
#: microbatch, too) and a sequence that does not divide over "model" at
#: a MoE layer (the reference keeps it whole on every model rank).
#: ``oracle_mesh``: the mesh the reference runs the case on, where its
#: own refuses it: its MoE ``shard_map`` needs the rows to divide over
#: "data", so 9 rows at (2, 2) run at (1, 2), which is what each data
#: rank of the port computes with the rows replicated over "data".
#: ``whole_grads``: leaves whose gradient is held against the reference's
#: one-device ``value_and_grad`` (which the oracle then also writes): at 5
#: rows over 2 data ranks its sharded one scatters the partitioner's pad
#: row into the table's row 0 (about 1e7 there; its jitted step's
#: ``grad_norm``, 2.38, has no such row).
UNEVEN_TRAIN_CASES = {
    "commandr_mb2_dp4": dict(arch="command-r-35b", mesh=(4, 1), batch=12,
                             seq=TRAIN_SEQ, microbatches=2),
    "qwen3_b5_dp2_tp2": dict(arch="qwen3-1.7b", mesh=(2, 2), batch=5,
                             seq=TRAIN_SEQ,
                             whole_grads=("embedding.table",)),
    "qwen3moe_s42_tp4": dict(arch="qwen3-moe-235b-a22b", mesh=(1, 4),
                             batch=12, seq=42),
    "qwen3moe_b9_s41_dp2_tp2": dict(arch="qwen3-moe-235b-a22b",
                                    mesh=(2, 2), batch=9, seq=41,
                                    oracle_mesh=(1, 2)),
}
#: The AdamW of the training cases (decay on, warmup, clipping).
ADAMW = dict(lr=1e-2, warmup_steps=2, total_steps=100, weight_decay=0.1,
             clip_norm=1.0)
#: The dicts of cases by name, as the oracle and the worlds take them.
SUITES = {"CASES": CASES, "RECURRENT_CASES": RECURRENT_CASES,
          "TRAIN_CASES": TRAIN_CASES,
          "UNEVEN_TRAIN_CASES": UNEVEN_TRAIN_CASES}
#: The suites of training cases.
TRAIN_SUITES = ("TRAIN_CASES", "UNEVEN_TRAIN_CASES")
MESHES = sorted({c["mesh"] for c in CASES.values()})
BATCH = 2
STEPS = 4
SEED = 0


def meshes(cases: dict) -> list:
    """The mesh shapes (data, model) of ``cases``."""
    return sorted({c["mesh"] for c in cases.values()})


def config(cfg, case: dict):
    """A package's smoke config of ``case["arch"]`` as the case runs it
    (fp32 unless the case gives a ``dtype``, its widths, the int8 cache,
    the capacity factor)."""
    cfg = dataclasses.replace(cfg, dtype=case.get("dtype", "float32"),
                              kv_quant=bool(case.get("kv_quant")),
                              **case.get("widths", {}))
    if case.get("capacity"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return cfg


def inputs(cfg, case: dict, seed: int = SEED):
    """(tokens (B, S) int32, frontend (B, F, d) fp32 or None), seeded; an
    encoder-decoder's frontend is its encoder's frames (B, S_enc, d)."""
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, case["prompt"]))
    frontend = None
    if cfg.encdec is not None:
        frontend = rng.standard_normal((BATCH, cfg.encdec.enc_seq,
                                        cfg.d_model)).astype(np.float32)
    elif case.get("frontend"):
        frontend = (rng.standard_normal((BATCH, cfg.fusion_tokens,
                                         cfg.d_model)) * 0.5)
        frontend = frontend.astype(np.float32)
    return tokens.astype(np.int32), frontend


def batch_shape(case: dict) -> tuple:
    """A training case's global batch shape (B, S)."""
    return case.get("batch", TRAIN_BATCH), case.get("seq", TRAIN_SEQ)


def train_batch(cfg, case: dict, seed: int = SEED) -> dict:
    """A training case's global batch: tokens and labels (B, S) int32 of
    :func:`batch_shape`, seeded, the first three labels of row 0 and the
    last two of row 5 (if there is one) ignored (-1), so that the data
    ranks' token counts differ."""
    rng = np.random.default_rng(seed + 2)
    shape = batch_shape(case)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels[0, :3] = -1
    if shape[0] > 5:
        labels[5, -2:] = -1
    return {"tokens": tokens, "labels": labels}


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
