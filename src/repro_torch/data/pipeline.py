"""Deterministic, resumable, shard-disjoint synthetic LM data pipeline.
Counterpart of ``repro/data/pipeline.py``: :func:`_batch_np` is a copy of
the reference's numpy generator, so a batch here equals the reference's
bit for bit.

A seeded counter-based stream (numpy's ``SeedSequence`` on (seed, step,
shard)) draws token batches with a Zipfian marginal and a deterministic
n-gram structure, so models have signal to fit (the loss falls).

* determinism: batch(step) is a pure function of (seed, step), so
  replaying a step after a restore is bit-exact (a checkpoint stores only
  the step).
* sharding: each data-parallel rank draws a disjoint slice of the global
  batch.
* prefetch: a background thread keeps ``prefetch`` batches ready.

:class:`DataIterator` yields ``{"tokens", "labels"}`` as int32 CPU tensors;
the train step moves them to the model's device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    structure: int = 8     # n-gram period giving learnable structure


def _batch_np(cfg: DataConfig, step: int, shard: int = 0,
              n_shards: int = 1) -> dict:
    """Pure function of (cfg.seed, step, shard)."""
    assert cfg.global_batch % n_shards == 0
    b_local = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard])
    )
    # Zipf marginal clipped to vocab
    raw = rng.zipf(cfg.zipf_a, size=(b_local, cfg.seq_len + 1))
    toks = (raw - 1) % cfg.vocab_size
    # learnable structure: every `structure`-th token repeats (shifted) the
    # anchor token, so context predicts it
    anchor = toks[:, 0::cfg.structure]
    for j in range(1, cfg.structure // 2 + 1):
        idx = np.arange(j, cfg.seq_len + 1, cfg.structure)
        toks[:, idx] = (anchor[:, : len(idx)] + j) % cfg.vocab_size
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class DataIterator:
    """Stateful iterator with save/restore; optional background prefetch."""

    def __init__(self, cfg: DataConfig, *, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        if cfg.global_batch % n_shards:
            raise ValueError(f"a global batch of {cfg.global_batch} does "
                             f"not split into {n_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step
        self._prefetch_n = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if prefetch > 0:
            self._start_prefetch()

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "shard": self.shard,
                "n_shards": self.n_shards}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, prefetch: int = 2):
        return cls(cfg, shard=state["shard"], n_shards=state["n_shards"],
                   start_step=state["step"], prefetch=prefetch)

    # -- iteration -----------------------------------------------------------
    def _start_prefetch(self):
        self._q = queue.Queue(maxsize=self._prefetch_n)
        self._stop = threading.Event()
        fetch_from = self.step

        def worker():
            s = fetch_from
            batch = None
            while not self._stop.is_set():
                if batch is None:
                    batch = _batch_np(self.cfg, s, self.shard, self.n_shards)
                try:
                    self._q.put((s, batch), timeout=0.5)
                    s, batch = s + 1, None
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __next__(self) -> dict:
        if self._q is not None:
            s, batch = self._q.get()
            # on restore mid-stream the queue may hold stale steps; skip
            while s < self.step:
                s, batch = self._q.get()
            self.step = s + 1
            return _tensors(batch)
        batch = _batch_np(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return _tensors(batch)

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2)
