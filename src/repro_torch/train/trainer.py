"""Fault-tolerant training loop.  Counterpart of
``repro/train/trainer.py``.

* Periodic async checkpoints; on ANY step failure (a device error, an
  injected fault, a NaN loss) the trainer restores the latest committed
  checkpoint, rewinds the data iterator (bit-exact: the pipeline is a
  pure function of the step index) and continues, so the final model
  equals an uninterrupted run's.  On the card that needs deterministic
  kernels: ``torch.use_deterministic_algorithms(True)`` with
  ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts (the embedding's
  backward is an accumulating ``index_put_``, atomic otherwise).
* Straggler monitor: an EMA of the step's wall time; a step slower than
  ``straggler_factor`` x the EMA is logged and counted.
* NaN guard: a non-finite loss is a failure (restore, and skip the
  offending data step after ``max_nan_retries`` attempts on the same
  batch).  The attempts are counted per data step until the loop passes
  it: the reference resets its count at every successful step, so when
  the newest checkpoint precedes the offending step the replayed steps in
  between reset it and the loop retries forever.
* A step may donate its input state (the captured step updates its
  buffers in place, and a failed replay has already written them).  So
  a failure always restores: from the newest checkpoint, or before the
  first one from a host copy of the starting state, which the loop holds
  until a checkpoint is committed.
* Under a mesh (``layout``: the state holds each rank's blocks) every
  rank runs the loop in step: the loss is the global one, so the NaN
  guard and an injector armed alike on every rank decide alike, every
  rank restores together (the checkpoints are elastic: ``checkpoint.py``)
  and the host copy of the starting state is the rank's blocks.  The
  data is the global batch of each step on every rank (``loss_fn`` keeps
  the rank's rows), so a sharded run trains on exactly the tokens a
  one-rank run does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.train.checkpoint import Checkpointer


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50        # 0: no checkpoint (a timing run)
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    max_nan_retries: int = 1


class FaultInjector:
    """Test hook: raise at given steps (once each)."""

    def __init__(self, fail_at: Optional[dict] = None):
        self.fail_at = dict(fail_at or {})

    def check(self, step: int):
        if step in self.fail_at:
            kind = self.fail_at.pop(step)
            raise RuntimeError(f"injected fault ({kind}) at step {step}")


def train_loop(
    train_step: Callable,
    state,
    data_cfg: DataConfig,
    loop_cfg: LoopConfig,
    ckpt_dir: str,
    *,
    fault_injector: Optional[FaultInjector] = None,
    log: Callable[[str], None] = print,
    layout=None,
):
    """Runs to ``loop_cfg.total_steps``; returns (state, {"history",
    "stragglers", "failures"}).  ``layout``: the state's
    ``sharding.rules.StateLayout`` under a mesh, which every rank runs
    the loop under."""
    ckpt = Checkpointer(ckpt_dir, keep=loop_cfg.keep_ckpts, layout=layout)
    start, initial = 0, None     # the restore point until a checkpoint
    if ckpt.latest_step() is not None:
        state, start, _ = ckpt.restore(state)
        log(f"[trainer] resumed from step {start}")
    else:
        initial = _host_copy(state)
    it = DataIterator(data_cfg, start_step=start, prefetch=2)

    history = []
    ema = None
    stragglers = failures = 0
    nan_at, nan_retries = None, 0        # the data step that gave a NaN
    step = start
    while step < loop_cfg.total_steps:
        batch = next(it)
        t0 = time.monotonic()
        try:
            if fault_injector is not None:
                fault_injector.check(step)
            new_state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        except Exception as e:
            failures += 1
            log(f"[trainer] step {step} failed: {e}; recovering")
            ckpt.wait()
            if ckpt.latest_step() is not None:
                state, rstep, _ = ckpt.restore(state)
            else:
                state, rstep = _device_copy(initial, state), 0
            if isinstance(e, FloatingPointError):
                nan_retries = nan_retries + 1 if nan_at == step else 1
                nan_at = step
                if nan_retries > loop_cfg.max_nan_retries:
                    rstep = max(rstep, step + 1)  # skip poisoned batch
                    nan_at, nan_retries = None, 0
            it.close()
            it = DataIterator(data_cfg, start_step=rstep, prefetch=2)
            step = rstep
            continue

        dt = time.monotonic() - t0
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        if dt > loop_cfg.straggler_factor * ema and step > start + 3:
            stragglers += 1
            log(f"[trainer] straggler: step {step} took {dt:.3f}s "
                f"(ema {ema:.3f}s)")
        state = new_state
        if step == nan_at:                   # the NaN's step went through
            nan_at, nan_retries = None, 0
        step += 1
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps:
            log(f"[trainer] step {step} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms)")
        history.append({"step": step, "loss": loss, "time_s": dt})
        if loop_cfg.ckpt_every and (step % loop_cfg.ckpt_every == 0
                                    or step == loop_cfg.total_steps):
            ckpt.save(step, state, extra={"data": it.state()},
                      blocking=False)
            if ckpt.latest_step() is not None:  # the save waits for the last
                initial = None
    ckpt.wait()
    it.close()
    return state, {"history": history, "stragglers": stragglers,
                   "failures": failures}


def _host_copy(state: dict) -> dict:
    return {k: _host_copy(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True) for k, v in state.items()}


def _device_copy(host: dict, like: dict) -> dict:
    """New tensors (never ``host``'s own) on ``like``'s devices."""
    return {k: _device_copy(v, like[k]) if isinstance(v, dict)
            else v.to(like[k].device, copy=True) for k, v in host.items()}
