"""Checkpointing: atomic, checksummed, async, with a corruption fallback.
Counterpart of ``repro/train/checkpoint.py``, in numpy files of its own.

Layout (one directory per step):

    ckpt_dir/
      step_000000123/
        arrays.npz            # flat {path -> array}
        manifest.json         # step, extra (the data state), per-key
                              # sha256 prefix, each key's torch dtype
      step_000000123.COMMITTED  # atomic marker written last
      latest                  # text file: the last committed step's name

* The state is a nested dict of tensors; a key is the dict path joined
  by ``/`` (a parameter's own name keeps its dots).  bf16 tensors, which
  numpy cannot hold, are stored as their 16-bit patterns and the manifest
  names the dtype.
* An atomic commit marker: a job killed mid-save never corrupts
  ``latest``; restore scans for the newest committed step and verifies
  every checksum, falling back to the step before on a mismatch or an
  unreadable file.
* Async: :meth:`Checkpointer.save` copies the state to the host at once
  (the step's tensors may be freed after) and writes in a thread.
* ``keep`` committed steps are kept; older ones are removed.
* Elastic (the reference's ``shardings=``, ``repro/train/checkpoint.py:
  142-162``): under a mesh (``layout``, a ``sharding.rules.StateLayout``)
  the state holds each rank's blocks.  :meth:`Checkpointer.save` gathers
  every leaf whole over the mesh (``StateLayout.whole``: every rank takes
  part, one leaf at a time; a fused projection such as the Mamba's
  ``w_in`` and its moments part by part) and rank 0 writes the full
  arrays, the one-device format; :meth:`Checkpointer.restore` reads the
  full arrays and cuts the rank's blocks under the layout in force
  (``StateLayout.block``), so a checkpoint written under
  one mesh (or one device) restores under any other.  Only rank 0 writes,
  and :meth:`Checkpointer.wait` ends at a barrier of every rank, so the
  ranks read the same committed steps after it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + SEP))
        else:
            flat[key] = v
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype == str(torch.bfloat16):
        t = t.view(torch.bfloat16)
    return t


def _unflatten_into(template, flat: dict, dtypes: dict, prefix: str = "",
                    cut=None):
    """New tensors of ``flat``'s arrays in ``template``'s tree, on its
    devices in its dtypes; ``cut(key, tensor)`` (if given) takes each
    stored tensor to the rank's block of it first."""
    out = {}
    for k, v in template.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _unflatten_into(v, flat, dtypes, key + SEP, cut)
            continue
        t = _from_numpy(flat[key], dtypes[key])
        if cut is not None:
            t = cut(key, t)
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"{key}: stored {tuple(t.shape)}, template "
                             f"{tuple(v.shape)}")
        out[k] = t.to(device=v.device, dtype=v.dtype)
    return out


def _leaf(key: str):
    """``(parameter name, whether a moment)`` of a train state's flattened
    key (``params/<name>``, ``err/<name>``, ``opt/mu/<name>``,
    ``opt/nu/<name>``), or None for the step counter (replicated)."""
    head, _, rest = key.partition(SEP)
    if head != "opt":
        return rest, False
    kind, _, name = rest.partition(SEP)
    return (name, True) if kind in ("mu", "nu") else None


def whole_leaves(state, layout):
    """``(key, tensor)`` of every leaf of a train state whole, one leaf at a
    time: under ``layout`` (a ``sharding.rules.StateLayout``) gathered
    over its mesh, a fused projection and its moments part by part
    (``StateLayout.whole``; every rank takes part, so every rank runs the
    generator to its end); without one the leaves themselves."""
    for k, v in _flatten(state).items():
        leaf = None if layout is None else _leaf(k)
        yield k, (v if leaf is None else layout.whole(leaf[0], v, leaf[1]))


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


class Checkpointer:
    """Checkpoints of a train state under ``ckpt_dir``; under a mesh
    (``layout``) of the rank's blocks, stored whole (elastic)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, layout=None):
        self.dir = ckpt_dir
        self.keep = keep
        self.layout = (layout if layout is not None
                       and layout.mesh.size > 1 else None)
        self.writer = self.layout is None or dist.get_rank() == 0
        if self.writer:
            os.makedirs(ckpt_dir, exist_ok=True)
        self._barrier()
        self._thread: Optional[threading.Thread] = None

    def _barrier(self):
        if self.layout is not None:
            dist.barrier()

    def _gathered(self, state) -> dict:
        """``{key: host array}`` of every leaf whole (:func:`whole_leaves`):
        under a mesh every rank gathers each leaf, and rank 0 alone keeps
        it (the others get an empty dict)."""
        host = {}
        for k, whole in whole_leaves(state, self.layout):
            if self.writer:
                host[k] = _to_numpy(whole)
        return host

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, extra: Optional[dict] = None,
             blocking: bool = True):
        self.wait()
        # snapshot now (to the host); write later
        host = self._gathered(state)
        dtypes = {k: str(v.dtype) for k, v in _flatten(state).items()}
        if not self.writer:
            if blocking:
                self._barrier()
            return
        if blocking:
            self._write(step, host, dtypes, extra or {})
            self._barrier()
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, dtypes, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self):
        """The pending write finished; under a mesh every rank waits for
        rank 0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    def _write(self, step: int, flat: dict, dtypes: dict, extra: dict):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "extra": extra, "dtypes": dtypes,
                    "checksums": {k: _checksum(v) for k, v in flat.items()}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, name + ".COMMITTED"), "w") as f:
            f.write(str(step))
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.dir, "latest.tmp"),
                   os.path.join(self.dir, "latest"))
        self._gc()

    def _gc(self):
        steps = sorted(self.committed_steps())
        for s in steps[: -self.keep]:
            name = f"step_{s:09d}"
            shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, name + ".COMMITTED"))
            except FileNotFoundError:
                pass

    # -------------------------------------------------------------- restore
    def committed_steps(self) -> list:
        out = []
        for fn in os.listdir(self.dir):
            if fn.endswith(".COMMITTED"):
                out.append(int(fn[len("step_"):-len(".COMMITTED")]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> tuple[Any, int, dict]:
        """Returns (state, step, extra): new tensors on the template's
        devices in its dtypes (under a mesh the rank's blocks of the
        stored arrays, cut under the layout).  Verifies checksums; falls
        back to the previous committed step on corruption."""
        cut = None
        if self.layout is not None:
            def cut(key, t):
                leaf = _leaf(key)
                return t if leaf is None else self.layout.block(
                    leaf[0], t, leaf[1])
        steps = self.committed_steps()
        if step is not None:
            steps = [s for s in steps if s <= step]
        while steps:
            s = steps.pop()
            name = f"step_{s:09d}"
            try:
                with open(os.path.join(self.dir, name, "manifest.json")) as f:
                    manifest = json.load(f)
                with np.load(os.path.join(self.dir, name, "arrays.npz")) as z:
                    flat = {k: z[k] for k in z.files}
                for k, v in flat.items():
                    if _checksum(v) != manifest["checksums"][k]:
                        raise IOError(f"checksum mismatch at {k}")
                state = _unflatten_into(template, flat, manifest["dtypes"],
                                        cut=cut)
                return state, manifest["step"], manifest.get("extra", {})
            except Exception as e:  # corrupted -> try previous
                print(f"[ckpt] step {s} unusable ({e}); trying previous")
        raise FileNotFoundError(f"no usable checkpoint in {self.dir}")
