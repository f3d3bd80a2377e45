"""Meshes: named axes over the ranks of a ``torch.distributed`` world.
Counterpart of ``repro/launch/mesh.py``.

A :class:`Mesh` is a tuple of axis names and sizes.  Where a process group
exists it also holds the groups of each axis, made by
``torch.distributed.device_mesh.init_device_mesh`` (rank ``r`` sits at the
row-major coordinates of ``r`` in the axis sizes, as the reference's mesh
orders its devices); without one it is abstract, as the reference's
production mesh is under its dry run: the sharding rules read only
``.shape``.

* :func:`make_host_mesh` — ``(world // model, model)`` over ``("data",
  "model")``, the world being the process group's (1 without one).
* :func:`make_production_mesh` — the (16, 16) single-pod and (2, 16, 16)
  multi-pod shapes; groups only where the world has that many ranks.
* :func:`init_world` — the process group of a ``torchrun`` launch: NCCL on
  cards (rank ``r`` on ``cuda:LOCAL_RANK``) or gloo, with a timeout on its
  set-up and on every collective.

Nothing here touches ``torch.distributed`` at import time.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

#: The host mesh's axes (``repro/launch/mesh.py:43``).
HOST_AXES = ("data", "model")
#: Seconds a rank waits at the group's set-up and in any one collective
#: before it fails, so that a lost rank never leaves the others waiting.
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a world of ranks; ``device_mesh`` (a
    ``torch.distributed`` ``DeviceMesh``) holds the process groups of each
    axis where they exist."""
    axis_names: tuple
    axis_sizes: tuple
    device_mesh: Optional[object] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> dict:
        """This rank's ``{axis: index}`` (all 0 on an abstract mesh)."""
        if self.device_mesh is None:
            return dict.fromkeys(self.axis_names, 0)
        return dict(zip(self.axis_names,
                        self.device_mesh.get_coordinate()))

    def group(self, axis: str):
        """The process group of ``axis`` for this rank, or None where the
        axis has one rank (every collective over it is the identity).
        Raises on an abstract mesh: it has no ranks to run on."""
        if self.shape[axis] == 1:
            return None
        if self.device_mesh is None:
            raise RuntimeError(
                f"the mesh {self.shape} has no process group: it runs only "
                f"in a world of {self.size} ranks")
        return self.device_mesh.get_group(axis)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    # gloo's groups are made on the host: a "cuda" mesh would set each
    # rank's card from LOCAL_RANK, which several gloo ranks sharing one
    # card do not have
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes``, with its groups where the
    process group's world has exactly that many ranks."""
    shape, axes = tuple(shape), tuple(axes)
    if dist.is_initialized() and _world() == math.prod(shape):
        return Mesh(axes, shape, _device_mesh(shape, axes))
    return Mesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: abstract unless the world has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else HOST_AXES
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """``(world // model, model)`` over ("data", "model"); ``model`` must
    divide the world."""
    n = _world()
    if model < 1 or n % model:
        raise ValueError(f"--model-parallel {model} does not divide a world "
                         f"of {n} ranks")
    return make_mesh((n // model, model), HOST_AXES)


def init_world(backend: str, device: str = "cuda", *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """The process group of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT`` from the
    environment), with ``timeout_s`` on its set-up and on each collective.
    Returns the rank's device: under NCCL ``cuda:LOCAL_RANK`` (NCCL runs
    one rank a card and refuses a world larger than the cards); under gloo
    the CPU for ``device="cpu"``, else ``cuda:LOCAL_RANK % cards`` (several
    ranks may share one card)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on cards: use --backend gloo with "
                             "--device cpu")
        dist.init_process_group("gloo", timeout=timeout)
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the ranks on the CPU under gloo")
    if backend == "nccl" and world > cards:
        raise RuntimeError(
            f"NCCL runs one rank a card: a world of {world} ranks needs "
            f"{world} cards, this host has {cards} (several ranks share one "
            f"card only under --backend gloo)")
    dev = torch.device("cuda", local % cards)
    torch.cuda.set_device(dev)
    if backend == "nccl":
        dist.init_process_group("nccl", timeout=timeout, device_id=dev)
    else:
        dist.init_process_group("gloo", timeout=timeout)
    return dev
