"""The dry run's rule maker.  Counterpart of ``repro/launch/dryrun.py``,
of which only :func:`make_rules` (``dryrun.py:46-59``) is ported so far:
the serving launcher builds its rules with it, as the reference's does.
The rest of the dry run (lowering every cell against the production mesh)
is ROADMAP.md queue A, item 4.4."""
from __future__ import annotations

from repro_torch.sharding.rules import ShardingRules


def make_rules(mesh, *, mode: str, multi_pod: bool,
               seq_parallel: bool = False,
               serve_weight_fsdp: bool = False) -> ShardingRules:
    """serve_weight_fsdp: 2-D weight sharding even at serve time, for models
    whose TP-16 shard alone exceeds a device's memory (e.g. 110B dense)."""
    fsdp = "data" if (mode == "train" or serve_weight_fsdp) else None
    return ShardingRules(
        mesh=mesh,
        batch_axes=("pod", "data") if multi_pod else ("data",),
        model_axis="model",
        fsdp_axis=fsdp,
        seq_axis="model" if seq_parallel else None,
        expert_fsdp_axis="data",   # experts always need the extra axis
    )
