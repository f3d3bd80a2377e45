"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Lists only the architectures the port runs; later slices add theirs
(``repro/configs/registry.py`` has all ten)."""
from __future__ import annotations

import importlib

ARCH_IDS = ["xlstm-125m", "hymba-1.5b"]


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs {ARCH_IDS}")
    m = _module(arch_id)
    return m.smoke_config() if smoke else m.CONFIG


def list_archs():
    return list(ARCH_IDS)
