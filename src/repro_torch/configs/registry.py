"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Lists the architectures the port runs: every one of
``repro/configs/registry.py``, in its order."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "xlstm-125m",
    "internvl2-1b",
    "smollm-360m",
    "command-r-35b",
    "qwen3-1.7b",
    "qwen1.5-110b",
    "whisper-small",
    "hymba-1.5b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
]


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
