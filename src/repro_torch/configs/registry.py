"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Lists the architectures the port runs: every one of
``repro/configs/registry.py`` but whisper-small, whose encoder-decoder
is not ported yet (``get_config`` says so)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "xlstm-125m",
    "internvl2-1b",
    "smollm-360m",
    "command-r-35b",
    "qwen3-1.7b",
    "qwen1.5-110b",
    "hymba-1.5b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
]

#: What refuses an encoder-decoder config, and the item of ROADMAP.md that
#: ports it.
ENC_DEC_NOT_PORTED = ("the encoder-decoder (dec/enc layers, cross-attention, "
                      "the encoder's K/V in the cache) is not ported yet: "
                      "ROADMAP.md queue A, item 4")
#: Architectures of the reference the port does not run yet.
NOT_PORTED = {"whisper-small": "whisper-small: " + ENC_DEC_NOT_PORTED}


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, smoke: bool = False):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[arch_id])
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs {ARCH_IDS}")
    m = _module(arch_id)
    return m.smoke_config() if smoke else m.CONFIG


def list_archs():
    return list(ARCH_IDS)
