"""Architecture registry: one module per assigned architecture.

Each module provides ``config()`` (the exact public configuration) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib

ARCHS = (
    "minitron_4b",
    "mistral_nemo_12b",
    "gemma2_2b",
    "qwen3_0_6b",
    "dbrx_132b",
    "deepseek_moe_16b",
    "internvl2_76b",
    "mamba2_1_3b",
    "recurrentgemma_9b",
    "musicgen_medium",
)

_ALIAS = {name.replace("_", "-"): name for name in ARCHS}
_ALIAS.update({"qwen3-0.6b": "qwen3_0_6b", "mamba2-1.3b": "mamba2_1_3b"})


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    if name in _ALIAS:
        return _ALIAS[name]
    raise KeyError(f"unknown architecture {name!r}; known: {list(ARCHS)}")


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke_config() if smoke else mod.config()
