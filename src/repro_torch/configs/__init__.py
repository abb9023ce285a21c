"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

One module per assigned architecture; every config cites its source
paper/model-card.  ``reduce_config`` produces the CPU-runnable smoke variant
of the same family.  The modules are copies of the reference's
``repro/configs`` (pure data).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig, reduce_config

_ARCHS = [
    "qwen2_5_14b",
    "qwen3_moe_30b_a3b",
    "zamba2_1_2b",
    "seamless_m4t_medium",
    "xlstm_1_3b",
    "gemma3_12b",
    "internvl2_26b",
    "qwen3_8b",
    "h2o_danube_1_8b",
    "deepseek_v2_lite_16b",
]

_ALIAS = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-1.3b": "xlstm_1_3b",
    "gemma3-12b": "gemma3_12b",
    "internvl2-26b": "internvl2_26b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}


def list_archs() -> List[str]:
    return list(_ALIAS.keys())


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduce_config(get_config(arch))


__all__ = ["get_config", "get_smoke_config", "list_archs", "ModelConfig",
           "reduce_config"]
