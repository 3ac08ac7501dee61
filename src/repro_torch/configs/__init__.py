"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Every architecture of the reference's registry, in its order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "minicpm-2b": "minicpm_2b",
    "glm4-9b": "glm4_9b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "whisper-small": "whisper_small",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    smoke = arch_id.endswith("-smoke")
    base_id = arch_id[: -len("-smoke")] if smoke else arch_id
    if base_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[base_id]}")
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if smoke else cfg
