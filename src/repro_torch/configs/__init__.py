"""Workload configurations of the port.

``sparse_grid`` holds the combination technique's configurations.  The
LM architectures keep the reference's registry: ``get_config(arch_id)``
returns the FULL published config, ``get_smoke_config(arch_id)`` the
reduced same-family config of the CPU tests.  Only the dense family is
ported; any other architecture raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "DENSE_ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS: List[str] = [
    "whisper_small",
    "qwen3_moe_235b_a22b",
    "olmoe_1b_7b",
    "chatglm3_6b",
    "glm4_9b",
    "smollm_360m",
    "codeqwen15_7b",
    "xlstm_1_3b",
    "zamba2_1_2b",
    "llava_next_34b",
]

#: The architectures of the dense family, the only one ported.
DENSE_ARCH_IDS: List[str] = ["chatglm3_6b", "glm4_9b", "smollm_360m",
                             "codeqwen15_7b"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    if arch_id not in DENSE_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id} is not of the dense family, the only one the port "
            f"runs yet (ROADMAP.md, Queue A 11: the LM stack's other "
            f"families)")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
