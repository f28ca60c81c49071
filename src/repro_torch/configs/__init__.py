"""Workload configurations of the port.

``sparse_grid`` holds the combination technique's configurations.  The
LM architectures keep the reference's registry: ``get_config(arch_id)``
returns the FULL published config, ``get_smoke_config(arch_id)`` the
reduced same-family config of the CPU tests.  Each architecture's module
is the reference's, copied; every family is in
``models.transformer.FAMILIES``, so every architecture resolves (a config
of a family the reference does not know is refused with ``ValueError``).
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "DENSE_ARCH_IDS", "get_config", "get_smoke_config",
           "ported_arch_ids"]

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

#: The architectures of the dense family.
DENSE_ARCH_IDS: List[str] = ["chatglm3_6b", "glm4_9b", "smollm_360m",
                             "codeqwen15_7b"]



def _module(arch_id: str):
    from repro_torch.models.transformer import check_family
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    module = importlib.import_module(f"repro_torch.configs.{arch_id}")
    check_family(module.CONFIG)
    return module


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def ported_arch_ids() -> List[str]:
    """The architectures the port runs, in ``ARCH_IDS``' order."""
    from repro_torch.models.transformer import runs_family
    return [a for a in ARCH_IDS if runs_family(importlib.import_module(
        f"repro_torch.configs.{a}").CONFIG)]
