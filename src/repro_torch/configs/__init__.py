"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

_MODULES = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    # float32 on CPU for numerically-stable smoke tests
    return importlib.import_module(_MODULES[arch_id]).smoke_config().replace(dtype="float32")
