"""Architecture registry of the port: one module per architecture.

Each module exports ``CONFIG`` (the exact published config) and
``SMOKE_CONFIG`` (a reduced same-family config for CPU tests). The port
serves every architecture of the reference registry, in its order:
dense (gemma-2b, qwen3-14b, qwen2.5-14b, yi-9b), the patch_stub VLM
(internvl2-76b), MoE (olmoe-1b-7b, dbrx-132b), SSM (mamba2-370m), hybrid
(hymba-1.5b) and encoder-decoder (whisper-tiny).
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ModelConfig

_ARCH_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "internvl2-76b": "internvl2_76b",
    "dbrx-132b": "dbrx_132b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma-2b": "gemma_2b",
    "qwen3-14b": "qwen3_14b",
    "qwen2.5-14b": "qwen2p5_14b",
    "yi-9b": "yi_9b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-370m": "mamba2_370m",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _load(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE_CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_NAMES}
