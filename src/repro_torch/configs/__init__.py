"""Architecture registry of the port: one module per ported architecture.

Each module exports ``CONFIG`` (the exact published config) and
``SMOKE_CONFIG`` (a reduced same-family config for CPU tests). The port
serves gemma-2b (dense), mamba2-370m (SSM) and hymba-1.5b (hybrid); every
other architecture of the reference registry raises, naming the later
slice that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_ARCH_MODULES = {
    "gemma-2b": "gemma_2b",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1p5b",
}

#: architectures the reference serves that this port does not yet, with
#: the slice of the port that brings each one
_LATER = {
    "yi-9b": "the dense-family slice (other dense configs)",
    "qwen3-14b": "the dense-family slice (other dense configs)",
    "qwen2.5-14b": "the dense-family slice (other dense configs)",
    "internvl2-76b": "the dense-family slice (patch_stub frontend)",
    "olmoe-1b-7b": "the model-families slice (MoE)",
    "dbrx-132b": "the model-families slice (MoE)",
    "whisper-tiny": "the model-families slice (encoder-decoder)",
}

ARCH_NAMES = tuple(_ARCH_MODULES)
#: every architecture of the reference registry, ported or not
REFERENCE_ARCH_NAMES = ARCH_NAMES + tuple(_LATER)


def _load(arch: str):
    if arch in _LATER:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet; it arrives with "
            f"{_LATER[arch]}. Ported: {list(ARCH_NAMES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE_CONFIG
