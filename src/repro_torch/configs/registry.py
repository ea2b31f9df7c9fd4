"""--arch registry for the port: id -> ModelConfig (full + tiny variant).

The reference registry (``repro.configs``) pulls in JAX through its shapes
module, so the port keeps its own.  Only the architectures the port can
serve are listed; the rest join as their mixers are ported (ROADMAP).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama2-7b": "llama2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_tiny(arch: str) -> ModelConfig:
    return _module(arch).TINY
