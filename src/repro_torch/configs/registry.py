"""--arch registry for the port: id -> ModelConfig (full + tiny variant).

The reference registry (``repro.configs``) pulls in JAX through its shapes
module, so the port keeps its own.  It lists every architecture of the
reference's registry: qwen2-vl-2b (mrope) serves through the paged engine
like the other decoders, whisper-large-v3 (encoder-decoder) through the
lockstep steps of ``runtime/steps.py`` only, as in the reference.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama2-7b": "llama2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-0.6b": "qwen3_0_6b",
    "yi-34b": "yi_34b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-large-v3": "whisper_large_v3",
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
