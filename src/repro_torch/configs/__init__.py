"""Architecture config registry. One module per assigned architecture.

``get_config(name)`` returns the exact assigned full-size config;
``get_config(name).reduced()`` is the smoke-test variant.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# assigned pool (10) + the paper's own evaluation models (2)
ARCHS = [
    "zamba2_7b",
    "phi3_vision_4_2b",
    "tinyllama_1_1b",
    "whisper_tiny",
    "granite_moe_3b_a800m",
    "mixtral_8x22b",
    "qwen3_8b",
    "qwen2_5_32b",
    "rwkv6_1_6b",
    "gemma2_2b",
    "qwen2_5_7b",   # paper's primary eval model (§5.1.2)
    "qwen2_5_72b",  # paper's large eval model (§5.1.2)
]

_ALIASES = {
    "zamba2-7b": "zamba2_7b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "whisper-tiny": "whisper_tiny",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-8b": "qwen3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "gemma2-2b": "gemma2_2b",
    "qwen2.5-7b": "qwen2_5_7b",
    "qwen2.5-72b": "qwen2_5_72b",
}

ASSIGNED = list(_ALIASES)[:10]


def get_config(name: str) -> ModelConfig:
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
