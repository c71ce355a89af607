"""Architecture registry of the port: the 10 assigned configs.

``get_config(name)`` returns the exact published config;
``get_smoke_config(name)`` returns a same-family reduced config that runs
on the CPU in seconds.  The values, ids and aliases are copies of the JAX
package's registry, in its order.
"""

from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig, SHAPES, ShapeConfig, shape_applicable

ARCH_IDS: List[str] = [
    "stablelm_1_6b",
    "internlm2_20b",
    "qwen1_5_110b",
    "llama3_405b",
    "llama3_2_vision_90b",
    "jamba_1_5_large_398b",
    "whisper_tiny",
    "kimi_k2_1t_a32b",
    "deepseek_v2_lite_16b",
    "xlstm_350m",
]

# CLI aliases (assignment spelling -> module name)
ALIASES: Dict[str, str] = {
    "stablelm-1.6b": "stablelm_1_6b",
    "internlm2-20b": "internlm2_20b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama3-405b": "llama3_405b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-tiny": "whisper_tiny",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-350m": "xlstm_350m",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    return import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "ALIASES", "SHAPES", "ShapeConfig", "ModelConfig",
    "get_config", "get_smoke_config", "all_configs", "shape_applicable",
]
