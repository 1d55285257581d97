"""--arch <id> registry for the assigned architectures."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

ARCH_IDS: List[str] = list(_MODULES)

# archs with a sub-quadratic sequence path: the only ones that run long_500k
SUBQUADRATIC: List[str] = ["zamba2-2.7b", "rwkv6-3b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).smoke_config()


def shape_applicable(arch: str, shape_name: str) -> bool:
    """Which (arch x shape) cells run.  long_500k is sub-quadratic-only."""
    if shape_name == "long_500k":
        return arch in SUBQUADRATIC
    return True
