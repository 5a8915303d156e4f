"""Architecture registry: ``--arch <id>`` -> config.

The port serves the dense Llama family and the attention-free SSM family
(mamba2-370m); the other ids of the JAX registry raise
``NotImplementedError`` until their family is ported (ROADMAP, Queue 1
item 6).
"""
from __future__ import annotations

import importlib

from ..configs.base import ModelConfig

ARCH_IDS = [
    "deepseek-67b", "stablelm-12b", "qwen2.5-32b",
    "gemma2-27b", "zamba2-2.7b", "deepseek-v3-671b", "mixtral-8x22b",
    "hubert-xlarge", "qwen2-vl-7b",
]
# the paper's dense Llama workloads and the SSM family: the ids the port
# serves
PORTED_IDS = ["llama3-100m", "llama3-500m", "llama3-1b", "llama3-3b",
              "llama2-7b", "mamba2-370m"]


def _module(arch: str):
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet (ROADMAP, Queue 1 "
            "item 6: other families); ported ids: " + ", ".join(PORTED_IDS))
    if arch not in PORTED_IDS:
        raise KeyError(arch)
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
