"""Architecture registry of the port (``repro/configs/__init__.py``).

The reference registers ten architectures and the port builds all ten:
the dense GQA and MLA models, the MoE family, the VLM backbone, the Mamba2
hybrid, xLSTM (``ssm``) and the Whisper-style encoder-decoder (``audio``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "internvl2-76b",
    "llama3-8b",
    "minicpm3-4b",
    "granite-3-2b",
    "stablelm-12b",
    "zamba2-1.2b",
    "whisper-base",
    "qwen2-moe-a2.7b",
    "dbrx-132b",
    "xlstm-1.3b",
]

# grad-accumulation microbatch counts for the train_4k cell, copied from the
# reference (its per-arch memory budget on a 16 GB v5e chip)
TRAIN_MICROBATCHES = {
    "internvl2-76b": 16,
    "dbrx-132b": 16,
    "stablelm-12b": 8,
    "llama3-8b": 8,
    "minicpm3-4b": 8,
    "granite-3-2b": 4,
    "zamba2-1.2b": 4,
    "qwen2-moe-a2.7b": 4,
    "xlstm-1.3b": 4,
    "whisper-base": 1,
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_tiny(arch: str) -> ModelConfig:
    return _module(arch).TINY


def train_microbatches(arch: str) -> int:
    return TRAIN_MICROBATCHES.get(arch, 1)
