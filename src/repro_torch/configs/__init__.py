"""Assigned-architecture registry: ``get_config(name)`` / ``--arch <id>``.

Each module defines ``CONFIG`` (the exact published architecture) built from
public literature; reduced same-family variants for CPU smoke tests come from
``repro_torch.models.config.reduced``.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig, reduced

ARCH_IDS = [
    "stablelm-12b",
    "deepseek-67b",
    "minicpm3-4b",
    "qwen2-72b",
    "hymba-1_5b",
    "internvl2-26b",
    "llama4-maverick-400b-a17b",
    "dbrx-132b",
    "mamba2-2_7b",
    "musicgen-medium",
]

_ALIASES = {
    "hymba-1.5b": "hymba-1_5b",
    "mamba2-2.7b": "mamba2-2_7b",
}


def get_config(name: str) -> ArchConfig:
    name = _ALIASES.get(name, name).replace(".", "_").replace("-", "_")
    for arch in ARCH_IDS:
        if arch.replace("-", "_").replace(".", "_") == name:
            mod = importlib.import_module(f".{arch.replace('-', '_')}",
                                          __package__)
            return mod.CONFIG
    raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")


def get_tiny_config(name: str) -> ArchConfig:
    return reduced(get_config(name))


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
