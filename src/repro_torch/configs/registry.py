"""Architecture registry: ``--arch <id>`` resolution.

The reference's map and ids. The ten LM-seed config modules live in
``contrib/configs/``, outside both packages, so ``get_config`` raises
the reference's ``KeyError`` for every id unless a
``repro_torch.configs.<mod>`` module has been put in place.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .base import ArchConfig

_MODULES: Dict[str, str] = {
    "qwen2.5-32b": "qwen2_5_32b",
    "minitron-4b": "minitron_4b",
    "qwen3-4b": "qwen3_4b",
    "qwen2.5-3b": "qwen2_5_3b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "arctic-480b": "arctic_480b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    mod = _MODULES.get(arch_id) or _MODULES.get(arch_id.replace("_", "-"))
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; options: {sorted(_MODULES)}")
    try:
        module = importlib.import_module(f"{__package__}.{mod}")
    except ModuleNotFoundError as e:
        raise KeyError(
            f"arch {arch_id!r} is quarantined LM-seed scaffolding: its "
            f"config module now lives in contrib/configs/{mod}.py and is "
            "not importable from the installed package (see contrib/README.md)"
        ) from e
    return module.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
