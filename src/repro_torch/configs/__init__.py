"""Architecture config registry of the port.

``get_config`` accepts the arch id ("llava-1.5-7b") or the module name
("llava_1_5_7b"), as the reference's registry does. Only the configs this
port serves are registered: every config of the reference that fits on
one card, attention-only, recurrent (mamba2-780m), hybrid
(recurrentgemma-2b) and encoder-decoder (seamless-m4t-large-v2);
kimi-k2-1t-a32b fits on none.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

_MODULES = {
    "qwen3_0_6b": "qwen3-0.6b",
    "llava_1_5_7b": "llava-1.5-7b",
    "granite_moe_3b_a800m": "granite-moe-3b-a800m",
    "internvl2_2b": "internvl2-2b",
    "qwen2_5_32b": "qwen2.5-32b",
    "yi_34b": "yi-34b",
    "granite_34b": "granite-34b",
    "mamba2_780m": "mamba2-780m",
    "recurrentgemma_2b": "recurrentgemma-2b",
    "seamless_m4t_large_v2": "seamless-m4t-large-v2",
}

_BY_NAME: Dict[str, ModelConfig] = {}


def _load() -> None:
    if _BY_NAME:
        return
    for mod, name in _MODULES.items():
        cfg: ModelConfig = importlib.import_module(
            f"repro_torch.configs.{mod}").CONFIG
        if cfg.name != name:
            raise ValueError(f"config module {mod} names {cfg.name!r}")
        _BY_NAME[name] = cfg


def get_config(name: str) -> ModelConfig:
    _load()
    name = _MODULES.get(name, name)
    if name not in _BY_NAME:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_BY_NAME)}")
    return _BY_NAME[name]


def list_configs() -> List[str]:
    _load()
    return sorted(_BY_NAME)
