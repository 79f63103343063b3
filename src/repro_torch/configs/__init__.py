"""Architecture configs of the port (``repro/configs/`` counterpart).

Each arch lives in ``configs/<id>.py`` and registers itself here;
``get_config(name)`` is the lookup used by the launcher (``--arch <id>``).
Only the archs the port serves or trains so far are registered; the others
follow in ``ROADMAP.md`` order.  ``paper_models`` adds the paper's evaluation
models as search workloads and registers the runnable ``gpt3-15b`` config,
as the reference does.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = ["arctic_480b", "kimi_k2_1t_a32b", "mamba2_370m", "qwen3_4b",
                 "zamba2_1_2b"]

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    importlib.import_module("repro_torch.configs.paper_models")
