"""Model registry (``veloxseg_tpu/models/registry.py``): a name →
builder mapping over the reference's per-model JSON kwargs
(``config/models_config_*.json``).

A builder takes ``(model_config, device, seed)`` and returns an eval-mode
``nn.Module`` with weights seeded from ``seed``, on ``device`` (default
``"cuda"``; raises without CUDA unless ``device="cpu"``). Every model
takes and returns channels-last tensors: ``(B, D, H, W, C)`` in, logits
``(B, D, H, W, classes)`` out in eval mode.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(builder: Callable):
        _REGISTRY[name] = builder
        return builder
    return deco


def available_models() -> List[str]:
    _ensure_builtin_imports()
    return sorted(_REGISTRY)


def load_model(model_name: str, model_config: Dict,
               device: Optional[Union[str, torch.device]] = None,
               seed: int = 0) -> torch.nn.Module:
    """Build ``model_name`` from its entry in ``model_config`` (a whole
    ``models_config_*.json`` dict)."""
    _ensure_builtin_imports()
    if model_name not in _REGISTRY:
        raise ValueError(f"No model named {model_name!r}; available: "
                         f"{available_models()}")
    return _REGISTRY[model_name](model_config[model_name], device, seed)


def _ensure_builtin_imports():
    # imported for their registration
    from .zoo import urwkv  # noqa: F401


@register_model("VeloxSeg")
def _build_veloxseg(cfg: Dict, device, seed: int) -> torch.nn.Module:
    from ..nn.veloxseg import build_veloxseg
    return build_veloxseg(cfg, device=device, seed=seed)[0]
