"""Model registry (``veloxseg_tpu/models/registry.py``): a name →
builder mapping over the reference's per-model JSON kwargs
(``config/models_config_*.json``).

A builder takes ``(model_config, device, seed)`` and returns an eval-mode
``nn.Module`` with weights seeded from ``seed``, on ``device`` (default
``"cuda"``; raises without CUDA unless ``device="cpu"``). Every model
takes and returns channels-last tensors: ``(B, D, H, W, C)`` in, logits
``(B, D, H, W, classes)`` out in eval mode.

Besides VeloxSeg and U-RWKV, the fifteen baselines of the zoo
(``veloxseg_tpu/models/zoo/``): UNet, VNet, MedNeXt, UNETR, SwinUNETR,
SegFormer, SlimUNETR, UNETRpp, VSmTrans, NestedFormer, A2FSeg, HDense,
SuperLightNet, U-KAN and HCMA-UNet, each reading the config keys (and
defaults) its JAX builder reads, and the input channels its JAX module
takes from the input.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

class CannotRunAtShape(ValueError):
    """A builder's refusal of an input size its model cannot run at (the
    JAX module fails there too): NestedFormer at Hecktor2022, whose
    window does not divide the 1/16 bottleneck. The speed CLI reports the
    model as skipped for this error alone."""


_REGISTRY: Dict[str, Callable] = {}
# models whose parameters depend on the input size → their size key
_SIZED: Dict[str, str] = {}


def register_model(name: str, sized: Union[bool, str] = False):
    """Register ``name``'s builder; ``sized``: its config's size key
    (``img_size`` where True) may come from :func:`load_model`'s
    ``input_size``."""
    def deco(builder: Callable):
        _REGISTRY[name] = builder
        if sized:
            _SIZED[name] = "img_size" if sized is True else sized
        return builder
    return deco


def available_models() -> List[str]:
    _ensure_builtin_imports()
    return sorted(_REGISTRY)


def load_model(model_name: str, model_config: Dict,
               device: Optional[Union[str, torch.device]] = None,
               seed: int = 0, input_size: Optional[Sequence[int]] = None
               ) -> torch.nn.Module:
    """Build ``model_name`` from its entry in ``model_config`` (a whole
    ``models_config_*.json`` dict). ``input_size``, the spatial size the
    model will run at (the serving patch, the speed CLI's shape), is the
    size (``img_size``, ``image_size``, ``patch_ini``) of a ``sized``
    model whose entry names none: SwinUNETR's bias tables are sized by it,
    where the JAX module sizes them at ``init``."""
    _ensure_builtin_imports()
    if model_name not in _REGISTRY:
        raise ValueError(f"No model named {model_name!r}; available: "
                         f"{available_models()}")
    cfg = dict(model_config[model_name])
    if input_size is not None and model_name in _SIZED:
        cfg.setdefault(_SIZED[model_name], [int(s) for s in input_size])
    return _REGISTRY[model_name](cfg, device, seed)


def _ensure_builtin_imports():
    # imported for their registration
    from .zoo import (a2fseg, basic_unet, hcma, hdense,  # noqa: F401
                      mednext, nestedformer, segformer3d, slim_unetr,
                      superlightnet, swin_unetr, ukan, unetr, unetrpp,
                      urwkv, vnet, vsmtrans)


@register_model("VeloxSeg")
def _build_veloxseg(cfg: Dict, device, seed: int) -> torch.nn.Module:
    from ..nn.veloxseg import build_veloxseg
    return build_veloxseg(cfg, device=device, seed=seed)[0]
