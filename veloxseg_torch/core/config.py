"""VeloxSeg model configuration.

The fields mirror the reference constructor (``model/VeloxSeg.py:64-94``),
so the reference ``config/models_config_*.json`` entries load unchanged.
A frozen dataclass: the window layouts and module shapes derive from it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple


def _t(x) -> tuple:
    """Recursively convert lists to tuples."""
    if isinstance(x, (list, tuple)):
        return tuple(_t(v) for v in x)
    return x


def load_json_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class VeloxSegConfig:
    """VeloxSeg model hyper-parameters (reference constructor kwargs)."""

    input_size: Tuple[int, int, int] = (96, 96, 96)
    patch_size: int = 4
    in_ch: Tuple[int, ...] = (1, 1)
    n_classes: int = 2
    base_ch: int = 16

    conv_depths: Tuple[int, ...] = (1, 1, 1, 1)
    kernel_sizes: Tuple[int, ...] = (1, 3, 5)
    min_dim_group: Tuple[int, ...] = (4, 8, 8, 16)
    conv_expansion_factor: Tuple[int, ...] = (3, 3, 2, 2)

    attn_base_ch: int = 16
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    min_big_window_sizes: Tuple[Tuple[int, int, int], ...] = (
        (3, 3, 3), (6, 6, 6), (3, 3, 3), (3, 3, 3))
    min_small_window_sizes: Tuple[Tuple[int, int, int], ...] = (
        (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1))
    min_dim_head: Tuple[int, ...] = (4, 8, 8, 16)
    scale_factors: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 2, 4)
    attn_drop: float = 0.1
    proj_drop: float = 0.1
    drop_path: float = 0.0
    ffn_expansion_ratio: Tuple[int, ...] = (3, 3, 2, 2)
    act_layer: str = "GELU"
    patch_norm: bool = False
    qkv_bias: bool = True

    conv_drop: float = 0.0
    deep_supervision: bool = True
    spatial_dim: int = 3

    @property
    def num_modalities(self) -> int:
        return len(self.in_ch)

    @property
    def num_levels(self) -> int:
        return len(self.conv_depths)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VeloxSegConfig":
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k in ("norm_layer",):  # class-valued in the reference; fixed here
                continue
            if k not in field_names:
                raise ValueError(f"Unknown VeloxSeg config key: {k!r}")
            kwargs[k] = _t(v)
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "VeloxSegConfig":
        return dataclasses.replace(self, **{k: _t(v) for k, v in kw.items()})


def flagship_config(size=(128, 128, 128)) -> VeloxSegConfig:
    """The JAX package's benchmark model (``bench.py:53-63``, ``_flagship``):
    the default config at depth 1 per level and ``input_size`` ``size``;
    where ``size`` is not a multiple of 3, the power-of-two window pyramid
    ((4,4,4), (8,8,8), (4,4,4), (4,4,4)), whose level 1 has 1024-token
    windows at 128³."""
    cfg = VeloxSegConfig().replace(depths=(1, 1, 1, 1),
                                   input_size=tuple(size))
    if size[0] % 3 != 0:
        cfg = cfg.replace(min_big_window_sizes=(
            (4, 4, 4), (8, 8, 8), (4, 4, 4), (4, 4, 4)))
    return cfg
