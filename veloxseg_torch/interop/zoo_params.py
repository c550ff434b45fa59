"""JAX zoo params → the port's (reference-keyed) state dicts.

U-RWKV: the inverse of ``veloxseg_tpu/interop/zoo_import.py:
_map_urwkv_key`` (1127-1236), without the dead parameters it drops
(``_URWKV_DEAD``, 1117: they are not in the port's model either). As
:mod:`.jax_params`, it needs neither JAX nor the JAX package: ``params``
is the flax params tree as nested dicts of numpy arrays. Transforms (JAX →
reference): DHWIO conv kernels → ``(O, I/g, k, k, k)``; Dense ``(I, O)``
→ Linear ``(O, I)``, and the head's → 1×1 conv ``(O, I, 1, 1, 1)``;
``(C,)`` spatial-mix vectors → ``(1, 1, C)``; norm ``scale`` → ``weight``.
Any path that cannot be placed raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .jax_params import _conv3d, _dense, _flatten, _identity

_WB = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _mix_vector(w: np.ndarray) -> np.ndarray:
    return w.reshape(1, 1, -1)


def _urwkv_key(path: str):
    """One flax path ('a/b/c') of ``URWKV`` → (reference key, transform)."""
    def conv(key, kind):
        return key + "." + _WB[kind], _conv3d if kind == "kernel" \
            else _identity

    def norm(key, kind):
        return key + "." + _WB[kind], _identity

    m = re.fullmatch(r"stem_(conv|bn)/(kernel|bias|scale)", path)
    if m:
        return (conv if m[1] == "conv" else norm)(
            "stem." + ("0" if m[1] == "conv" else "1"), m[2])
    m = re.fullmatch(r"e([1-4])/(dwconv|bn)/(kernel|bias|scale)", path)
    if m:
        if m[2] == "dwconv":
            return conv(f"e{m[1]}.dwconv.dwconv", m[3])
        return norm(f"e{m[1]}.bn_in_c", m[3])
    m = re.fullmatch(r"e([1-5])/(pw_in4|pw_out|pw1|pw2)/(conv|bn)/"
                     r"(kernel|bias|scale)", path)
    if m:
        sub = {"pw_in4": "pwconv_in_in4", "pw_out": "pwconv_in4_out",
               "pw1": "pwconv1", "pw2": "pwconv2"}[m[2]]
        key = f"e{m[1]}.{sub}.conv." + ("0" if m[3] == "conv" else "1")
        return (conv if m[3] == "conv" else norm)(key, m[4])
    m = re.fullmatch(r"e5/dw_(\d)/(kernel|bias)", path)
    if m:
        return conv(f"e5.m.{m[1]}.dwconv", m[2])
    m = re.fullmatch(r"bx4rwkv/(gamma[12])", path)
    if m:
        spa = ".allinone_spa" if m[1] == "gamma1" else ""
        return f"bx4rwkv{spa}.{m[1]}", _identity
    m = re.fullmatch(r"bx4rwkv/(ln[12])/(scale|bias)", path)
    if m:
        spa = ".allinone_spa" if m[1] == "ln1" else ""
        return norm(f"bx4rwkv{spa}.{m[1]}", m[2])
    m = re.fullmatch(r"bx4rwkv/(spa_mix|ffn)/(.+)", path)
    if m:
        mod = "allinone_spa" if m[1] == "spa_mix" else "ffn"
        rest = m[2]
        if re.fullmatch(r"spatial_(decay|first)", rest):
            return f"bx4rwkv.{mod}.{rest}", _identity
        if re.fullmatch(r"spatial_mix_[kvr]", rest):
            return f"bx4rwkv.{mod}.{rest}", _mix_vector
        r = re.fullmatch(r"(key|value|receptance|output)/kernel", rest)
        if r:
            return f"bx4rwkv.{mod}.{r[1]}.weight", _linear
        r = re.fullmatch(r"key_norm/(scale|bias)", rest)
        if r:
            return norm(f"bx4rwkv.{mod}.key_norm", r[1])
        return None
    m = re.fullmatch(r"up([2-5])/(conv|bn)/(kernel|bias|scale)", path)
    if m:
        key = f"Up{m[1]}.up." + ("1" if m[2] == "conv" else "2")
        return (conv if m[2] == "conv" else norm)(key, m[3])
    m = re.fullmatch(r"upc([2-5])/(conv|bn)([123])/(kernel|bias|scale)", path)
    if m:
        idx = {("conv", "1"): 0, ("bn", "1"): 2, ("conv", "2"): 3,
               ("bn", "2"): 5, ("conv", "3"): 6, ("bn", "3"): 8}[
                   (m[2], m[3])]
        return (conv if m[2] == "conv" else norm)(
            f"Up_conv{m[1]}.conv.{idx}", m[4])
    m = re.fullmatch(r"head/(kernel|bias)", path)
    if m:
        return "Conv_1x1." + _WB[m[1]], _dense if m[1] == "kernel" \
            else _identity
    return None


def urwkv_state_dict_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """Flax ``URWKV`` params tree → reference-keyed state dict of float32
    CPU tensors, for ``URWKV.load_state_dict``."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for p, arr in _flatten(params):
        path = "/".join(p)
        mapped = _urwkv_key(path)
        if mapped is None:
            raise KeyError(f"unmapped JAX U-RWKV param path: {path}")
        key, tf = mapped
        out[key] = torch.from_numpy(np.array(tf(arr), np.float32))
    return out
