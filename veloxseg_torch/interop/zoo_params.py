"""JAX zoo params → the port's state dicts, one function per model.

As :mod:`.jax_params`, they need neither JAX nor the JAX package:
``params`` is the flax params tree as nested dicts of numpy arrays (or
``{"params": tree}``). Any path that cannot be placed raises.

- Reference-keyed models, each the exact inverse of its map in
  ``veloxseg_tpu/interop/zoo_import.py``: U-RWKV (``_map_urwkv_key``,
  1127-1236, without the dead parameters it drops, ``_URWKV_DEAD``, 1117,
  which the port's model lacks too), MedNeXt (``_map_mednext_key``, 82),
  SlimUNETR (``_make_slim_mapper``, 199, with the qkv split by heads of
  ``_slim_qkv_tf``, 139), SegFormer (``_map_segformer_key``, 253) and
  UNETRpp (``_map_unetrpp_key``, 665).
- The four MONAI models of the reference (UNet, VNet, UNETR, SwinUNETR)
  have no key map in the JAX package: the port's keys are the flax paths
  with ``/`` as ``.``, ``kernel`` and ``scale`` as ``weight``.

Transforms (JAX → port): a DHWIO conv kernel → ``(O, I/g, k, k, k)`` (a
depthwise transposed conv's ``(k, k, k, 1, C)`` → ``(C, 1, k, k, k)`` by
the same permutation); a transposed conv's DHWIO kernel → ``(I, O, k, k,
k)`` (the JAX module flips it when it runs, the port's transposed conv is
that function unflipped); Dense ``(I, O)`` → Linear ``(O, I)`` or 1×1 conv
``(O, I, 1, 1, 1)`` (or 1×1 transposed conv ``(I, O, 1, 1, 1)``); flax
attention's ``(I, h, d)`` and ``(h, d, O)`` kernels → Linear; U-RWKV's
``(C,)`` spatial-mix vectors → ``(1, 1, C)``; norm ``scale`` →
``weight``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from typing import Callable, Optional, Sequence, Tuple

from .jax_params import _conv3d, _dense, _flatten, _identity

_WB = {"kernel": "weight", "scale": "weight", "bias": "bias"}
Mapped = Optional[Tuple[str, Callable]]


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _mix_vector(w: np.ndarray) -> np.ndarray:
    return w.reshape(1, 1, -1)


def _convT(w: np.ndarray) -> np.ndarray:
    """Transposed conv DHWIO ``(k, k, k, I, O)`` → ``(I, O, k, k, k)``."""
    return np.transpose(w, (3, 4, 0, 1, 2))


def _convT_1x1(w: np.ndarray) -> np.ndarray:
    """Dense ``(I, O)`` → 1×1 transposed conv ``(I, O, 1, 1, 1)``."""
    return w[:, :, None, None, None]


def _mha_in(w: np.ndarray) -> np.ndarray:
    """flax attention's q/k/v kernel ``(I, h, d)`` → Linear ``(h·d, I)``."""
    return w.reshape(w.shape[0], -1).T


def _mha_out(w: np.ndarray) -> np.ndarray:
    """flax attention's output kernel ``(h, d, O)`` → Linear
    ``(O, h·d)``."""
    return w.reshape(-1, w.shape[-1]).T


def _flat(w: np.ndarray) -> np.ndarray:
    return w.reshape(-1)


def _leaf(key: str, kind: str, kernel_tf: Callable) -> Tuple[str, Callable]:
    """``key.weight`` or ``key.bias`` of one leaf; the kernel transformed."""
    return key + "." + _WB[kind], kernel_tf if kind == "kernel" \
        else _identity


def _state_dict(params: Mapping[str, Any], key_fn: Callable[[str], Mapped],
                what: str) -> Dict[str, torch.Tensor]:
    """Every leaf of ``params`` placed by ``key_fn`` (a flax path 'a/b/c'
    → (port key, transform) or None) as float32 CPU tensors."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for p, arr in _flatten(params):
        path = "/".join(p)
        mapped = key_fn(path)
        if mapped is None:
            raise KeyError(f"unmapped JAX {what} param path: {path}")
        key, tf = mapped
        out[key] = torch.from_numpy(np.ascontiguousarray(tf(arr),
                                                         np.float32))
    return out


def _flax_path_key(path: str, rules: Sequence[Tuple[str, Callable]]
                   ) -> Mapped:
    """A flax path of a model keyed by its flax paths: the module path
    must match one of ``rules`` (regex, kernel transform); its leaf is
    ``kernel``, ``scale`` or ``bias`` (made 1-D)."""
    *mods, leaf = path.split("/")
    mod = "/".join(mods)
    for pattern, tf in rules:
        if re.fullmatch(pattern, mod):
            key = mod.replace("/", ".")
            if leaf == "kernel" and tf is not None:
                return key + ".weight", tf
            if leaf == "scale":
                return key + ".weight", _identity
            if leaf == "bias":
                return key + ".bias", _flat
            return None
    return None


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
    return _state_dict(params, _urwkv_key, "U-RWKV")


# ---------------------------------------------------------------------------
# The MONAI models: flax paths

_UNET_RULES = (
    (r"(conv_0|down_[1-4]|upcat_[1-4]_convs)/(conv|norm)_[01]", _conv3d),
    (r"upcat_[1-4]_deconv", _convT),
    (r"final_conv", _dense))

_VNET_RULES = (
    (r"(in_tr|down_tr\d+|up_tr\d+)(/conv_\d)?/(conv|bn)", _conv3d),
    (r"down_tr\d+/down_conv|out_conv|out_bn", _conv3d),
    (r"up_tr\d+/up_conv", _convT),
    (r"out_proj", _dense))

_UNETR_RULES = (
    (r"patch_embed", _conv3d),
    (r"l\d+_attn/(query|key|value)", _mha_in),
    (r"l\d+_attn/out", _mha_out),
    (r"l\d+_fc[12]", _linear),
    (r"l\d+_norm[12]|final_norm", None),
    (r"(encoder1|encoder[234]/up_\d+/conv|decoder[2-5]_conv)/"
     r"(conv[12]|res_conv|norm[12]|res_norm)", _conv3d),
    (r"encoder[234]/(deconv_init|up_\d+/deconv)|decoder[2-5]_deconv", _convT),
    (r"out", _dense))

_SWIN_RULES = (
    (r"patch_embed", _conv3d),
    (r"stage\d+_block\d+/(norm[12])|merge\d+/norm|hs_norm\d+", None),
    (r"stage\d+_block\d+/(attn/qkv|attn/proj|fc[12])|merge\d+/reduction",
     _linear),
    (r"(encoder(1|2|3|4|10)|decoder[1-5]_conv)/conv[123]", _conv3d),
    (r"decoder[1-5]_deconv", _convT),
    (r"out", _dense))


def unet_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``BasicUNet`` params → the port's UNet state dict."""
    return _state_dict(params, lambda p: _flax_path_key(p, _UNET_RULES),
                       "UNet")


def vnet_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``VNet`` params → the port's VNet state dict."""
    return _state_dict(params, lambda p: _flax_path_key(p, _VNET_RULES),
                       "VNet")


def unetr_state_dict_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """Flax ``UNETR`` params → the port's UNETR state dict."""
    def key(path):
        if path == "pos_embed":
            return path, _identity
        return _flax_path_key(path, _UNETR_RULES)
    return _state_dict(params, key, "UNETR")


def swin_unetr_state_dict_from_jax(params: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """Flax ``SwinUNETR`` params → the port's SwinUNETR state dict."""
    def key(path):
        m = re.fullmatch(r"(stage\d+_block\d+)/attn/rpb/table", path)
        if m:
            return (f"{m[1]}.attn.rpb.relative_position_bias_table",
                    _identity)
        return _flax_path_key(path, _SWIN_RULES)
    return _state_dict(params, key, "SwinUNETR")


# ---------------------------------------------------------------------------
# MedNeXt: the inverse of zoo_import._map_mednext_key

_MEDNEXT_INNER = {"dw": ("conv1", _conv3d), "dw_up": ("conv1", _conv3d),
                  "norm": ("norm", None), "expand": ("conv2", _dense),
                  "compress": ("conv3", _dense)}


def _mednext_key(path: str) -> Mapped:
    m = re.fullmatch(r"stem/(kernel|bias)", path)
    if m:
        return _leaf("stem", m[1], _dense)
    m = re.fullmatch(r"(enc|dec)([0-3])_(\d+)/(dw|norm|expand|compress)/"
                     r"(kernel|bias|scale)", path)
    m = m or re.fullmatch(r"(bottleneck)()_(\d+)/(dw|norm|expand|compress)/"
                          r"(kernel|bias|scale)", path)
    if m:
        stage = {"enc": f"enc_block_{m[2]}", "dec": f"dec_block_{m[2]}",
                 "bottleneck": "bottleneck"}[m[1]]
        attr, tf = _MEDNEXT_INNER[m[4]]
        return _leaf(f"{stage}.{m[3]}.{attr}", m[5], tf)
    m = re.fullmatch(r"(down|up)([0-3])/(dw|dw_up|norm|expand|compress|res)/"
                     r"(kernel|bias|scale)", path)
    if m:
        if (m[1] == "up") != (m[3] == "dw_up") and m[3] in ("dw", "dw_up"):
            return None
        if m[3] == "res":
            return _leaf(f"{m[1]}_{m[2]}.res_conv", m[4],
                         _convT if m[1] == "up" else _conv3d)
        attr, tf = _MEDNEXT_INNER[m[3]]
        return _leaf(f"{m[1]}_{m[2]}.{attr}", m[4], tf)
    m = re.fullmatch(r"out/(kernel|bias)", path)
    if m:
        return _leaf("out_0.conv_out", m[1], _convT_1x1)
    return None


def mednext_state_dict_from_jax(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Flax ``MedNeXt`` params → reference-keyed state dict."""
    return _state_dict(params, _mednext_key, "MedNeXt")


# ---------------------------------------------------------------------------
# SlimUNETR: the inverse of zoo_import._make_slim_mapper

_SLIM_INNER = {
    "patch1": ("patch1.positional_encoding", _conv3d),
    "pw0": ("LocalRC.pointwise_conv_0", _dense),
    "dw": ("LocalRC.depthwise_conv", _conv3d),
    "pw1": ("LocalRC.pointwise_conv_1", _dense),
    "lc1_up": ("LineConv1.line_conv_0", _dense),
    "lc1_down": ("LineConv1.line_conv_1", _dense),
    "patch2": ("patch2.positional_encoding", _conv3d),
    "diffuse": ("LocalRD.conv_trans", _conv3d),   # depthwise, transposed
    "pw2": ("LocalRD.pointwise_conv", _dense),
    "lc2_up": ("LineConv2.line_conv_0", _dense),
    "lc2_down": ("LineConv2.line_conv_1", _dense),
    "bn1": ("LocalRC.bn1", None), "bn2": ("LocalRC.bn2", None),
    "gn": ("LocalRD.norm", None),
}


def _slim_qkv(heads: int) -> Callable:
    """Dense ``(C, 3C)``, columns (q/k/v, head, channel) → 1×1 conv
    ``(3C, C, 1, 1, 1)``, rows (head, q/k/v, channel): the reference's
    order, which ``_slim_qkv_tf`` permutes the other way."""
    def tf(w: np.ndarray) -> np.ndarray:
        c = w.shape[0]
        rows = np.transpose(w).reshape(3, heads, c // heads, c)
        return np.transpose(rows, (1, 0, 2, 3)).reshape(3 * c, c)[
            :, :, None, None, None]
    return tf


def slim_unetr_state_dict_from_jax(params: Mapping[str, Any],
                                   heads: Sequence[int] = (1, 2, 4, 4)
                                   ) -> Dict[str, torch.Tensor]:
    """Flax ``SlimUNETR`` params → reference-keyed state dict; ``heads``
    per stage, as the config's (the qkv rows are grouped by head)."""
    def key(path: str) -> Mapped:
        m = re.fullmatch(r"enc_down(\d)_(conv|gn)/(kernel|bias|scale)",
                         path)
        if m:
            sub = "depth_wise" if m[2] == "conv" else "norm"
            return _leaf(f"Encoder.DWconv{int(m[1]) + 1}.{sub}", m[3],
                         _conv3d)
        if path == "position_embeddings":
            return "Encoder.position_embeddings", _identity
        m = re.fullmatch(r"(enc|dec)_block(\d)_(\d+)/(\w+)/"
                         r"(kernel|bias|scale)", path)
        if m:
            s = int(m[2])
            blk = ("Encoder" if m[1] == "enc" else "Decoder") \
                + f".block{s + 1}.{m[3]}"
            if m[4] == "qkv" and m[5] == "kernel":
                return f"{blk}.GlobalST.qkv.weight", _slim_qkv(heads[s])
            if m[4] not in _SLIM_INNER:
                return None
            attr, tf = _SLIM_INNER[m[4]]
            return _leaf(f"{blk}.{attr}", m[5], tf)
        m = re.fullmatch(r"(dec_up(\d)|seg_head)_(conv|gn)/"
                         r"(kernel|bias|scale)", path)
        if m:
            mod = ("Decoder.SegHead" if m[1] == "seg_head"
                   else f"Decoder.TSconv{4 - int(m[2])}")
            sub = "transposed" if m[3] == "conv" else "norm"
            return _leaf(f"{mod}.{sub}", m[4], _convT)
        return None
    return _state_dict(params, key, "SlimUNETR")


# ---------------------------------------------------------------------------
# SegFormer: the inverse of zoo_import._map_segformer_key

def _segformer_key(path: str) -> Mapped:
    enc, dec = "segformer_encoder", "segformer_decoder"
    m = re.fullmatch(r"embed_(\d)/(kernel|bias)", path)
    if m:
        return _leaf(f"{enc}.embed_{int(m[1]) + 1}.patch_embeddings", m[2],
                     _conv3d)
    m = re.fullmatch(r"(embed_norm_|stage_norm_)(\d)/(scale|bias)", path)
    if m:
        s = int(m[2]) + 1
        mod = f"embed_{s}.norm" if m[1] == "embed_norm_" else f"norm{s}"
        return _leaf(f"{enc}.{mod}", m[3], None)
    m = re.fullmatch(r"s(\d)_b(\d+)_(norm[12]|attn|mlp)(/\w+)?/"
                     r"(kernel|bias|scale)", path)
    if m:
        blk = f"{enc}.tf_block{int(m[1]) + 1}.{m[2]}"
        sub = (m[4] or "")[1:]
        if m[3].startswith("norm") and not sub:
            return _leaf(f"{blk}.{m[3]}", m[5], None)
        table = {("attn", "query"): ("attention.query", _linear),
                 ("attn", "key_value"): ("attention.key_value", _linear),
                 ("attn", "proj"): ("attention.proj", _linear),
                 ("attn", "sr"): ("attention.sr", _conv3d),
                 ("attn", "sr_norm"): ("attention.sr_norm", None),
                 ("mlp", "fc1"): ("mlp.fc1", _linear),
                 ("mlp", "fc2"): ("mlp.fc2", _linear),
                 ("mlp", "dwconv"): ("mlp.dwconv.dwconv", _conv3d),
                 ("mlp", "bn"): ("mlp.dwconv.bn", None)}
        if (m[3], sub) not in table:
            return None
        attr, tf = table[(m[3], sub)]
        return _leaf(f"{blk}.{attr}", m[5], tf)
    m = re.fullmatch(r"linear_c(\d)(_norm)?/(kernel|bias|scale)", path)
    if m:
        sub = "bn" if m[2] else "proj"
        return _leaf(f"{dec}.linear_c{m[1]}.{sub}", m[3], _linear)
    if path == "linear_fuse/kernel":
        return f"{dec}.linear_fuse.0.weight", _dense
    m = re.fullmatch(r"fuse_bn/(scale|bias)", path)
    if m:
        return _leaf(f"{dec}.linear_fuse.1", m[1], None)
    m = re.fullmatch(r"linear_pred/(kernel|bias)", path)
    if m:
        return _leaf(f"{dec}.linear_pred", m[1], _dense)
    return None


def segformer_state_dict_from_jax(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """Flax ``SegFormer3D`` params → reference-keyed state dict."""
    return _state_dict(params, _segformer_key, "SegFormer")


# ---------------------------------------------------------------------------
# UNETR++: the inverse of zoo_import._map_unetrpp_key

def _upp_resblock(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"conv([123])/kernel", rest)
    if m:
        return f"{prefix}.conv{m[1]}.conv.weight", _conv3d
    m = re.fullmatch(r"norm([123])/(scale|bias)", rest)
    if m:
        return _leaf(f"{prefix}.norm{m[1]}", m[2], None)
    return None


def _upp_tblock(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"norm/(scale|bias)", rest)
    if m:
        return _leaf(f"{prefix}.norm", m[1], None)
    if rest in ("gamma", "pos_embed"):
        return f"{prefix}.{rest}", _identity
    if rest == "epa/qkvv/kernel":
        return f"{prefix}.epa_block.qkvv.weight", _linear
    m = re.fullmatch(r"epa/(EF|temperature2?)", rest)
    if m:
        return f"{prefix}.epa_block.{m[1]}", _identity
    m = re.fullmatch(r"conv51/(.+)", rest)
    if m:
        return _upp_resblock(f"{prefix}.conv51", m[1])
    m = re.fullmatch(r"conv8/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.conv8.1", m[1], _conv3d)
    return None


def _unetrpp_key(path: str) -> Mapped:
    enc = "unetr_pp_encoder"
    m = re.fullmatch(r"(stem|down([1-3]))_(conv|norm)/(kernel|bias|scale)",
                     path)
    if m:
        i = int(m[2] or 0)
        if m[3] == "conv":
            return (f"{enc}.downsample_layers.{i}.0.conv.weight", _conv3d) \
                if m[4] == "kernel" else None
        return _leaf(f"{enc}.downsample_layers.{i}.1", m[4], None)
    m = re.fullmatch(r"stage(\d)_block(\d+)/(.+)", path)
    if m:
        return _upp_tblock(f"{enc}.stages.{m[1]}.{m[2]}", m[3])
    m = re.fullmatch(r"encoder1/(.+)", path)
    if m:
        return _upp_resblock("encoder1", m[1])
    m = re.fullmatch(r"decoder([2-5])_up/kernel", path)
    if m:
        return f"decoder{m[1]}.transp_conv.conv.weight", _convT
    m = re.fullmatch(r"decoder([345])_block(\d+)/(.+)", path)
    if m:
        return _upp_tblock(f"decoder{m[1]}.decoder_block.0.{m[2]}", m[3])
    m = re.fullmatch(r"decoder2_conv/(.+)", path)
    if m:
        return _upp_resblock("decoder2.decoder_block.0", m[1])
    m = re.fullmatch(r"out([123])/(kernel|bias)", path)
    if m:
        return _leaf(f"out{m[1]}.conv.conv", m[2], _dense)
    return None


def unetrpp_state_dict_from_jax(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Flax ``UNETRPP`` params → reference-keyed state dict."""
    return _state_dict(params, _unetrpp_key, "UNETRpp")
