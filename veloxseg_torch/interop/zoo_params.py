"""JAX zoo params → the port's state dicts, one function per model.

As :mod:`.jax_params`, they need neither JAX nor the JAX package:
``params`` is the flax params tree as nested dicts of numpy arrays (or
``{"params": tree}``). Any path that cannot be placed raises.

- Reference-keyed models, each the exact inverse of its map in
  ``veloxseg_tpu/interop/zoo_import.py``: U-RWKV (``_map_urwkv_key``,
  1127-1236, without the dead parameters it drops, ``_URWKV_DEAD``, 1117,
  which the port's model lacks too), MedNeXt (``_map_mednext_key``, 82),
  SlimUNETR (``_make_slim_mapper``, 199, with the qkv split by heads of
  ``_slim_qkv_tf``, 139), SegFormer (``_map_segformer_key``, 253),
  UNETRpp (``_map_unetrpp_key``, 665), HDense (``_map_hdense_key``, 350),
  NestedFormer (``_map_nestedformer_key``, 462), A2FSeg
  (``_map_a2fseg_key``, 751), SuperLightNet
  (``_map_superlightnet_key``, 873, with its 2-D and 1-D conv layouts,
  811-824), VSmTrans (``_map_vsmtrans_key``, 976), U-KAN
  (``_map_ukan_key``, 1042) and HCMA-UNet (``_map_hcma_key``, 1367).
  HCMA's map is not one to one: it repeats each of the reference's O
  transposed-conv biases s³ times (``_hcma_convT_b``, 1260), so its
  inverse checks each group of s³ and raises where one is not a single
  value.
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
``weight``; flax 2-D and 1-D kernels → Conv2d ``(O, I/g, k, k)`` and
Conv1d ``(O, I/g, k)``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# U-KAN: the inverse of zoo_import._map_ukan_key

_UKAN_CONV = {"conv1": 0, "bn1": 1, "conv2": 3, "bn2": 4}


def _ukan_key(path: str) -> Mapped:
    m = re.fullmatch(r"((?:en|de)coder\d)/(conv1|bn1|conv2|bn2)/"
                     r"(kernel|bias|scale)", path)
    if m:
        return _leaf(f"{m[1]}.conv.{_UKAN_CONV[m[2]]}", m[3], _conv3d)
    m = re.fullmatch(r"(d?norm[34])/(scale|bias)", path)
    if m:
        return _leaf(m[1], m[2], None)
    m = re.fullmatch(r"(patch_embed[34])/(proj|norm)/(kernel|bias|scale)",
                     path)
    if m:
        return _leaf(f"{m[1]}.{m[2]}", m[3], _conv3d)
    m = re.fullmatch(r"(d?block[12])/norm/(scale|bias)", path)
    if m:
        return _leaf(f"{m[1]}.0.norm2", m[2], None)
    m = re.fullmatch(r"(d?block[12])/fc(\d)/(base_weight|spline_weight|"
                     r"spline_scaler)", path)
    if m:
        tf = (_linear if m[3] != "spline_weight"
              else lambda w: np.transpose(w, (2, 0, 1)))
        return f"{m[1]}.0.layer.fc{m[2]}.{m[3]}", tf
    m = re.fullmatch(r"(d?block[12])/dw(\d)/(dw|bn)/(kernel|bias|scale)",
                     path)
    if m:
        sub = "dwconv" if m[3] == "dw" else "bn"
        return _leaf(f"{m[1]}.0.layer.dwconv_{m[2]}.{sub}", m[4], _conv3d)
    m = re.fullmatch(r"final/(kernel|bias)", path)
    if m:
        return _leaf("final", m[1], _dense)
    return None


def ukan_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``UKAN`` params → reference-keyed state dict."""
    return _state_dict(params, _ukan_key, "U-KAN")


# ---------------------------------------------------------------------------
# A2FSeg: the inverse of zoo_import._map_a2fseg_key

def _a2f_block(key: str, rest: str) -> Mapped:
    """One conv block's ``conv`` or ``norm`` leaf → ``key.conv`` or
    ``key.instnorm``."""
    m = re.fullmatch(r"(conv|norm)/(kernel|bias|scale)", rest)
    if not m:
        return None
    return _leaf(key + (".conv" if m[1] == "conv" else ".instnorm"), m[2],
                 _conv3d)


def _a2fseg_key(path: str) -> Mapped:
    m = re.fullmatch(r"(enc|dec)(\d+)/(\w+?)(\d)(?:_([ab]))?/(.+)", path)
    if m:
        unet = f"modality_specific_models.{m[2]}"
        kind, i, ab, rest = m[3], m[4], m[5], m[6]
        j = "0" if ab == "a" else "1"
        if m[1] == "enc" and kind == "ctx" and ab:
            return _a2f_block(f"{unet}.conv_blocks_context.{i}.blocks.{j}",
                              rest)
        if m[1] == "dec" and kind == "loc" and ab:
            return _a2f_block(f"{unet}.conv_blocks_localization.{i}.{j}."
                              f"blocks.0", rest)
        if m[1] == "dec" and kind in ("tu", "seg") and not ab \
                and rest == "kernel":
            return (f"{unet}.tu.{i}.weight", _convT) if kind == "tu" \
                else (f"{unet}.seg_outputs.{i}.weight", _dense)
        return None
    m = re.fullmatch(r"enc(\d+)/bottleneck_([ab])/(.+)", path)
    if m:
        j = "0" if m[2] == "a" else "1"
        return _a2f_block(f"modality_specific_models.{m[1]}."
                          f"conv_blocks_context.5.{j}.blocks.0", m[3])
    m = re.fullmatch(r"fusion_(tu|seg)(\d)/kernel", path)
    if m:
        return (f"fusion_decoder.tu.{m[2]}.weight", _convT) \
            if m[1] == "tu" else \
            (f"fusion_decoder.seg_outputs.{m[2]}.weight", _dense)
    m = re.fullmatch(r"fusion_loc(\d)_([ab])/(.+)", path)
    if m:
        j = "0" if m[2] == "a" else "1"
        return _a2f_block(f"fusion_decoder.conv_blocks_localization.{m[1]}."
                          f"{j}.blocks.0", m[3])
    m = re.fullmatch(r"aware(\d+)_a/(conv|norm)/(kernel|bias|scale)", path)
    if m:
        slot = "0" if m[2] == "conv" else "1"
        return _leaf(f"modality_aware_modules.{m[1]}.{slot}", m[3], _conv3d)
    m = re.fullmatch(r"aware(\d+)_b/(kernel|bias)", path)
    if m:
        return _leaf(f"modality_aware_modules.{m[1]}.3", m[2], _conv3d)
    m = re.fullmatch(r"lastconv/(conv|norm)/(kernel|bias|scale)", path)
    if m:
        slot = "0" if m[1] == "conv" else "1"
        return _leaf(f"lastconv.0.{slot}", m[2], _conv3d)
    if path == "output/kernel":
        return "output.weight", _dense
    return None


def a2fseg_state_dict_from_jax(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Flax ``A2FSeg`` params → reference-keyed state dict."""
    return _state_dict(params, _a2fseg_key, "A2FSeg")


# ---------------------------------------------------------------------------
# HDense: the inverse of zoo_import._map_hdense_key

_HDENSE_UNET = {"b11l": "block_1_1_left", "b12l": "block_1_2_left",
                "b21l": "block_2_1_left", "b22l": "block_2_2_left",
                "b31l": "block_3_1_left", "b32l": "block_3_2_left",
                "b41l": "block_4_1_left", "b42l": "block_4_2_left",
                "b31r": "block_3_1_right", "b32r": "block_3_2_right",
                "b21r": "block_2_1_right", "b22r": "block_2_2_right",
                "b11r": "block_1_1_right", "b12r": "block_1_2_right"}
_HDENSE_HEADS = {"head": "conv1x1", "head_d1": "conv1x1_d1",
                 "head_d2": "conv1x1_d2", "head_d3": "conv1x1_d3"}


def _hdense_block(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"reduce_(\d+)/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.layers.{m[1]}.0", m[2], _linear)
    m = re.fullmatch(r"(attn|ff)_norm_(\d+)/(scale|bias)", rest)
    if m:
        slot = "1" if m[1] == "attn" else "2"
        return _leaf(f"{prefix}.layers.{m[2]}.{slot}.norm", m[3], None)
    m = re.fullmatch(r"attn_(\d+)/to_qkv/kernel", rest)
    if m:
        return f"{prefix}.layers.{m[1]}.1.fn.to_qkv.weight", _linear
    m = re.fullmatch(r"attn_(\d+)/to_out/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.layers.{m[1]}.1.fn.to_out.0", m[2], _linear)
    m = re.fullmatch(r"ff_(\d+)/fc([12])/(kernel|bias)", rest)
    if m:
        net = "0" if m[2] == "1" else "3"
        return _leaf(f"{prefix}.layers.{m[1]}.2.fn.net.{net}", m[3],
                     _linear)
    m = re.fullmatch(r"out_layer/fc([12])/(kernel|bias)", rest)
    if m:
        net = "0" if m[1] == "1" else "3"
        return _leaf(f"{prefix}.out_layer.net.{net}", m[2], _linear)
    return None


def _hdense_key(path: str) -> Mapped:
    m = re.fullmatch(r"attns_(\d+)/(.+)", path)
    if m:
        base, rest = f"attns.{m[1]}", m[2]
        r = re.fullmatch(r"patch_embed/(kernel|bias)", rest)
        if r:
            return _leaf(f"{base}.patch_embeddings", r[1], _conv3d)
        if rest == "pos_embed":
            return f"{base}.position_embeddings", _identity
        r = re.fullmatch(r"block_(\d+)/(.+)", rest)
        if r:
            return _hdense_block(f"{base}.blocks.{r[1]}.0", r[2])
        return None
    m = re.fullmatch(r"(deep_conv|up[123])/conv/(kernel|bias)", path)
    if m:
        return _leaf(f"{m[1]}.double_conv.0", m[2], _conv3d)
    m = re.fullmatch(r"(b\d\d[lr])/(conv|norm)/(kernel|scale|bias)", path)
    if m and m[1] in _HDENSE_UNET:
        return _leaf(f"{_HDENSE_UNET[m[1]]}.{m[2]}", m[3], _conv3d)
    m = re.fullmatch(r"upconv(\d)/(kernel|bias)", path)
    if m:
        return _leaf(f"upconv_{m[1]}", m[2], _convT)
    m = re.fullmatch(r"(head(?:_d\d)?)/(kernel|bias)", path)
    if m and m[1] in _HDENSE_HEADS:
        return _leaf(_HDENSE_HEADS[m[1]], m[2], _dense)
    return None


def hdense_state_dict_from_jax(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Flax ``HDenseFormer`` params → reference-keyed state dict."""
    return _state_dict(params, _hdense_key, "HDense")


# ---------------------------------------------------------------------------
# SuperLightNet: the inverse of zoo_import._map_superlightnet_key

def _conv2d(w: np.ndarray) -> np.ndarray:
    """flax 2-D kernel ``(kh, kw, I/g, O)`` → Conv2d ``(O, I/g, kh, kw)``."""
    return np.transpose(w, (3, 2, 0, 1))


def _conv1d(w: np.ndarray) -> np.ndarray:
    """flax 1-D kernel ``(k, I/g, O)`` → Conv1d ``(O, I/g, k)``."""
    return np.transpose(w, (2, 1, 0))


def _dense_2d(w: np.ndarray) -> np.ndarray:
    """Dense ``(I, O)`` → 1×1 Conv2d ``(O, I, 1, 1)``."""
    return np.transpose(w)[:, :, None, None]


def _dense_1d(w: np.ndarray) -> np.ndarray:
    """Dense ``(I, O)`` → 1×1 Conv1d ``(O, I, 1)``."""
    return np.transpose(w)[:, :, None]


_SLN_GHPA = {"conv_xy_dw": ("conv_xy.0", _conv2d),
             "conv_xy_pw": ("conv_xy.2", _dense_2d),
             "conv_zx_dw": ("conv_zx.0", _conv1d),
             "conv_zx_pw": ("conv_zx.2", _dense_1d),
             "conv_zy_dw": ("conv_zy.0", _conv1d),
             "conv_zy_pw": ("conv_zy.2", _dense_1d),
             "dw_pw": ("dw.0", _dense_2d), "dw_dw": ("dw.2", _conv2d),
             "ldw_dw": ("ldw.0", _conv2d), "ldw_pw": ("ldw.2", _dense_2d)}


def _sln_thpa(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"mlp_fc([12])/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.mlp.fc{m[1]}", m[2], _dense)
    g = f"{prefix}.GHPA_dim"
    if rest == "ghpa/params_xy":            # (1, x, y, c) → (1, c, x, y)
        return f"{g}.params_xy", lambda w: np.transpose(w, (0, 3, 1, 2))
    m = re.fullmatch(r"ghpa/(params_z[xy])", rest)
    if m:                                   # (1, n, c) → (1, 1, c, n)
        return f"{g}.{m[1]}", lambda w: np.transpose(w, (0, 2, 1))[None]
    m = re.fullmatch(r"ghpa/(norm[12])/(scale|bias)", rest)
    if m:
        return _leaf(f"{g}.{m[1]}", m[2], None)
    m = re.fullmatch(r"ghpa/(\w+)/(kernel|bias)", rest)
    if m and m[1] in _SLN_GHPA:
        name, tf = _SLN_GHPA[m[1]]
        return _leaf(f"{g}.{name}", m[2], tf)
    return None


def _superlightnet_key(path: str) -> Mapped:
    enc, dec = "ParallelU_Net_enc_m", "ParallelU_Net_dec_m"
    m = re.fullmatch(r"stem/(kernel|bias)", path)
    if m:
        return _leaf(f"{enc}.stem", m[1], _dense)
    m = re.fullmatch(r"repr(\d)_(\d+)/(.+)", path)
    if m:
        return _sln_thpa(f"{enc}.repr_block_{m[1]}.{m[2]}", m[3])
    m = re.fullmatch(r"emb_(\d+)/(.+)", path)
    if m:
        return _sln_thpa(f"{enc}.emb_block.{m[1]}", m[2])
    m = re.fullmatch(r"down(\d)/(kernel|bias)", path)
    if m:
        return _leaf(f"{enc}.dwn_block_{m[1]}.proj", m[2], _conv3d)
    m = re.fullmatch(r"up(\d)/(.+)", path)
    if m:
        up, rest = f"{dec}.repr_block_up_{m[1]}", m[2]
        table = {"upc/kernel": ("upc.conv.weight", _dense),
                 "mldw_conv/kernel": ("repr_mldw.0.conv.weight", _conv3d),
                 "mldw_pw/kernel": ("repr_mldw.2.conv.weight", _dense),
                 "skip_scale": ("group_skip_scale",
                                lambda w: w.reshape(1, -1, 1, 1, 1)),
                 "res_scale": ("group_res_scale", _identity)}
        if rest not in table:
            return None
        key, tf = table[rest]
        return f"{up}.{key}", tf
    m = re.fullmatch(r"head_norm/(scale|bias)", path)
    if m:
        return _leaf("norm", m[1], None)
    m = re.fullmatch(r"head_fc([12])/(kernel|bias)", path)
    if m:
        return _leaf(f"proj.fc{m[1]}", m[2], _dense)
    return None


def superlightnet_state_dict_from_jax(params: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """Flax ``SuperLightNet`` params → reference-keyed state dict."""
    return _state_dict(params, _superlightnet_key, "SuperLightNet")


# ---------------------------------------------------------------------------
# NestedFormer: the inverse of zoo_import._map_nestedformer_key

def _nf_twoconv(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"conv([01])/(kernel|bias)", rest)
    if not m:
        return None
    return _leaf(f"{prefix}.conv_{int(m[1]) + 1}.conv_1.0", m[2], _conv3d)


_NF_QKVO = {"q": "query", "k": "key", "v": "value", "out": "out"}


def _nf_mha(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"(q|k|v|out)/(kernel|bias)", rest)
    if not m:
        return None
    return _leaf(f"{prefix}.{_NF_QKVO[m[1]]}", m[2], _linear)


def _nf_spatial_block(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"(attn|ffn)_norm/(scale|bias)", rest)
    if m:
        which = "attention_norm" if m[1] == "attn" else "ffn_norm"
        return _leaf(f"{prefix}.{which}", m[2], None)
    m = re.fullmatch(r"fc([12])/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.ffn.fc{m[1]}", m[2], _linear)
    m = re.fullmatch(r"([vh])_attn/(.+)", rest)
    if m:
        return _nf_mha(f"{prefix}.attn.{m[1]}_attention", m[2])
    m = re.fullmatch(r"win_attn/to_(qkv|out)/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.attn.window_attention.to_{m[1]}", m[2],
                     _linear)
    if rest == "win_attn/pos_embedding":
        return f"{prefix}.attn.window_attention.pos_embedding", _identity
    m = re.fullmatch(r"pos([12])", rest)
    if m:
        return (f"{prefix}.attn.pos_embedding_{m[1]}.position_embeddings",
                _identity)
    return None


def _nestedformer_key(path: str) -> Mapped:
    m = re.fullmatch(r"enc(\d+)_conv0/(.+)", path)
    if m:
        return _nf_twoconv(f"encoder.encoders.{m[1]}.conv_0", m[2])
    m = re.fullmatch(r"enc(\d+)_down(\d)/(.+)", path)
    if m:
        base, rest = f"encoder.encoders.{m[1]}.down_{m[2]}", m[3]
        r = re.fullmatch(r"embed/(kernel|bias)", rest)
        if r:
            return _leaf(f"{base}.embeddings.patch_embeddings", r[1],
                         _conv3d)
        r = re.fullmatch(r"embed_norm/(weight|bias)", rest)
        if r:
            return f"{base}.embeddings.norm.{r[1]}", _identity
        r = re.fullmatch(r"block(\d+)/(.+)", rest)
        if not r:
            return None
        blk, inner = f"{base}.block_list.{r[1]}", r[2]
        q = re.fullmatch(r"(attn|ffn)_norm/(weight|bias)", inner)
        if q:
            which = "attention_norm" if q[1] == "attn" else "ffn_norm"
            return f"{blk}.{which}.{q[2]}", _identity
        q = re.fullmatch(r"fc([12])/(kernel|bias)", inner)
        if q:
            return _leaf(f"{blk}.ffn.fc{q[1]}", q[2], _dense)
        if inner == "global_w":
            return f"{blk}.attn.global_layer.weight", lambda w: w[:, None]
        if inner == "global_b":
            return f"{blk}.attn.global_layer.bias", _identity
        return None
    m = re.fullmatch(r"spatial_embed/(kernel|bias)", path)
    if m:
        return _leaf("fusion.spatial_att.embeddings.patch_embeddings", m[1],
                     _dense)
    m = re.fullmatch(r"spatial_block(\d+)/(.+)", path)
    if m:
        return _nf_spatial_block(f"fusion.spatial_att.block_list.{m[1]}",
                                 m[2])
    mod = "fusion.modality_att"
    m = re.fullmatch(r"cm_embed(\d+)/(kernel|bias)", path)
    if m:
        return _leaf(f"{mod}.embeddings.{m[1]}.patch_embeddings", m[2],
                     _dense)
    m = re.fullmatch(r"cm_pos(\d+)", path)
    if m:
        return f"{mod}.embeddings.{m[1]}.position_embeddings", _identity
    m = re.fullmatch(r"token_learner/token_conv/(kernel|bias)", path)
    if m:
        return _leaf(f"{mod}.token_mixer.token_conv", m[1], _conv3d)
    cross = f"{mod}.cross_attention"
    m = re.fullmatch(r"(cross_norm|cm_ffn_norm)/(scale|bias)", path)
    if m:
        which = "attention_norm_cross" if m[1] == "cross_norm" \
            else "ffn_norm"
        return _leaf(f"{cross}.{which}", m[2], None)
    m = re.fullmatch(r"cm_fc([12])/(kernel|bias)", path)
    if m:
        return _leaf(f"{cross}.ffn.fc{m[1]}", m[2], _linear)
    m = re.fullmatch(r"cross_attn/(.+)", path)
    if m:
        return _nf_mha(f"{cross}.attn_cross", m[1])
    m = re.fullmatch(r"(fusion_conv_\d)/(.+)", path)
    if m:
        return _nf_twoconv(m[1], m[2])
    m = re.fullmatch(r"upcat_(\d)_up/(kernel|bias)", path)
    if m:
        return _leaf(f"upcat_{m[1]}.upsample", m[2], _convT)
    m = re.fullmatch(r"upcat_(\d)_convs/(.+)", path)
    if m:
        return _nf_twoconv(f"upcat_{m[1]}.convs", m[2])
    m = re.fullmatch(r"final_conv/(kernel|bias)", path)
    if m:
        return _leaf("final_conv", m[1], _dense)
    return None


def nestedformer_state_dict_from_jax(params: Mapping[str, Any]
                                     ) -> Dict[str, torch.Tensor]:
    """Flax ``NestedFormer`` params → reference-keyed state dict."""
    return _state_dict(params, _nestedformer_key, "NestedFormer")


# ---------------------------------------------------------------------------
# VSmTrans: the inverse of zoo_import._map_vsmtrans_key

def _vsm_block(prefix: str, rest: str) -> Mapped:
    m = re.fullmatch(r"(norm[12])/(scale|bias)", rest)
    if m:
        return _leaf(f"{prefix}.{m[1]}", m[2], None)
    m = re.fullmatch(r"fc([12])/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.mlp.fc{m[1]}", m[2], _linear)
    m = re.fullmatch(r"attn/(qkv|conv1|proj)/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.attn.{m[1]}", m[2], _linear)
    m = re.fullmatch(r"attn/conv_norm([12])/(scale|bias)", rest)
    if m:
        return _leaf(f"{prefix}.attn.norm{m[1]}", m[2], None)
    m = re.fullmatch(r"attn/dep_conv/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.attn.dep_conv", m[1], _conv3d)
    m = re.fullmatch(r"attn/attn(\d)/rpb/table", rest)
    if m:
        return (f"{prefix}.attn.attns.{m[1]}.relative_position_bias_table",
                _identity)
    m = re.fullmatch(r"attn/(rate[12])", rest)
    if m:
        return f"{prefix}.attn.{m[1]}", _identity
    return None


def _vsmtrans_key(path: str) -> Mapped:
    m = re.fullmatch(r"patch_(embed|norm)/(kernel|bias|scale)", path)
    if m:
        sub = "proj" if m[1] == "embed" else "norm"
        return _leaf(f"VSmViT.patch_embed.{sub}", m[2], _conv3d)
    m = re.fullmatch(r"stage(\d)_block(\d+)/(.+)", path)
    if m:
        return _vsm_block(f"VSmViT.layers{int(m[1]) + 1}.0.blocks.{m[2]}",
                          m[3])
    m = re.fullmatch(r"merge(\d)/(norm|reduction)/(kernel|bias|scale)", path)
    if m:
        return _leaf(f"VSmViT.layers{int(m[1]) + 1}.1.{m[2]}", m[3],
                     _linear)
    m = re.fullmatch(r"encoder(\d)/conv([123])/kernel", path)
    if m:
        return f"encoder{m[1]}.layer.conv{m[2]}.conv.weight", _conv3d
    m = re.fullmatch(r"decoder(\d)_deconv/kernel", path)
    if m:
        return f"decoder{m[1]}.transp_conv.conv.weight", _convT
    m = re.fullmatch(r"decoder(\d)_conv/conv([123])/kernel", path)
    if m:
        return f"decoder{m[1]}.conv_block.conv{m[2]}.conv.weight", _conv3d
    m = re.fullmatch(r"out/(kernel|bias)", path)
    if m:
        return _leaf("out.conv.conv", m[1], _dense)
    m = re.fullmatch(r"(out_[0-3])/(kernel|bias)", path)
    if m:
        return _leaf(m[1], m[2], _dense)
    return None


def vsmtrans_state_dict_from_jax(params: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """Flax ``VSmixTUnet`` params → reference-keyed state dict."""
    return _state_dict(params, _vsmtrans_key, "VSmTrans")


# ---------------------------------------------------------------------------
# HCMA-UNet: the inverse of zoo_import._map_hcma_key

_HCMA_DEC_STRIDES = (1, 2, 2, 2)   # decoder u runs strides[depth - 1 - u]


def _hcma_convT(stride: int) -> Callable:
    """Dense ``(I, O·s³)`` → ConvTranspose3d ``(I, O, s, s, s)``."""
    return lambda w: w.reshape(w.shape[0], -1, stride, stride, stride)


def _hcma_convT_bias(stride: int) -> Callable:
    """The Dense's bias ``(O·s³,)``, each value repeated s³ times
    (``_hcma_convT_b``), → the reference's ``(O,)``; raises where a group
    of s³ is not one value, which no reference bias maps to."""
    def tf(b: np.ndarray) -> np.ndarray:
        groups = b.reshape(-1, stride ** 3)
        if not (groups == groups[:, :1]).all():
            raise ValueError(
                f"the transposed conv's bias of {b.size} values is not "
                f"{groups.shape[0]} values each repeated {stride ** 3} "
                f"times: no reference bias maps to it")
        return np.ascontiguousarray(groups[:, 0])
    return tf


def _hcma_pos_embed(axis: str) -> Callable:
    """``(L, C)`` → ``(1, C, L, 1, 1)``, L on the branch's axis (x: D, y:
    H, z: W)."""
    def tf(w: np.ndarray) -> np.ndarray:
        shape = [1, w.shape[1], 1, 1, 1]
        shape[2 + "xyz".index(axis)] = w.shape[0]
        return np.transpose(w).reshape(shape)
    return tf


def _hcma_conv_list(prefix: str, rest: str, names: Dict[str, Tuple[
        str, str, Callable]]) -> Mapped:
    """A DenseConv or ResNeXt leaf: ``names`` maps each flax name to
    (conv_list index, slot, kernel transform)."""
    m = re.fullmatch(r"(\w+)/(kernel|bias|scale)", rest)
    if not m or m[1] not in names:
        return None
    i, j, tf = names[m[1]]
    return _leaf(f"{prefix}.conv_list.{i}.{j}", m[2], tf)


_HCMA_DENSE_CONV = {"dw": ("0", "0", _conv3d), "norm": ("0", "1", None),
                    "expand": ("1", "0", _dense), "out": ("2", "0", _dense)}
_HCMA_RESNEXT = {"pw1": ("0", "0", _dense), "n1": ("0", "1", None),
                 "dw": ("1", "0", _conv3d), "n2": ("1", "1", None),
                 "pw2": ("2", "0", _dense), "n3": ("2", "1", None)}


def _hcma_dir_mamba(prefix: str, axis: str, rest: str) -> Mapped:
    m = re.fullmatch(r"vssb/(down|up)/(kernel|bias)", rest)
    if m:
        return _leaf(f"{prefix}.mamba.{m[1]}", m[2], _linear)
    m = re.fullmatch(r"vssb/ln_1/(scale|bias)", rest)
    if m:
        return _leaf(f"{prefix}.mamba.ln_1", m[1], None)
    ss = f"{prefix}.mamba.self_attention"
    m = re.fullmatch(r"vssb/ss2d/(x_proj_weight|dt_projs_weight|"
                     r"dt_projs_bias|A_logs|Ds)", rest)
    if m:
        return f"{ss}.{m[1]}", _identity
    m = re.fullmatch(r"vssb/ss2d/(in_proj|out_proj)/kernel", rest)
    if m:
        return f"{ss}.{m[1]}.weight", _linear
    if rest == "vssb/ss2d/conv2d_kernel":   # (k, k, 1, C) → (C, 1, k, k)
        return f"{ss}.conv2d.weight", _conv2d
    if rest == "vssb/ss2d/conv2d_bias":
        return f"{ss}.conv2d.bias", _identity
    m = re.fullmatch(r"vssb/ss2d/out_norm/(scale|bias)", rest)
    if m:
        return _leaf(f"{ss}.out_norm", m[1], None)
    m = re.fullmatch(r"slice_attn/([qkv])/(kernel|bias)", rest)
    if m:
        name = {"q": "query", "k": "key", "v": "value"}[m[1]]
        return _leaf(f"{prefix}.slice_attention.{name}_conv", m[2], _dense)
    if rest == "slice_attn/pos_embed":
        return f"{prefix}.slice_attention.pos_embed", _hcma_pos_embed(axis)
    if rest == "slice_attn/gamma":
        return f"{prefix}.slice_attention.gamma", lambda w: w.reshape(1)
    return None


def _hcma_key(path: str) -> Mapped:
    m = re.fullmatch(r"stem/(.+)", path)
    if m:
        return _hcma_conv_list("encoders.0", m[1], _HCMA_DENSE_CONV)
    m = re.fullmatch(r"down_(\d)/(.+)", path)
    if m:
        enc, rest = f"encoders.{int(m[1]) + 1}", m[2]
        r = re.fullmatch(r"down_resnext/(.+)", rest)
        if r:
            return _hcma_conv_list(f"{enc}.downsample_resnext", r[1],
                                   _HCMA_RESNEXT)
        r = re.fullmatch(r"extract_(\d+)/(.+)", rest)
        if r:
            return _hcma_conv_list(f"{enc}.extractor.{r[1]}", r[2],
                                   _HCMA_DENSE_CONV)
        r = re.fullmatch(r"tmamba/fusion/(kernel|bias)", rest)
        if r:
            return _leaf(f"{enc}.tmamba.fusion.0", r[1], _dense)
        r = re.fullmatch(r"tmamba/mamba_([xyz])/(.+)", rest)
        if r:
            return _hcma_dir_mamba(f"{enc}.tmamba.mamba_{r[1]}", r[1], r[2])
        return None
    m = re.fullmatch(r"up_(\d)/(adapt|n|up)/(kernel|bias|scale)", path)
    if m:
        dec = f"decoders.{m[1]}"
        if m[2] == "up":
            s = _HCMA_DEC_STRIDES[int(m[1])]
            return f"{dec}.up_transpose.{_WB[m[3]]}", \
                _hcma_convT(s) if m[3] == "kernel" else _hcma_convT_bias(s)
        slot = "0" if m[2] == "adapt" else "1"
        return _leaf(f"{dec}.extractor.0.{slot}", m[3], _dense)
    m = re.fullmatch(r"out_3/(kernel|bias)", path)
    if m:
        return _leaf("out.3.conv1", m[1], _dense)
    return None


def hcma_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``HCMA`` params → reference-keyed state dict; raises where the
    up-projection's bias does not repeat the reference's."""
    return _state_dict(params, _hcma_key, "HCMA-UNet")
