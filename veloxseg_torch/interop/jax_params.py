"""JAX VeloxSeg params → the port's (reference-keyed) state dict.

The exact inverse of ``veloxseg_tpu/interop/torch_import.py``
(``_map_key`` and the weight transforms at ``:40-72``), so weights carry
across in both directions unchanged. It needs neither JAX nor the JAX
package: ``params`` is the flax params tree as nested dicts of numpy
arrays (``jax.device_get(variables["params"])``).

Weight-layout transforms (JAX → reference):

- DHWIO conv kernel ``(kd, kh, kw, I/g, O)`` → ``(O, I/g, kd, kh, kw)``;
- Dense ``(I, O)`` → 1×1 conv ``(O, I, 1, 1, 1)``;
- UpConv Dense ``(I, O·8)`` → ConvTranspose3d ``(I, O, 2, 2, 2)``;
- patch-embed Dense ``(p³·C, E)`` → Conv3d ``(E, C, p, p, p)``, with ``p``
  read off the level-1 DownConv kernel (``2p − 1`` wide);
- LayerNorm ``scale`` → ``weight``.

The teachers' ``rc_decoder_*`` subtrees are skipped: the port's eval model
has no reconstruction decoders yet. Any other path that cannot be placed
raises, so nothing is dropped silently; so does a single-kernel JLC block,
which the port does not build.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _conv3d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (4, 3, 0, 1, 2))


def _dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)[:, :, None, None, None]


def _upconv(w: np.ndarray) -> np.ndarray:
    return w.reshape(w.shape[0], -1, 2, 2, 2)


def _identity(w: np.ndarray) -> np.ndarray:
    return w


def _jlc_key(prefix: str, rest: str):
    m = re.fullmatch(r"GroupedConv3d_(\d+)/(kernel|bias)", rest)
    if m:
        s, kind = m.groups()
        return (f"{prefix}.spatial_convs.{s}.0."
                + ("weight" if kind == "kernel" else "bias"),
                _conv3d if kind == "kernel" else _identity)
    m = re.fullmatch(r"Dense_([01])/(kernel|bias)", rest)
    if m:
        idx, kind = m.groups()
        sub = "channel_conv.1" if idx == "0" else "channel_conv.3"
        return (f"{prefix}.{sub}." + ("weight" if kind == "kernel"
                                      else "bias"),
                _dense if kind == "kernel" else _identity)
    return None


def _map_path(path: str, patch: int):
    """One flax param path ('a/b/c') → (reference key, transform)."""
    wb = {"kernel": "weight", "bias": "bias", "scale": "weight"}
    ea = "encoder/encoder_attn/"
    m = re.fullmatch(ea + r"patch_embed_(\d+)/Dense_0/(kernel|bias)", path)
    if m:
        mod, kind = m.groups()

        def patch_embed(w):
            e = w.shape[1]
            c = w.shape[0] // patch ** 3
            return np.transpose(w.reshape(patch, patch, patch, c, e),
                                (4, 3, 0, 1, 2))
        return (f"encoder.encoder_attn.patch_embeds.{mod}.proj.{wb[kind]}",
                patch_embed if kind == "kernel" else _identity)
    m = re.fullmatch(ea + r"patch_embed_(\d+)/LayerNorm_0/(scale|bias)", path)
    if m:
        mod, kind = m.groups()
        return (f"encoder.encoder_attn.patch_embeds.{mod}.norm.{wb[kind]}",
                _identity)
    m = re.fullmatch(ea + r"stage_(\d+)/block_(\d+)/(.+)", path)
    if m:
        i, j, rest = m.groups()
        blk = f"encoder.encoder_attn.layers.{i}.blocks.{j}."
        r = re.fullmatch(r"attn/norm_(\d+)/(scale|bias)", rest)
        if r:
            return blk + f"attn.input_norms.{r[1]}.{wb[r[2]]}", _identity
        r = re.fullmatch(r"attn/([qkv])_(\d+)/(kernel|bias)", rest)
        if r:
            which = "qkv".index(r[1])
            return (blk + f"attn.qkv_proj.{r[2]}.{which}.{wb[r[3]]}",
                    _dense if r[3] == "kernel" else _identity)
        r = re.fullmatch(r"attn/mix_(\d+)/(kernel|bias)", rest)
        if r:
            return (blk + f"attn.mix_channels.{r[1]}.{wb[r[2]]}",
                    _dense if r[2] == "kernel" else _identity)
        if rest == "attn/pos_bias/table":
            return (blk + "attn.position_embedding."
                    "relative_position_bias_table", _identity)
        r = re.fullmatch(r"ffn_(\d+)/Dense_([01])/(kernel|bias)", rest)
        if r:
            return (blk + f"ffns.{r[1]}.linear{int(r[2]) + 1}.{wb[r[3]]}",
                    _dense if r[3] == "kernel" else _identity)
        r = re.fullmatch(r"ffn_norm_(\d+)/(scale|bias)", rest)
        if r:
            return blk + f"norms.{r[1]}.{wb[r[2]]}", _identity
        return None
    m = re.fullmatch(ea + r"stage_(\d+)/down_(\d+)/Dense_0/kernel", path)
    if m:
        return (f"encoder.encoder_attn.layers.{m[1]}.downs.{m[2]}."
                "reduction.weight", _dense)
    m = re.fullmatch(ea + r"stage_(\d+)/down_(\d+)/LayerNorm_0/(scale|bias)",
                     path)
    if m:
        return (f"encoder.encoder_attn.layers.{m[1]}.downs.{m[2]}.norm."
                f"{wb[m[3]]}", _identity)
    m = re.fullmatch(r"encoder/conv_down(\d+)/GroupedConv3d_0/(kernel|bias)",
                     path)
    if m:
        return (f"encoder.encoder_conv.down{m[1]}.down.{wb[m[2]]}",
                _conv3d if m[2] == "kernel" else _identity)
    m = re.fullmatch(r"encoder/conv_layer(\d+)/JLC_(\d+)/(.+)", path)
    if m:
        return _jlc_key(f"encoder.encoder_conv.layer{m[1]}.{m[2]}", m[3])
    m = re.fullmatch(r"encoder/attn2conv_(\d+)/(kernel|bias)", path)
    if m:
        return (f"encoder.attn2conv_{m[1]}.0.{wb[m[2]]}",
                _dense if m[2] == "kernel" else _identity)
    m = re.fullmatch(r"decoder/up(\d+)/Dense_0/(kernel|bias)", path)
    if m:
        return (f"decoder.layer_up{m[1]}.up.{wb[m[2]]}",
                _upconv if m[2] == "kernel" else _identity)
    m = re.fullmatch(r"decoder/layer(\d+)/JLC_(\d+)/(.+)", path)
    if m:
        return _jlc_key(f"decoder.layer{m[1]}.{m[2]}", m[3])
    m = re.fullmatch(r"decoder/out_conv1/(kernel|bias)", path)
    if m:
        return (f"decoder.out_conv1.0.{wb[m[1]]}",
                _conv3d if m[1] == "kernel" else _identity)
    m = re.fullmatch(r"decoder/out_conv(\d+)/(kernel|bias)", path)
    if m:
        return (f"decoder.out_conv{m[1]}.{wb[m[2]]}",
                _dense if m[2] == "kernel" else _identity)
    return None


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params tree (nested dicts of arrays) → reference-keyed state
    dict of float32 CPU tensors, for :meth:`VeloxSeg.load_state_dict`."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    flat = [("/".join(p), a) for p, a in _flatten(params)]
    shapes = dict(flat)
    down1 = shapes.get("encoder/conv_down1/GroupedConv3d_0/kernel")
    if down1 is None:
        raise KeyError("params hold no encoder/conv_down1 kernel")
    patch = (down1.shape[0] + 1) // 2
    # the port's JLC has several branches (a lone conv has no IN/GELU)
    branches: Dict[str, int] = {}
    for path, _ in flat:
        m = re.fullmatch(r"(.+/JLC_\d+)/GroupedConv3d_\d+/kernel", path)
        if m:
            branches[m[1]] = branches.get(m[1], 0) + 1
    single = sorted(k for k, n in branches.items() if n < 2)
    if single:
        raise KeyError(f"single-kernel JLC blocks are not ported: {single}")

    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat:
        if path.startswith("rc_decoder_"):
            continue
        mapped = _map_path(path, patch)
        if mapped is None:
            raise KeyError(f"unmapped JAX param path: {path}")
        key, tf = mapped
        out[key] = torch.from_numpy(np.ascontiguousarray(tf(arr)))
    return out
