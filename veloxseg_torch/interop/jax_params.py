"""JAX VeloxSeg params → the port's (reference-keyed) state dict.

The exact inverse of ``veloxseg_tpu/interop/torch_import.py``
(``_map_key`` and the weight transforms at ``:40-72``), so weights carry
across in both directions unchanged, the teachers' ``rc_decoder_*``
subtrees included. It needs neither JAX nor the JAX package: ``params``
is the flax params tree as nested dicts of numpy arrays
(``jax.device_get(variables["params"])``). A tree of gradients has the
same paths and maps the same way.

Weight-layout transforms (JAX → reference):

- DHWIO conv kernel ``(kd, kh, kw, I/g, O)`` → ``(O, I/g, kd, kh, kw)``;
- Dense ``(I, O)`` → 1×1 conv ``(O, I, 1, 1, 1)``;
- UpConv Dense ``(I, O·8)`` → ConvTranspose3d ``(I, O, 2, 2, 2)``;
- patch-embed Dense ``(p³·C, E)`` → Conv3d ``(E, C, p, p, p)``, with ``p``
  read off the level-1 DownConv kernel (``2p − 1`` wide);
- LayerNorm ``scale`` → ``weight``.

Any path that cannot be placed raises, so nothing is dropped silently; so
does a single-kernel JLC block, which the port does not build.

:func:`optimizer_state_from_jax` maps the optax state of a JAX training
checkpoint onto the same keys, by the model's own map (this module's for
VeloxSeg, ``zoo_params``'s for the zoo): Adam's moments are params-shaped,
so they take the weights' layout transforms.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Tuple

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
    m = re.fullmatch(r"rc_decoder_(\d+)/(.+)", path)
    if m:
        return _rc_key(f"rc_decoders.{m[1]}", m[2])
    return None


def _rc_key(prefix: str, rest: str):
    """One teacher's paths (``torch_import.py:238-264``, inverted)."""
    wb = {"kernel": "weight", "bias": "bias"}
    m = re.fullmatch(r"enc2rc_(\d+)/(kernel|bias)", rest)
    if m:
        return (f"{prefix}.enc2rc_{m[1]}.0.{wb[m[2]]}",
                _dense if m[2] == "kernel" else _identity)
    m = re.fullmatch(r"up(\d+)/Dense_0/(kernel|bias)", rest)
    if m:
        return (f"{prefix}.layer_up{m[1]}.up.{wb[m[2]]}",
                _upconv if m[2] == "kernel" else _identity)
    m = re.fullmatch(r"layer(\d+)/JLC_(\d+)/(.+)", rest)
    if m:
        return _jlc_key(f"{prefix}.layer{m[1]}.{m[2]}", m[3])
    m = re.fullmatch(r"out_conv/(kernel|bias)", rest)
    if m:
        return (f"{prefix}.out_conv.0.{wb[m[1]]}",
                _conv3d if m[1] == "kernel" else _identity)
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
        mapped = _map_path(path, patch)
        if mapped is None:
            raise KeyError(f"unmapped JAX param path: {path}")
        key, tf = mapped
        out[key] = torch.from_numpy(np.array(tf(arr), np.float32))
    return out


def _sorted_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    """The leaves in ``jax.tree_util`` order: dict keys sorted at every
    level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _sorted_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _params_shaped(x: Any, params: Mapping[str, Any]) -> Mapping[str, Any]:
    """An optax moment as a params-shaped tree. ``optax.flatten`` (the JAX
    package's adamw, ``veloxseg_tpu/train/optim.py:38-44``) keeps it as one
    vector: the concatenation of every parameter, raveled, in
    ``jax.tree_util`` order; it is split back by the parameters' sizes."""
    if isinstance(x, Mapping):
        return x
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    out: Dict[str, Any] = {}
    offset = 0
    for path, leaf in _sorted_leaves(params):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = flat[offset:offset + leaf.size].reshape(leaf.shape)
        offset += leaf.size
    if offset != flat.size:
        raise ValueError(f"a flat optimizer moment of {flat.size} values "
                         f"does not match the params' {offset}")
    return out


def _find_state(tree: Any, keys: Tuple[str, ...]):
    """The first mapping of ``tree`` (depth first) holding every key."""
    if not isinstance(tree, Mapping):
        return None
    if all(k in tree for k in keys):
        return tree
    for v in tree.values():
        found = _find_state(v, keys)
        if found is not None:
            return found
    return None


def optimizer_state_from_jax(opt_state: Mapping[str, Any],
                             params: Mapping[str, Any],
                             state_map: Callable[[Mapping[str, Any]],
                                                 Dict[str, torch.Tensor]]
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optax state of a JAX checkpoint (``to_state_dict`` form, as
    :func:`..train.flax_msgpack.msgpack_restore` reads it) → per reference
    key, the ``torch.optim`` state of that parameter: for adam and adamw
    ``mu`` → ``exp_avg``, ``nu`` → ``exp_avg_sq``, ``count`` → ``step``;
    for sgd with momentum ``trace`` → ``momentum_buffer``; nothing for plain
    sgd. Each moment is a params-shaped tree, mapped to reference keys by
    ``state_map``: the model's own map of its JAX params
    (:func:`state_dict_from_jax` for VeloxSeg; ``train/checkpoint.py``'s
    ``_FORMATS`` holds every model's). The injected learning rate is
    dropped: the scheduler sets it per epoch."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    adam = _find_state(opt_state, ("count", "mu", "nu"))
    if adam is not None:
        step = torch.tensor(float(np.asarray(adam["count"])),
                            dtype=torch.float32)
        mu = state_map(_params_shaped(adam["mu"], params))
        nu = state_map(_params_shaped(adam["nu"], params))
        return {k: {"step": step.clone(), "exp_avg": mu[k],
                    "exp_avg_sq": nu[k]} for k in mu}
    trace = _find_state(opt_state, ("trace",))
    if trace is not None:
        buf = state_map(_params_shaped(trace["trace"], params))
        return {k: {"momentum_buffer": v} for k, v in buf.items()}
    return {}
