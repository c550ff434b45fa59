"""Checkpoints: save and resume training, load inference weights
(``veloxseg_tpu/train/checkpoint.py``).

A training checkpoint is one file holding the reference's own ``.pth``
dict (``utils/load_model.py:90-109``): ``{model, optimizer,
scheduler_state, epoch, best_train_dice, best_val_dice}``, the model under
the reference's key names, everything on the CPU. :func:`save_checkpoint`
writes it atomically (a temporary file, then ``os.replace``); the trainer
names the files ``<epoch>.pth``, ``train_best.pth`` and ``val_best.pth``.
Both serving CLIs read them: the JAX package's ``load_params`` through
``import_torch_checkpoint`` (``veloxseg_tpu/interop/torch_import.py:308-
327``), this package's through :func:`load_params`.

:func:`load_checkpoint` resumes a run into a model and its optimizer from
such a ``.pth`` or from a ``.ckpt`` the JAX trainer wrote (flax msgpack,
read without flax by :mod:`.flax_msgpack`; its optax state mapped by
:func:`..interop.jax_params.optimizer_state_from_jax`).

:func:`load_params` loads inference weights, in the forms of
``veloxseg_tpu/train/checkpoint.py:98-123``:

- ``.pth``: a reference-keyed PyTorch state dict, bare or wrapped in a
  training checkpoint (``utils/inference_petct.py:95-101``), unwrapped as
  ``veloxseg_tpu/interop/torch_import.py:308-322`` does, with the DDP
  ``module.`` prefix stripped (``:283-284``). The keys the JAX import drops
  are dropped here too: VeloxSeg's ``relative_position_index`` buffers
  (``torch_import.py:158-160``), U-RWKV's dead parameters and batch
  norm statistics (``interop/zoo_import.py:1117-1131``), and for each zoo
  model exactly the keys its ``_map_*_key`` returns None for (batch-norm
  statistics, VSmTrans's position indices and unused ``out_4``, U-KAN's
  KAN grids, NestedFormer's unused cross-attention norm, A2FSeg's unused
  fusion-decoder modules, HCMA-UNet's heads ``out.0``-``out.2``).
- ``.ckpt``: the JAX trainer's msgpack file, a full payload or a bare
  params tree, mapped by :mod:`..interop.jax_params` (VeloxSeg) or
  :mod:`..interop.zoo_params` (U-RWKV and the zoo).
- an Orbax checkpoint directory raises: reading one needs ``orbax`` and
  ``tensorstore``, which the port does not use.

Every form ends in ``load_state_dict(strict=True)``: a missing, unknown or
misshapen key raises.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import torch

from ..interop import zoo_params
from ..interop.jax_params import optimizer_state_from_jax, state_dict_from_jax
from ..models.zoo import (a2fseg, basic_unet, hcma, hdense, mednext,
                          nestedformer, segformer3d, slim_unetr,
                          superlightnet, swin_unetr, ukan, unetr, unetrpp,
                          urwkv, vnet, vsmtrans)
from ..nn.veloxseg import VeloxSeg
from .flax_msgpack import msgpack_restore

_BN_STATS = r".*\.running_|.*num_batches_tracked$"


def _slim_state_dict(model, params):
    heads = tuple(b[0].heads for b in (model.Encoder.block1,
                                       model.Encoder.block2,
                                       model.Encoder.block3,
                                       model.Encoder.block4))
    return zoo_params.slim_unetr_state_dict_from_jax(params, heads)


def _plain(fn):
    return lambda model, params: fn(params)


# model class → (JAX params → state dict (model, params), the .pth keys
# that the JAX import drops and the model does not hold, or None)
_FORMATS = {
    VeloxSeg: (_plain(state_dict_from_jax),
               r".*\.position_embedding\.relative_position_index"),
    urwkv.URWKV: (_plain(zoo_params.urwkv_state_dict_from_jax),
                  r"(e[1-4]\.pwconv\.|outconv\.|"
                  r"bx4rwkv\.allinone_spa\.(gamma2$|ln2\.))|" + _BN_STATS),
    basic_unet.BasicUNet: (_plain(zoo_params.unet_state_dict_from_jax),
                           None),
    vnet.VNet: (_plain(zoo_params.vnet_state_dict_from_jax), _BN_STATS),
    mednext.MedNeXt: (_plain(zoo_params.mednext_state_dict_from_jax),
                      r"out_[1-4]\.|dummy"),
    unetr.UNETR: (_plain(zoo_params.unetr_state_dict_from_jax), None),
    swin_unetr.SwinUNETR: (_plain(
        zoo_params.swin_unetr_state_dict_from_jax), None),
    segformer3d.SegFormer3D: (_plain(
        zoo_params.segformer_state_dict_from_jax), _BN_STATS),
    slim_unetr.SlimUNETR: (_slim_state_dict, _BN_STATS),
    unetrpp.UNETRPP: (_plain(zoo_params.unetrpp_state_dict_from_jax),
                      _BN_STATS),
    vsmtrans.VSmixTUnet: (_plain(zoo_params.vsmtrans_state_dict_from_jax),
                          r".*\.relative_position_index$|out_4\.|"
                          + _BN_STATS),
    nestedformer.NestedFormer: (_plain(
        zoo_params.nestedformer_state_dict_from_jax),
        r"fusion\.modality_att\.cross_attention\.attention_norm\."),
    a2fseg.A2FSeg: (_plain(zoo_params.a2fseg_state_dict_from_jax),
                    r"fusion_decoder\.(conv_blocks_context|td)\.|"
                    + _BN_STATS),
    hdense.HDenseFormer: (_plain(zoo_params.hdense_state_dict_from_jax),
                          None),
    superlightnet.SuperLightNet: (_plain(
        zoo_params.superlightnet_state_dict_from_jax), None),
    ukan.UKAN: (_plain(zoo_params.ukan_state_dict_from_jax),
                r".*\.grid$|" + _BN_STATS),
    hcma.HCMA: (_plain(zoo_params.hcma_state_dict_from_jax),
                r"out\.[0-2]\.conv1\."),
}


def _to_cpu(obj: Any) -> Any:
    """A deep copy of a (nested) state dict with every tensor on the CPU:
    the snapshot stays as it is while training goes on updating the
    originals in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def build_payload(model: torch.nn.Module,
                  optimizer: Optional[torch.optim.Optimizer] = None, *,
                  epoch: int = 0, best_train_dice: float = 0.0,
                  best_val_dice: float = 0.0,
                  scheduler_state: Optional[dict] = None) -> Dict[str, Any]:
    """The full training state as the reference's ``.pth`` dict, a
    snapshot on the CPU."""
    return {
        "model": _to_cpu(model.state_dict()),
        "optimizer": (_to_cpu(optimizer.state_dict())
                      if optimizer is not None else None),
        "scheduler_state": dict(scheduler_state or {}),
        "epoch": int(epoch),
        "best_train_dice": float(best_train_dice),
        "best_val_dice": float(best_val_dice),
    }


def write_payload(path: str, payload: Dict[str, Any]) -> None:
    """``torch.save`` into a temporary file beside ``path``, then rename:
    a reader never sees a partial file."""
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, *,
                    epoch: int = 0, best_train_dice: float = 0.0,
                    best_val_dice: float = 0.0,
                    scheduler_state: Optional[dict] = None) -> None:
    write_payload(path, build_payload(
        model, optimizer, epoch=epoch, best_train_dice=best_train_dice,
        best_val_dice=best_val_dice, scheduler_state=scheduler_state))


def _reference_state_dict(payload: Any) -> Dict[str, torch.Tensor]:
    """The model state dict of a ``.pth`` payload, bare or wrapped
    (``"model"`` key, or a pickled module), with ``module.`` stripped."""
    if isinstance(payload, dict) and "model" in payload \
            and not any(k.endswith(".weight") for k in payload):
        payload = payload["model"]
    if hasattr(payload, "state_dict") and not isinstance(payload, dict):
        payload = payload.state_dict()
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in payload.items()}


def _model_state(path: str, payload: Any, model: torch.nn.Module
                 ) -> Dict[str, torch.Tensor]:
    if type(model) not in _FORMATS:
        raise TypeError(f"no checkpoint format for {type(model).__name__}; "
                        f"known: {sorted(c.__name__ for c in _FORMATS)}")
    from_jax, dropped = _FORMATS[type(model)]
    if path.endswith(".pth"):
        return {k: v for k, v in _reference_state_dict(payload).items()
                if not (dropped and re.match(dropped, k))}
    params = payload.get("params", payload) \
        if isinstance(payload, dict) else payload
    return from_jax(model, params)


def _read(path: str) -> Any:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; the port reads .pth "
            "and .ckpt files (Orbax needs orbax and tensorstore, which the "
            "port does not use: ROADMAP.md §1 item 8)")
    if path.endswith(".pth"):
        # a full pickle, as the reference's loader reads it: its training
        # checkpoints hold more than tensors (epochs, numpy scalars)
        return torch.load(path, map_location="cpu", weights_only=False)
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the weights at ``path`` (``.pth`` or a JAX ``.ckpt``) into
    ``model`` (VeloxSeg, U-RWKV or one of the zoo's baselines) in place,
    strictly; returns ``model``."""
    model.load_state_dict(_model_state(path, _read(path), model),
                          strict=True)
    return model


def _optimizer_state_from_jax(optimizer: torch.optim.Optimizer,
                              model: torch.nn.Module, opt_state: dict,
                              params: dict) -> dict:
    """A ``torch.optim`` state dict for ``optimizer`` from a JAX optax
    state (its moments mapped by the model's own map of its params, as its
    weights are): each parameter's state placed at its index in the
    optimizer."""
    from_jax, _ = _FORMATS[type(model)]
    by_key = optimizer_state_from_jax(opt_state, params,
                                      lambda tree: from_jax(model, tree))
    names = {id(p): k for k, p in model.named_parameters()}
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            if names[id(p)] in by_key:
                state[index] = by_key[names[id(p)]]
            index += 1
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> Dict[str, Any]:
    """Resume from a training checkpoint: the weights into ``model`` and
    the optimizer's state into ``optimizer`` (where the file has one), in
    place. Returns ``{epoch, best_train_dice, best_val_dice,
    scheduler_state}``."""
    payload = _read(path)
    model.load_state_dict(_model_state(path, payload, model), strict=True)
    if not isinstance(payload, dict):
        payload = {}
    if optimizer is not None:
        if path.endswith(".pth"):
            if payload.get("optimizer") is not None:
                optimizer.load_state_dict(payload["optimizer"])
        elif payload.get("opt_state") is not None:
            optimizer.load_state_dict(_optimizer_state_from_jax(
                optimizer, model, payload["opt_state"], payload["params"]))
        # a state dict places its entries by position: each must fit its
        # parameter (another model's order would not)
        for group in optimizer.param_groups:
            for p in group["params"]:
                for k, v in optimizer.state.get(p, {}).items():
                    if v.dim() and v.shape != p.shape:
                        raise ValueError(
                            f"{path}: optimizer state {k} of shape "
                            f"{tuple(v.shape)} for a parameter of shape "
                            f"{tuple(p.shape)}")
    return {"epoch": int(payload.get("epoch", 0)),
            "best_train_dice": float(payload.get("best_train_dice", 0.0)),
            "best_val_dice": float(payload.get("best_val_dice", 0.0)),
            "scheduler_state": dict(payload.get("scheduler_state") or {})}
