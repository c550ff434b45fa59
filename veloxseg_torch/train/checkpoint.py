"""Load inference weights into the port's models.

``veloxseg_tpu/train/checkpoint.py:98-123`` accepts three checkpoint forms;
:func:`load_params` loads the first two into a port model:

- ``.pth``: a reference-keyed PyTorch state dict, bare or wrapped in a
  training checkpoint (``utils/inference_petct.py:95-101``), unwrapped as
  ``veloxseg_tpu/interop/torch_import.py:308-322`` does, with the DDP
  ``module.`` prefix stripped (``:283-284``). The keys the JAX import drops
  are dropped here too: VeloxSeg's ``relative_position_index`` buffers
  (``torch_import.py:158-160``), and U-RWKV's dead parameters and batch
  norm statistics (``interop/zoo_import.py:1117-1131``).
- ``.ckpt``: the flax msgpack file the JAX trainer writes, a full payload
  (``params`` beside the optimizer state) or a bare params tree, read
  without flax (:mod:`.flax_msgpack`) and mapped by
  :mod:`..interop.jax_params` (VeloxSeg) or :mod:`..interop.zoo_params`
  (U-RWKV).
- an Orbax checkpoint directory: not ported yet (``ROADMAP.md`` §1 item 2);
  it raises.

Every form ends in ``load_state_dict(strict=True)``: a missing, unknown or
misshapen key raises.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import torch

from ..interop.jax_params import state_dict_from_jax
from ..interop.zoo_params import urwkv_state_dict_from_jax
from ..models.zoo.urwkv import URWKV
from .flax_msgpack import msgpack_restore

_VELOXSEG_DROPPED = re.compile(
    r".*\.position_embedding\.relative_position_index")
_URWKV_DROPPED = re.compile(
    r"(e[1-4]\.pwconv\.|outconv\.|"
    r"bx4rwkv\.allinone_spa\.(gamma2$|ln2\.))"
    r"|.*\.running_|.*num_batches_tracked$")


def _reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a ``.pth`` checkpoint, bare or wrapped
    (``"model"`` key, or a pickled module), with ``module.`` stripped."""
    # a full pickle, as the reference's loader reads it: its training
    # checkpoints hold more than tensors (epochs, numpy scalars)
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "model" in payload \
            and not any(k.endswith(".weight") for k in payload):
        payload = payload["model"]
    if hasattr(payload, "state_dict") and not isinstance(payload, dict):
        payload = payload.state_dict()
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in payload.items()}


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the weights at ``path`` (``.pth`` or a JAX ``.ckpt``) into
    ``model`` (VeloxSeg or U-RWKV) in place, strictly; returns ``model``."""
    urwkv = isinstance(model, URWKV)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; the port reads .pth "
            "and .ckpt files (Orbax: ROADMAP.md §1 item 2)")
    if path.endswith(".pth"):
        dropped = _URWKV_DROPPED if urwkv else _VELOXSEG_DROPPED
        state = {k: v for k, v in _reference_state_dict(path).items()
                 if not dropped.match(k)}
    else:
        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())
        params = payload.get("params", payload) \
            if isinstance(payload, dict) else payload
        state = (urwkv_state_dict_from_jax if urwkv
                 else state_dict_from_jax)(params)
    model.load_state_dict(state, strict=True)
    return model
