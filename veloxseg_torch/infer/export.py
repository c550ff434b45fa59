"""Serving export: the eval forward as one ``torch.export`` artifact
(``veloxseg_tpu/infer/export.py:43-109`` on PyTorch).

- :func:`export_eval` traces the model's eval forward with
  :func:`torch.export.export` under :func:`..ops.portable.portable_scope`,
  so the graph holds only ``torch.ops.aten`` operations: the kernels' plain
  versions, as the JAX export traces attention to pure StableHLO.
- The batch dimension is symbolic (``torch.export.Dim``) unless ``batch``
  pins it: one artifact serves any batch.
- The parameters stay lifted inputs of the program (its state dict), not
  baked constants, as JAX keeps its parameters as arguments: another
  checkpoint's state dict serves through the same program
  (``program.module().load_state_dict(...)``) without a new export.
- :func:`save_artifact` writes one file, ``torch.export.save`` with the
  metadata as an extra file, by atomic rename (a temporary file, then
  ``os.replace``), as the JAX writer does.
- :func:`load_artifact` needs ``torch`` alone: nothing of this package.

The program is traced on one device and runs there: index tensors and
casts in the graph carry it, as a JAX artifact is lowered per platform.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.portable import portable_scope

_META_FILE = "veloxseg_metadata.json"
ARTIFACT_VERSION = 1


def export_eval(model: torch.nn.Module, input_size: Sequence[int],
                channels: int, *, batch: Optional[int] = None
                ) -> torch.export.ExportedProgram:
    """Export ``model``'s eval forward on ``(B, *input_size, channels)``
    channels-last float32 inputs, on the device its parameters are on.

    ``batch=None`` makes B symbolic (any batch at call time; the example
    batch is 2, since an example of 1 specializes the dimension); an int
    pins it."""
    dev = next(model.parameters()).device
    example = torch.zeros((2 if batch is None else int(batch),
                           *tuple(input_size), channels), device=dev)
    dynamic = None if batch is not None else (
        {0: torch.export.Dim("b", min=1)},)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), portable_scope():
            return torch.export.export(model, (example,),
                                       dynamic_shapes=dynamic, strict=False)
    finally:
        model.train(was_training)


def save_artifact(path: str, program: torch.export.ExportedProgram, *,
                  metadata: Optional[Dict] = None) -> None:
    """Write the program, its state dict and ``metadata`` (JSON) to one
    file, atomically."""
    meta = json.dumps({"version": ARTIFACT_VERSION, **(metadata or {})})
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp.pt2")
    os.close(fd)
    try:
        torch.export.save(program, tmp, extra_files={_META_FILE: meta})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_artifact(path: str) -> Tuple[torch.export.ExportedProgram,
                                      Dict[str, torch.Tensor], Dict]:
    """Load an artifact → ``(program, state_dict, metadata)``.

    ``program.module()(x)`` runs the forward with the exported weights;
    ``module.load_state_dict(other)`` serves another checkpoint's. Reads
    with ``torch`` alone."""
    extra = {_META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META_FILE] or "{}")
    if meta.get("version") != ARTIFACT_VERSION:
        raise ValueError(f"unsupported artifact version "
                         f"{meta.get('version')!r}")
    return program, dict(program.state_dict), meta
