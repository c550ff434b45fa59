"""The training step: forward (train-mode output contract), composite
loss, backward and one optimizer update
(``veloxseg_tpu/train/train_state.py:26-145``), fp32.

PyTorch runs it eagerly: the model's parameters are updated in place,
where the JAX package returns a new state. The multi-step, accumulation
and metrics variants are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..utils.device import resolve_device
from .loss import CompositeLoss


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and the count of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


def train_step_fn(loss_obj: CompositeLoss,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Callable:
    """Build the train step on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``).

    Returns ``step(state, inputs, labels, generator) -> (state, aux)``:
    ``inputs`` (B, D, H, W, C) fp32 and ``labels`` (B, D, H, W) integer,
    moved to the device; ``generator`` the ``torch.Generator`` (on the
    device) that draws every dropout mask and attention seed of the step;
    ``aux["loss"]`` the scalar loss, on the device.
    """
    dev = resolve_device(device)

    def step(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator]):
        model = state.model
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"the model is not on {dev}")
        inputs = inputs.to(dev, torch.float32)
        labels = labels.to(dev)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outs = model(inputs, generator)
        loss = loss_obj(outs, labels, sr_labels=inputs)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step
