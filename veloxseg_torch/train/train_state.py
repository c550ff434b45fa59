"""The training steps: forward (train-mode output contract), composite
loss, backward, the optimizer update and the step's metrics
(``veloxseg_tpu/train/train_state.py:42-256``).

Mixed precision as the JAX package's (``train_state.py:34-69``): with a
``compute_dtype`` (bf16; None is fp32) the forward runs on copies of the
fp32 parameters and of the inputs cast to that dtype, and the
reconstruction target is the input as cast; the casts' backward brings each
gradient back to its fp32 parameter, so the master weights and the
optimizer's state stay fp32. The norms, the Gram matrices and the loss
compute in fp32 inside the forward (``nn/norms.py``, ``ops/gram.py``,
``train/loss.py``).

PyTorch runs them eagerly: the model's parameters and the optimizer's
state are updated in place, where the JAX package returns a new state.
Every step returns its ``aux`` dict on the device (nothing is read back
to the host inside a step): ``aux["loss"]``, head 0's binary metrics
(``with_metrics``) and, with ``deep_metric_heads``, ``aux["deep"]``: one
metrics dict per seg head with its ``pred_pix``/``label_pix`` counts
(``_metrics_aux``, ``:72-104``). The JAX package's patch-blocked head 0 is
a TPU layout: the port computes the same metrics from the unblocked head.

- :func:`train_step_fn`: one step.
- :func:`train_multi_step_fn`: K steps on a stacked (K, B, ...) batch, each
  with its own dropout draws; the aux stacked on a leading K axis. The same
  numbers as K single steps: the JAX API's counterpart, which the trainer
  does not call (its ``steps_per_dispatch`` runs K single steps).
- :func:`train_accum_step_fn`: one update from gradients averaged over A
  micro-batches, each micro-batch's backward done before the next
  forward; aux means over the micro-batches, ``*_pix`` sums.
- :func:`eval_step_fn`: the eval forward's argmax and logits.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Union

import torch
from torch.func import functional_call

from ..utils.device import resolve_device
from .loss import CompositeLoss
from .metrics import deep_metrics, pred_from_logits, segmentation_metrics


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and the count of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


def takes_generator(model: torch.nn.Module) -> bool:
    """Whether ``model``'s forward draws from a ``torch.Generator``
    argument in training: VeloxSeg's ``forward(x, generator)``, and the
    zoo's ``forward(x, generator=None)`` of every model with a dropout site
    (``models/zoo/common.dropout``) or SuperLightNet's fold draw. A model
    that draws nothing (UNet, SegFormer, ...) takes the input alone; the
    step passes the generator only to a model that takes one."""
    return "generator" in inspect.signature(model.forward).parameters


def _loss_and_heads(state: TrainState, loss_obj: CompositeLoss,
                    dev: torch.device, deep_metric_heads: bool,
                    compute_dtype: Optional[torch.dtype]):
    """``f(inputs, labels, generator) -> (loss, seg heads, labels)`` on
    ``dev``: the forward and the loss of one (micro-)batch, without the
    backward; with ``compute_dtype``, the forward on the parameters and
    inputs cast to it (``_loss_grads_fn``, ``train_state.py:42-69``)."""

    draws = takes_generator(state.model)

    def f(inputs, labels, generator):
        if next(state.model.parameters()).device.type != dev.type:
            raise ValueError(f"the model is not on {dev}")
        x = inputs.to(dev, torch.float32)
        labels = labels.to(dev)
        state.model.train()
        params = None
        if compute_dtype not in (None, torch.float32):
            x = x.to(compute_dtype)
            params = {k: p.to(compute_dtype) if p.is_floating_point() else p
                      for k, p in state.model.named_parameters()}
        args = (x, generator) if draws else (x,)
        outs = (state.model(*args) if params is None
                else functional_call(state.model, params, args))
        # the reconstruction target is the input as the forward saw it
        # (``sr_labels=x.astype(jnp.float32)``, ``train_state.py:55-59``)
        loss = loss_obj(outs, labels, sr_labels=x.float())
        heads = loss_obj.metric_outputs(outs)
        if not deep_metric_heads:
            heads = heads[:1]
        return loss, [h.detach() for h in heads], labels

    return f


@torch.no_grad()
def _metrics_aux(heads: List[torch.Tensor], labels: torch.Tensor,
                 with_metrics: bool, deep_metric_heads: bool) -> Dict:
    aux: Dict = {}
    if with_metrics:
        if deep_metric_heads:
            # head 0's metrics once; the deep tuple keeps head 0 with its
            # pix counts, as the reference's show_deep_metrics prints it
            per_head = deep_metrics(heads, labels)
            aux.update({k: v for k, v in per_head[0].items()
                        if k not in ("pred_pix", "label_pix")})
            aux["deep"] = tuple(per_head)
        else:
            aux.update(segmentation_metrics(labels,
                                            pred_from_logits(heads[0])))
    return aux


def train_step_fn(loss_obj: CompositeLoss,
                  device: Optional[Union[str, torch.device]] = None,
                  with_metrics: bool = True,
                  deep_metric_heads: bool = False,
                  compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Build the train step on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``), computing in ``compute_dtype``
    (None: fp32; the trainer passes ``torch.bfloat16``).

    Returns ``step(state, inputs, labels, generator) -> (state, aux)``:
    ``inputs`` (B, D, H, W, C) fp32 and ``labels`` (B, D, H, W) integer,
    moved to the device; ``generator`` the ``torch.Generator`` (on the
    device) that draws every dropout mask and attention seed of the step,
    passed to a model whose forward takes one (:func:`takes_generator`);
    a model that draws nothing is called on the input alone. ``loss_obj``
    is the model's ``CompositeLoss``.
    """
    dev = resolve_device(device)

    def step(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator]):
        forward = _loss_and_heads(state, loss_obj, dev, deep_metric_heads,
                                  compute_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        loss, heads, labels = forward(inputs, labels, generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        aux = {"loss": loss.detach()}
        aux.update(_metrics_aux(heads, labels, with_metrics,
                                deep_metric_heads))
        return state, aux

    return step


def _stack_aux(auxs: List[Dict], combine: Optional[Callable] = None) -> Dict:
    """Per-step aux dicts → one dict of (K,) tensors, or, with ``combine``
    (``(key, stacked) -> tensor``), of its reductions."""

    def merge(dicts):
        out = {}
        for k in dicts[0]:
            if k == "deep":
                out[k] = tuple(merge([d[k][i] for d in dicts])
                               for i in range(len(dicts[0][k])))
            else:
                v = torch.stack([d[k] for d in dicts])
                out[k] = combine(k, v) if combine else v
        return out

    return merge(auxs)


def train_multi_step_fn(loss_obj: CompositeLoss,
                        device: Optional[Union[str, torch.device]] = None,
                        with_metrics: bool = True,
                        deep_metric_heads: bool = False,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> Callable:
    """K optimizer steps per call: ``multi(state, inputs, labels,
    generator) -> (state, auxs)`` with ``inputs`` (K, B, D, H, W, C) and
    ``labels`` (K, B, D, H, W); each slice is one full step drawing its
    dropout from ``generator`` in turn, and ``auxs`` is the per-step aux
    stacked on a leading K axis. The JAX package scans the K steps in one
    dispatch; eager PyTorch issues them one after another, with the same
    numbers as K :func:`train_step_fn` calls."""
    step = train_step_fn(loss_obj, device, with_metrics, deep_metric_heads,
                         compute_dtype)

    def multi(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor,
              generator: Optional[torch.Generator]):
        auxs = []
        for x, y in zip(inputs, labels):
            state, aux = step(state, x, y, generator)
            auxs.append(aux)
        return state, _stack_aux(auxs)

    return multi


def train_accum_step_fn(loss_obj: CompositeLoss,
                        device: Optional[Union[str, torch.device]] = None,
                        with_metrics: bool = True,
                        deep_metric_heads: bool = False,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> Callable:
    """ONE optimizer update from the gradients averaged over A
    micro-batches: ``step(state, inputs, labels, generator) -> (state,
    aux)`` with ``inputs`` (A, b, D, H, W, C) and ``labels`` (A, b, D, H,
    W). Each micro-batch's backward finishes before the next forward, so
    activations never exceed one micro-batch's. The gradients are summed
    in micro-batch order and divided by A, as the JAX scan does. ``aux``
    matches a single step's on the effective batch: micro-batch means,
    ``*_pix`` counts summed."""
    dev = resolve_device(device)

    def combine(key, v):
        return v.sum(0) if key.endswith("_pix") else v.float().mean(0)

    def step(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator]):
        forward = _loss_and_heads(state, loss_obj, dev, deep_metric_heads,
                                  compute_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        auxs = []
        for x, y in zip(inputs, labels):
            loss, heads, y = forward(x, y, generator)
            loss.backward()              # sums into .grad, in order
            aux = {"loss": loss.detach()}
            aux.update(_metrics_aux(heads, y, with_metrics,
                                    deep_metric_heads))
            auxs.append(aux)
        a = inputs.shape[0]
        with torch.no_grad():
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(a)
        state.optimizer.step()
        state.step += 1
        return state, _stack_aux(auxs, combine)

    return step


def eval_step_fn(model: torch.nn.Module) -> Callable:
    """``step(inputs) -> (argmax int32, logits)``: the eval forward on the
    model's device, without autograd, in fp32 (the JAX ``eval_step_fn``
    takes no dtype); the first maximum wins, as ``jnp.argmax``."""

    @torch.inference_mode()
    def step(inputs: torch.Tensor):
        model.eval()
        dev = next(model.parameters()).device
        logits = model(inputs.to(dev, torch.float32))
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    return step
