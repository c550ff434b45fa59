"""Optimizers and the epoch-wise learning rate
(``veloxseg_tpu/train/optim.py``, reference ``utils/optimizers/``).

The JAX package builds optax transforms; the port builds the
``torch.optim`` optimizer of the same update, with optax's defaults
(betas 0.9/0.999, eps 1e-8):

- ``adam``: Adam with the weight decay added to the gradient (L2, as
  ``optax.add_decayed_weights`` before ``optax.adam``);
- ``adamw``: AdamW with decoupled weight decay on every parameter;
- ``sgd``: SGD with optional momentum and L2 weight decay.

The learning rate is a plain number in each parameter group, set per
epoch by the host-side :class:`EpochScheduler` (:func:`set_learning_rate`),
as the JAX package injects it as a hyper-parameter.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

_BETAS = (0.9, 0.999)
_EPS = 1e-8


def build_optimizer(optimizer_type: str, optimizer_args: dict,
                    params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    lr = float(optimizer_args["lr"])
    wd = float(optimizer_args.get("weight_decay") or 0.0)
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=lr, betas=_BETAS, eps=_EPS,
                                weight_decay=wd)
    if optimizer_type == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=_BETAS, eps=_EPS,
                                 weight_decay=wd)
    if optimizer_type == "sgd":
        momentum = float(optimizer_args.get("momentum") or 0.0)
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=wd)
    raise ValueError("must be adam or adamw for now")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class EpochScheduler:
    """Epoch-indexed LR with warmup handoff and plateau support."""

    def __init__(self, config):
        self.base_lr = float(
            config["optimizer"]["optimizer_args"]["lr"])
        warm = config.get("warmup_scheduler", {})
        self.warmup_epochs = (int(warm.get("warmup_epochs", 0))
                              if warm.get("enabled", False) else 0)
        sched = config["train_scheduler"]
        self.scheduler_type = sched["scheduler_type"]
        self.args = sched.get("scheduler_args", {})
        self.epochs = int(config["epochs"])
        # reducelronplateau state
        self.mode = sched.get("mode", "max")
        self.patience = int(sched.get("patience", 10))
        self.factor = 0.1
        self.min_lr = float(self.args.get("min_lr", 0.0))
        self._plateau_scale = 1.0
        self._best: Optional[float] = None
        self._bad_epochs = 0

    def learning_rate(self, epoch: int) -> float:
        """LR in effect during ``epoch`` (0-indexed), reference stepping."""
        w = self.warmup_epochs
        if epoch < w:
            return self.base_lr * (epoch + 1) / w
        t = epoch - w
        if self.scheduler_type == "cosine_annealing":
            t_max = int(self.args["epochs"])
            eta_min = float(self.args["min_lr"])
            t = min(t, t_max)
            return eta_min + (self.base_lr - eta_min) * 0.5 * (
                1.0 + math.cos(math.pi * t / t_max))
        if self.scheduler_type == "poly_lr":
            total = self.epochs - w
            power = float(self.args["power"])
            frac = min(t, total) / total
            return self.base_lr * (1.0 - frac) ** power
        if self.scheduler_type == "reducelronplateau":
            return max(self.base_lr * self._plateau_scale, self.min_lr)
        raise NotImplementedError(
            "Specified Scheduler Is Not Implemented")

    def plateau_step(self, metric: float) -> None:
        """Update plateau state with a validation metric (mode-aware)."""
        if self.scheduler_type != "reducelronplateau":
            return
        better = (self._best is None
                  or (self.mode == "max" and metric > self._best)
                  or (self.mode == "min" and metric < self._best))
        if better:
            self._best = metric
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._plateau_scale *= self.factor
                self._bad_epochs = 0

    def state_dict(self) -> dict:
        return {"plateau_scale": self._plateau_scale, "best": self._best,
                "bad_epochs": self._bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self._plateau_scale = d.get("plateau_scale", 1.0)
        self._best = d.get("best")
        self._bad_epochs = d.get("bad_epochs", 0)
