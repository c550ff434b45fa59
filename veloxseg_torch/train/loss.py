"""Composite training loss, keyed by model name
(``veloxseg_tpu/train/loss.py:28-215``).

For VeloxSeg ``total = Σ_deep w_i·(CE + Dice) + rc_w·MSE(recon, input)
+ feat_w·mean_m MSE(gram_student, gram_teacher_m)``; A2FSeg's grouped
deep outputs plus the primary head's CE; VSmTrans, UNETRpp and HDense
their deep-supervised sum; every other model CE + Dice on its first
output. MONAI ``DiceLoss(include_background=False, to_onehot_y=True,
softmax=True)`` semantics (smooth 1e-5 in numerator and denominator).
Channels-last logits ``(B, *spatial, C)``, integer labels
``(B, *spatial)``; every reduction in fp32, or in float64 for float64
outputs (a float64 step is then float64 throughout: the yardstick the
zoo's fp32 steps are held by). Only the unblocked heads are
ported: the JAX package's ``blocked_scale`` is a TPU layout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..utils.runtime import (a2fseg_deep_output_groups,
                             normalized_deep_loss_weights,
                             veloxseg_output_layout)

Outputs = Union[torch.Tensor, Sequence[torch.Tensor]]


SMOOTH = 1e-5          # MONAI DiceLoss's smooth_nr and smooth_dr


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or as it is in float64."""
    return t if t.dtype == torch.float64 else t.float()


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean softmax cross-entropy over voxels with integer labels, in fp32
    (``veloxseg_tpu/train/loss.py:28-39``)."""
    logp = torch.log_softmax(_wide(logits), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[..., None]))


def fused_ce_dice_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Softmax cross-entropy (mean over voxels) plus MONAI Dice without the
    background class, sharing one log-sum-exp, per class as the JAX package
    computes it."""
    n_classes = logits.shape[-1]
    xs = [_wide(logits[..., c]) for c in range(n_classes)]
    m = xs[0]
    for xc in xs[1:]:
        m = torch.maximum(m, xc)
    exps = [torch.exp(xc - m) for xc in xs]
    sumexp = sum(exps)
    lse = m + torch.log(sumexp)
    ce = torch.mean(sum(torch.where(labels == c, lse - xc, 0.0)
                        for c, xc in enumerate(xs)))
    axes = tuple(range(1, labels.dim()))
    dice_sum = 0.0
    for c in range(1, n_classes):
        probs_c = exps[c] / sumexp
        mask_c = labels == c
        inter = torch.where(mask_c, probs_c, 0.0).sum(dim=axes)
        denom = probs_c.sum(dim=axes) + mask_c.to(probs_c.dtype).sum(
            dim=axes)
        dice_sum = dice_sum + torch.mean(
            1.0 - (2.0 * inter + SMOOTH) / (denom + SMOOTH))
    return ce + dice_sum / (n_classes - 1)


class CompositeLoss:
    """The reference ``Loss`` (``utils/loss.py:10-86``) for the model
    ``model_name``, as the JAX package's ``CompositeLoss``: ``num_modal``
    teacher Grams in VeloxSeg's output list (the trainer passes the count
    of the model config's ``in_ch``)."""

    def __init__(self, model_name: str, config, num_modal: int = 2):
        self.model_name = model_name
        self.num_modal = int(num_modal)
        self.deep_loss_weight = [float(w) for w in
                                 config["deep_Loss_weight"]]
        self.rc_loss_weight = config.get("RC_Loss_weight")
        self.feature_loss_weight = config.get("Feature_Loss_weight")

    def deep_seg_loss(self, outputs: Outputs, labels: torch.Tensor
                      ) -> torch.Tensor:
        if isinstance(outputs, torch.Tensor):
            outputs = [outputs]
        weights = normalized_deep_loss_weights(self.deep_loss_weight,
                                               len(outputs))
        loss = 0.0
        for w, out in zip(weights, outputs):
            loss = loss + w * fused_ce_dice_loss(out, labels)
        return loss

    def metric_outputs(self, output: Outputs) -> List[torch.Tensor]:
        """The seg heads' logits for per-head metrics
        (``veloxseg_tpu/train/loss.py:154-166``, reference
        ``utils/train_autopet.py:246-254``): a single tensor as a list of
        one; VeloxSeg's output list without its tail of reconstruction,
        student Gram and one teacher Gram per modality; any other model's
        list as it is."""
        if isinstance(output, torch.Tensor):
            return [output]
        if self.model_name == "VeloxSeg":
            return list(output[:-(2 + self.num_modal)])
        return list(output)

    def __call__(self, output: Outputs, labels: torch.Tensor,
                 sr_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        name = self.model_name
        if name == "VeloxSeg":
            layout = veloxseg_output_layout(len(output), self.num_modal)
            s0, s1 = layout["seg"]
            seg = self.deep_seg_loss(output[s0:s1], labels)
            rc = torch.mean(torch.square(
                _wide(output[layout["reconstruction"]]) - _wide(sr_labels)))
            student = _wide(output[layout["decoder_gram"]])
            feat = 0.0
            for t in layout["teacher_grams"]:
                feat = feat + torch.mean(torch.square(student
                                                      - _wide(output[t])))
            feat = feat / self.num_modal
            return (seg + self.rc_loss_weight * rc
                    + self.feature_loss_weight * feat)
        if name == "A2FSeg":
            loss = 0.0
            for start, end in a2fseg_deep_output_groups(len(output)):
                loss = loss + self.deep_seg_loss(output[start:end], labels)
            primary_w = normalized_deep_loss_weights(
                self.deep_loss_weight, len(self.deep_loss_weight))[0]
            return loss + primary_w * softmax_ce_loss(output[0], labels)
        if name in ("VSmTrans", "UNETRpp", "HDense"):
            return self.deep_seg_loss(output, labels)
        if not isinstance(output, torch.Tensor):
            output = output[0]
        return fused_ce_dice_loss(output, labels)
