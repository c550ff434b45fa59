"""Voxel-wise segmentation metrics (PET/CT-style, binary).

``veloxseg_tpu/train/metrics.py:21-98`` as torch functions (reference
``utils/metric/metrics.py:42-96``): FP-rate, FN-rate, precision, recall,
F1, IoU and Dice on integer masks with smooth 1e-5, averaged over the
batch; every sum in float32, as in JAX. They run on the tensors' device,
so the card computes the metrics where the TPU did. The patch-blocked
heads (``class_block``) are a TPU layout and are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

_SMOOTH = 1e-5


def segmentation_metrics(gt: torch.Tensor, pred: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """Binary metrics; gt/pred are int masks of equal shape (B, *spatial)."""
    gt = (gt != 0).float()
    pred = (pred != 0).float()
    dims = tuple(range(1, gt.ndim))

    tp = torch.sum(gt * pred, dim=dims)
    fp = torch.sum(pred * (1.0 - gt), dim=dims)
    fn = torch.sum(gt * (1.0 - pred), dim=dims)
    tn = torch.sum((1.0 - gt) * (1.0 - pred), dim=dims)
    gt_sum = torch.sum(gt, dim=dims)
    pred_sum = torch.sum(pred, dim=dims)
    inter = tp
    union = tp + fp + fn

    precision = tp / (pred_sum + _SMOOTH)
    recall = tp / (gt_sum + _SMOOTH)
    f1 = 2 * precision * recall / (precision + recall + _SMOOTH)
    fp_rate = fp / (fp + tn + _SMOOTH)
    fn_rate = fn / (fn + tp + _SMOOTH)
    iou = inter / (union + _SMOOTH)
    dice = 2 * inter / (gt_sum + pred_sum + _SMOOTH)

    return {
        "fp_rate": fp_rate.mean(),
        "fn_rate": fn_rate.mean(),
        "precision": precision.mean(),
        "recall": recall.mean(),
        "f1": f1.mean(),
        "iou": iou.mean(),
        "dice": dice.mean(),
    }


def pred_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Class prediction (int32) from channels-last logits; two classes take
    the compare ``logits[..., 1] > logits[..., 0]``, as JAX does."""
    if logits.shape[-1] == 2:
        return (logits[..., 1] > logits[..., 0]).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def deep_metrics(outputs: Sequence[torch.Tensor], labels: torch.Tensor
                 ) -> List[Dict[str, torch.Tensor]]:
    """Per-head metrics for deep-supervision outputs (channels-last logits).

    Mirrors ``show_deep_metrics`` (``utils/metric/metrics.py:6-25``) minus
    the string formatting, which belongs to the logger. Each head's dict
    also carries the ``pix:{output.sum()}/{labels.sum()}`` counts the
    reference prints; they sum class indices (so for multi-class labels
    they are not voxel counts), reproduced as-is for log parity.
    """
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    per_head = []
    label_pix = torch.sum(labels.to(torch.int32))
    for o in outputs:
        pred = pred_from_logits(o)
        m = segmentation_metrics(labels, pred)
        m["pred_pix"] = torch.sum(pred)
        m["label_pix"] = label_pix
        per_head.append(m)
    return per_head
