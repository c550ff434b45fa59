"""Training-output bookkeeping shared by the loss and the train step.

Own copies of ``veloxseg_tpu/utils/runtime.py:127-182`` (the reference's
``utils/runtime.py:125-174``), so the port needs nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def normalized_deep_loss_weights(configured_weights: Sequence[float],
                                 output_count: int) -> List[float]:
    """Normalize deep-supervision weights to the actual output count.

    A length mismatch is tolerated only when all configured weights are
    equal (uniform fallback)."""
    if output_count <= 0:
        raise ValueError("output_count must be greater than 0")
    weights = [float(w) for w in configured_weights]
    if not weights:
        raise ValueError("deep_Loss_weight must contain at least one value")
    if sum(weights) == 0:
        raise ValueError("deep_Loss_weight sum must be non-zero")
    if len(weights) != output_count:
        if all(w == weights[0] for w in weights):
            return [1.0 / output_count] * output_count
        raise ValueError(
            "deep_Loss_weight length must match model deep-supervision "
            "outputs unless all configured weights are equal")
    total = sum(weights)
    return [w / total for w in weights]


def veloxseg_output_layout(output_count: int, num_modal: int) -> Dict:
    """Index layout of the VeloxSeg training output list
    ``[*seg_preds, recons, student_gram, *teacher_grams]``."""
    tail = 2 + int(num_modal)
    if output_count <= tail:
        raise ValueError(
            f"VeloxSeg output count {output_count} is too small for "
            f"{num_modal} modality reconstruction outputs")
    seg_count = output_count - tail
    return {
        "seg": (0, seg_count),
        "reconstruction": seg_count,
        "decoder_gram": seg_count + 1,
        "teacher_grams": tuple(range(seg_count + 2,
                                     seg_count + 2 + int(num_modal))),
    }
