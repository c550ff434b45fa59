"""Modality selection, dataset-glob checks and training-output bookkeeping.

Own copies of ``veloxseg_tpu/utils/runtime.py:14-116`` (modality selection,
file-group checks and the rotation range, the reference's
``utils/runtime.py:21-115``) and ``:127-182`` (the reference's
``utils/runtime.py:125-174``), so the port needs nothing of the JAX
package. All pure Python.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple


def resolve_modal_index(select_modal, raw_modal_count: int) -> List[int]:
    """One-hot (or all-ones) modality selection mask.

    Parity: reference ``utils/runtime.py:21-40``.
    """
    if raw_modal_count <= 0:
        raise ValueError("raw_modal_count must be greater than 0")
    if select_modal is None:
        return [1] * raw_modal_count
    try:
        selected = int(select_modal)
    except (TypeError, ValueError) as exc:
        raise ValueError("--select_modal must be an integer index") from exc
    if not 0 <= selected < raw_modal_count:
        raise ValueError(
            f"--select_modal index {selected} is out of range for "
            f"{raw_modal_count} modalities")
    mask = [0] * raw_modal_count
    mask[selected] = 1
    return mask


_IN_CH_ALIASES = (
    "in_channels", "input_channel", "num_input_channels", "input_channels",
    "init_channels", "model_num", "modality_num",
)


def expected_input_channels(model_name: str,
                            model_config: Dict) -> Optional[int]:
    """Total input channels a model expects, from its config entry.

    Parity: reference ``utils/runtime.py:43-67`` including the per-model
    key aliases.
    """
    config = model_config.get(model_name)
    if config is None:
        return None
    in_ch = config.get("in_ch")
    if isinstance(in_ch, (list, tuple)):
        return sum(int(c) for c in in_ch)
    if isinstance(in_ch, int):
        return in_ch
    for key in _IN_CH_ALIASES:
        value = config.get(key)
        if isinstance(value, int):
            return value
    return None


def validate_selected_modal(model_name, model_config, raw_modal_count,
                            select_modal) -> List[int]:
    """Cross-check --select_modal against the model's input channels.

    Parity: reference ``utils/runtime.py:70-82``.
    """
    mask = resolve_modal_index(select_modal, raw_modal_count)
    selected_channels = sum(mask)
    expected = expected_input_channels(model_name, model_config)
    if expected is not None and selected_channels != expected:
        raise ValueError(
            f"Model {model_name} expects {expected} input channel(s), but "
            f"the selected modalities provide {selected_channels}. Use a "
            "matching model config/checkpoint or omit --select_modal.")
    return mask


def select_modal_items(items: Sequence, modal_index: Sequence[int]) -> List:
    """Filter per-modality items by a selection mask.

    Parity: reference ``utils/runtime.py:85-93``.
    """
    if len(items) != len(modal_index):
        raise ValueError(
            f"modal_index length {len(modal_index)} must match item count "
            f"{len(items)}")
    selected = [item for item, on in zip(items, modal_index) if on]
    if not selected:
        raise ValueError("At least one modality must be selected")
    return selected


def validate_file_groups(dataset_name: str,
                         file_groups: Dict[str, Sequence[str]]) -> int:
    """Check all modality/label globs matched the same nonzero file count.

    Parity: reference ``utils/runtime.py:96-112``.
    """
    counts = {name: len(paths) for name, paths in file_groups.items()}
    empty = [name for name, count in counts.items() if count == 0]
    if empty:
        raise ValueError(
            f"No files matched for {dataset_name}: {', '.join(empty)}")
    unique = set(counts.values())
    if len(unique) != 1:
        details = ", ".join(f"{n}={c}" for n, c in counts.items())
        raise ValueError(
            f"Dataset {dataset_name} modalities/labels must have the same "
            f"number of files before pairing; got {details}.")
    return next(iter(unique))


def rotation_range_from_degrees(degrees) -> float:
    return math.radians(float(degrees))


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


def a2fseg_deep_output_groups(output_count: int,
                              group_size: int = 5) -> List[Tuple[int, int]]:
    """Slice bounds of A2FSeg's grouped deep outputs (1 + N·group_size
    outputs)."""
    if output_count <= 1 or (output_count - 1) % group_size != 0:
        raise ValueError(
            f"A2FSeg output count {output_count} must be 1 + N * "
            f"{group_size}")
    return [(s, s + group_size) for s in range(1, output_count, group_size)]


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
