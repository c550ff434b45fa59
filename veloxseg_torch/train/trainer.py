"""Dataset profiles of the trainer (``veloxseg_tpu/train/trainer.py:51-68``).

For now the module holds only ``DatasetProfile`` and ``PROFILES``, which
the inference driver reads: each dataset's glob keys in the train
config, modality names, whether labels are binary and how many raw
modalities a case has. ``run_train`` comes with the trainer and the data
pipeline (``ROADMAP.md`` §1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    glob_keys: Tuple[str, ...]      # train-config dataset_path keys, order
    modality_names: Tuple[str, ...]
    use_foreground_crop: bool
    binary_label: bool
    raw_modal_count: int


PROFILES: Dict[str, DatasetProfile] = {
    "AutoPETII": DatasetProfile(("ct_path", "pet_path"), ("ct", "pet"),
                                True, True, 2),
    "Hecktor2022": DatasetProfile(("ct_path", "pet_path"), ("ct", "pet"),
                                  False, True, 2),
    "BraTS2021": DatasetProfile(
        ("flair_path", "t1_path", "t1ce_path", "t2_path"),
        ("flair", "t1", "t1ce", "t2"), False, False, 4),
}
