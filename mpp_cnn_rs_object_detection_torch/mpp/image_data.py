"""ImageWMaps: the CNN -> MPP data contract.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/image_data.py``
(``ImageWMaps``). The maps may be numpy arrays or torch
tensors; exact-scene inference moves them to its device once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mpp_cnn_rs_object_detection_torch.ops.mappings import ValueMapping

PARAM_NAMES = ["size", "ratio", "angle"]


@dataclass
class ImageWMaps:
    image: Any                     # (H, W, 3)
    name: str
    shape: Tuple[int, int]
    detection_map: Any             # (H, W)
    param_dist_maps: Any           # 3 x (H, W, C), or stacked (3, H, W, C)
    mappings: List[ValueMapping]
    labels: Dict[str, np.ndarray]
    gt_centers: np.ndarray         # (N, 2)
    gt_marks: np.ndarray           # (N, 3) size/ratio/angle
    param_names: List[str] = field(default_factory=lambda: list(PARAM_NAMES))
    crop_data: Optional[Dict] = None
