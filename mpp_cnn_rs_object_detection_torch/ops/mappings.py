"""Value <-> class-bin mappings for the 32-bin mark distributions.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/ops/mappings.py`` (the
parts the inference path and the host training targets use): bin left edges
``linspace(v_min, v_max, n+1)[:-1]``, ``value_to_class`` floors and clips,
cyclic mappings wrap, and detections decode at the bin CENTER.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class ValueMapping:
    n_classes: int
    v_min: float
    v_max: float
    is_cyclic: bool = False

    def __post_init__(self):
        self.feature_mapping = np.linspace(
            self.v_min, self.v_max, num=self.n_classes + 1
        )[:-1]

    @property
    def range(self) -> float:
        return self.v_max - self.v_min

    def get_step(self) -> float:
        return float(np.mean(np.diff(self.feature_mapping)))

    def value_to_class(self, value):
        """Largest bin index whose left edge is <= value (clipped)."""
        step = self.range / self.n_classes
        if isinstance(value, torch.Tensor):
            cls = torch.floor((value - self.v_min) / step).to(torch.int64)
            return torch.clamp(cls, 0, self.n_classes - 1)
        cls = np.floor((np.asarray(value) - self.v_min) / step).astype(np.int64)
        out = np.clip(cls, 0, self.n_classes - 1)
        if np.isscalar(value) or np.ndim(value) == 0:
            return int(out)
        return out

    def class_to_value(self, class_id):
        if isinstance(class_id, torch.Tensor):
            fm = torch.as_tensor(self.feature_mapping, dtype=torch.float32,
                                 device=class_id.device)
            return fm[class_id]
        return self.feature_mapping[np.asarray(class_id)]

    def class_to_center_value(self, class_id):
        """Bin CENTER (the unbiased inverse of the floor encode)."""
        return self.class_to_value(class_id) + 0.5 * self.get_step()


def default_mappings(n_classes: int = 32, size_min: float = 0.0,
                     size_max: float = 32.0) -> List[ValueMapping]:
    """The (size, ratio, angle) mappings used by ShapeNet."""
    return [
        ValueMapping(n_classes, size_min, size_max),
        ValueMapping(n_classes, 0.0, 1.0),
        ValueMapping(n_classes, 0.0, np.pi, is_cyclic=True),
    ]


def values_to_class_id(values, mappings: List[ValueMapping]):
    """Per-mark class ids of a list of (size, ratio, angle) tuples: one
    array per mapping (a list of per-feature values maps element-wise)."""
    if len(values) == 0:
        return []
    arr = np.asarray(values, dtype=np.float64)
    if arr.ndim == 2:
        return [m.value_to_class(arr[:, i]) for i, m in enumerate(mappings)]
    return [m.value_to_class(v) for v, m in zip(values, mappings)]
