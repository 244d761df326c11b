"""Energy-term calibration helpers used at inference.

Counterpart of ``apply_remap_param_dist`` and ``calibrate_min_area`` in
``mpp_cnn_rs_object_detection_tpu/mpp/calibration.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def apply_remap_param_dist(param_dist_maps, coefs: Sequence[float],
                           intercepts: Sequence[float]):
    """``-2*sigmoid(p*coef + intercept) + 1`` on a list of 3 (H, W, C) maps
    or a stacked (3, H, W, C) tensor; returns the same form."""
    if isinstance(param_dist_maps, (list, tuple)):
        return [-2.0 * torch.sigmoid(torch.as_tensor(m, dtype=torch.float32)
                                     * c + i) + 1.0
                for m, c, i in zip(param_dist_maps, coefs, intercepts)]
    maps = torch.as_tensor(param_dist_maps, dtype=torch.float32)
    c = torch.as_tensor(coefs, dtype=torch.float32,
                        device=maps.device).reshape(-1, 1, 1, 1)
    i = torch.as_tensor(intercepts, dtype=torch.float32,
                        device=maps.device).reshape(-1, 1, 1, 1)
    return -2.0 * torch.sigmoid(maps * c + i) + 1.0


def calibrate_min_area(gt_marks_list: List[np.ndarray], quantile: float = 0.01
                       ) -> Tuple[float, float]:
    """(q, 1-q) quantiles of GT rectangle areas (host numpy)."""
    areas = []
    for marks in gt_marks_list:
        marks = np.asarray(marks, np.float32)
        if len(marks):
            length = (2.0 * marks[:, 0]) / (1.0 + marks[:, 1])
            areas.append(length * (marks[:, 1] * length))
    areas = np.concatenate(areas) if areas else np.array([1.0])
    return (float(np.quantile(areas, quantile)),
            float(np.quantile(areas, 1.0 - quantile)))
