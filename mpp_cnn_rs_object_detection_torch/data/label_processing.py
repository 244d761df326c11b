"""Analytic rectangle rasterisation.

Counterpart of ``rect_mask`` in
``mpp_cnn_rs_object_detection_tpu/data/label_processing.py``. The CNN
training targets of the device pipeline are ``data/device_pipeline.py``'s;
the host label processors (EDT and watershed targets) belong to the host
pipeline, which is not ported (``ROADMAP.md`` item 12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rect_mask(shape_hw: Tuple[int, int], center, a: float, b: float,
              angle: float, window: Optional[int] = None) -> np.ndarray:
    """Boolean mask of pixels inside the rectangle built by
    ``rect_to_poly(center, short=a, long=b, angle)`` (analytic
    point-in-rect). With ``window``, only pixels within that many rows and
    columns of the center are tested (the rest are False): the same mask
    when the rectangle fits in the window, without a pass over the image."""
    h, w = shape_hw
    mask = np.zeros((h, w), bool)
    if window is None:
        r0, r1, c0, c1 = 0, h, 0, w
    else:
        r0 = min(h, max(0, int(np.floor(center[0])) - window))
        r1 = max(r0, min(h, int(np.ceil(center[0])) + window + 1))
        c0 = min(w, max(0, int(np.floor(center[1])) - window))
        c1 = max(c0, min(w, int(np.ceil(center[1])) + window + 1))
    gy, gx = np.mgrid[r0:r1, c0:c1]
    dy = gy - center[0]
    dx = gx - center[1]
    # rotate into the rectangle frame: R(angle)^T . (p - c)
    cos, sin = np.cos(angle), np.sin(angle)
    local_u = cos * dy + sin * dx
    local_v = -sin * dy + cos * dx
    mask[r0:r1, c0:c1] = (np.abs(local_u) <= a / 2) & (np.abs(local_v) <= b / 2)
    return mask
