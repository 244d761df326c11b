"""Synthetic vehicle-like scenes made with numpy from a seed.

A textured gray background with small dark or bright oriented rectangles
(size ~8 px, ratio ~0.5, any angle) that do not overlap, in the spirit of
``mpp_cnn_rs_object_detection_tpu/data/synth.py`` but without PIL or files:
the image and its ground truth stay in memory.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_scene(h: int, w: int, n_objects: int, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (image (h, w, 3) float32 in [0, 1], centers (N, 2), marks (N, 3)
    as (size, ratio, angle))."""
    rng = np.random.default_rng(seed)
    base = 0.45 + 0.1 * rng.uniform(size=3)
    noise = rng.normal(0.0, 0.03, (h, w, 3))
    image = (base + noise).astype(np.float32)
    taken = np.zeros((h, w), bool)
    centers, marks = [], []
    for _ in range(n_objects * 4):
        if len(centers) == n_objects:
            break
        size = float(np.clip(rng.normal(8.0, 1.0), 5.0, 12.0))
        ratio = float(np.clip(rng.normal(0.5, 0.1), 0.25, 0.9))
        angle = float(rng.uniform(0.0, np.pi))
        cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        length = 2.0 * size / (1.0 + ratio)
        width = ratio * length
        r = int(np.ceil(length)) + 1
        y0, y1 = max(0, int(cy) - r), min(h, int(cy) + r + 1)
        x0, x1 = max(0, int(cx) - r), min(w, int(cx) + r + 1)
        gy, gx = np.mgrid[y0:y1, x0:x1]
        dy, dx = gy - cy, gx - cx
        # long side along (cos, sin) of the reference's angle + pi/2 quirk
        a = angle + np.pi / 2
        u = dy * np.cos(a) + dx * np.sin(a)
        v = -dy * np.sin(a) + dx * np.cos(a)
        inside = (np.abs(u) <= width / 2) & (np.abs(v) <= length / 2)
        if not inside.any() or taken[y0:y1, x0:x1][inside].any():
            continue
        taken[y0:y1, x0:x1] |= inside
        color = rng.uniform(0.05, 0.25) if rng.uniform() < 0.5 else \
            rng.uniform(0.75, 0.95)
        patch = image[y0:y1, x0:x1]
        patch[inside] = color + rng.normal(0.0, 0.02, (int(inside.sum()), 3))
        centers.append((cy, cx))
        marks.append((size, ratio, angle))
    return (np.clip(image, 0.0, 1.0),
            np.asarray(centers, np.float32).reshape(-1, 2),
            np.asarray(marks, np.float32).reshape(-1, 3))
