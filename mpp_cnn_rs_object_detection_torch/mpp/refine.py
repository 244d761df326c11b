"""Sub-pixel detection refinement against the CNN detection map.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/refine.py`` (numpy,
host side): the chain's equilibrium position wanders about a pixel around
the detection-map blob, so each final detection can snap to its local blob
centroid (``inference.refine_centers``; an extension the reference does not
have).
"""

from __future__ import annotations

import numpy as np


def snap_centers_to_map(centers: np.ndarray, detection_map: np.ndarray,
                        radius: int = 3, max_shift: float = 2.0,
                        rel_floor: float = 0.5) -> np.ndarray:
    """Move each (row, col) center to the centroid of its local map blob.

    The blob is the set of pixels within ``radius`` whose value exceeds
    ``rel_floor`` x the local max; the shift is capped at ``max_shift`` px so
    a detection can never jump to a different object. Centers whose window
    has no response are left untouched.
    """
    if len(centers) == 0:
        return centers
    out = np.asarray(centers, np.float32).copy()
    h, w = detection_map.shape
    for n, (cy, cx) in enumerate(np.asarray(centers, np.float32)):
        i, j = int(round(cy)), int(round(cx))
        i0, i1 = max(0, i - radius), min(h, i + radius + 1)
        j0, j1 = max(0, j - radius), min(w, j + radius + 1)
        win = detection_map[i0:i1, j0:j1]
        peak = win.max() if win.size else 0.0
        if peak <= 1e-6:
            continue
        wts = np.where(win > rel_floor * peak, win, 0.0)
        tot = wts.sum()
        if tot <= 1e-12:
            continue
        ys, xs = np.mgrid[i0:i1, j0:j1]
        ny = float((wts * ys).sum() / tot)
        nx = float((wts * xs).sum() / tot)
        dy, dx = ny - cy, nx - cx
        norm = float(np.hypot(dy, dx))
        if norm > max_shift:
            dy, dx = dy * max_shift / norm, dx * max_shift / norm
        out[n, 0] = cy + dy
        out[n, 1] = cx + dx
    return out
