"""Greedy center-distance NMS (host-side numpy + scipy's cKDTree).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/ops/nms.py:nms_distance``:
keep the highest-score center, drop every other center within
``threshold`` (inclusive), repeat.
"""

from __future__ import annotations

import numpy as np


def nms_distance(centers, confidence_score, threshold, return_index=False):
    if len(centers) == 0:
        return ([], [], []) if return_index else ([], [])

    from scipy.spatial import cKDTree

    centers = np.asarray(centers)
    score = np.asarray(confidence_score, dtype=np.float64)
    tree = cKDTree(centers.astype(np.float64))
    order = np.argsort(-score, kind="stable")
    suppressed = np.zeros(len(centers), dtype=bool)
    picked_centers, picked_score, picked_index = [], [], []
    for index in order:
        if suppressed[index]:
            continue
        picked_index.append(int(index))
        picked_centers.append(centers[index])
        picked_score.append(confidence_score[index])
        for j in tree.query_ball_point(centers[index], r=threshold):
            suppressed[j] = True
    if return_index:
        return picked_centers, picked_score, picked_index
    return picked_centers, picked_score
