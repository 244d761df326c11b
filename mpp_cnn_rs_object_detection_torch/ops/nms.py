"""Greedy NMS on the host: IoU boxes (numpy) and center distance (numpy +
scipy's cKDTree).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/ops/nms.py``: ``nms``
keeps, in score order, every box that no box kept before it overlaps at
``threshold`` or more (Faster R-CNN's final NMS); ``nms_distance`` keeps
the highest-score center, drops every other center within ``threshold``
(inclusive), repeats.
"""

from __future__ import annotations

import numpy as np


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """All-pairs IoU of [x1, y1, x2, y2] boxes, inclusive-pixel convention
    (+1 on extents, as the devkit's voc_eval measures overlap)."""
    a = np.asarray(boxes_a, np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, np.float64).reshape(-1, 4)
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(hi - lo + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms(bounding_boxes, confidence_score, threshold, return_index=False):
    """Greedy IoU NMS over [x1, y1, x2, y2] boxes, highest score first
    (stable among equal scores): one IoU matrix, one sweep."""
    if len(bounding_boxes) == 0:
        return ([], [], []) if return_index else ([], [])
    score = np.asarray(confidence_score, dtype=np.float64)
    iou = iou_matrix(bounding_boxes, bounding_boxes)
    order = np.argsort(-score, kind="stable")
    kept = np.zeros(len(score), dtype=bool)
    for i in order:
        kept[i] = not np.any(iou[i, kept] >= threshold)
    picked_index = [int(i) for i in order if kept[i]]
    picked_boxes = [bounding_boxes[i] for i in picked_index]
    picked_score = [confidence_score[i] for i in picked_index]
    if return_index:
        return picked_boxes, picked_score, picked_index
    return picked_boxes, picked_score


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
