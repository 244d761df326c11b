"""Pixel-wise PR curves of detection maps vs dilated center labels.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/metrics/detection.py``
(host numpy and scipy): drives the detection threshold calibration of the
legacy energy setup. Vectorised over thresholds (one sort instead of a
Python loop per threshold).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Union

import numpy as np
from scipy.ndimage import binary_dilation


def precision_recall_curve_on_detection_map(
        detection_map: Union[np.ndarray, List[np.ndarray]],
        labels: Union[Dict, List[Dict]], num_thresholds: int = None,
        dilation: int = 1, thresholds: Iterable[float] = None):
    if thresholds is None:
        assert num_thresholds is not None
        thresholds = np.linspace(0, 1, num_thresholds)
    thresholds = np.asarray(list(thresholds))

    if not isinstance(detection_map, list):
        detection_map = [detection_map]
        labels = [labels]

    x, y = [], []
    for k in range(len(detection_map)):
        shape = detection_map[k].shape[:2]
        bin_label = np.zeros(shape, dtype=bool)
        centers = labels[k]["centers"]
        if len(centers) > 0:
            centers = np.asarray(centers)
            bin_label[centers[:, 0], centers[:, 1]] = True
            bin_label = binary_dilation(bin_label, iterations=dilation)
        x.append(detection_map[k].ravel())
        y.append(bin_label.ravel())

    x = np.concatenate(x, axis=0)
    y = np.concatenate(y, axis=0)

    precision, recall = compute_precision_recall(x, y, thresholds)
    precision = np.array(precision)
    recall = np.array(recall)
    with np.errstate(invalid="ignore", divide="ignore"):
        f1 = (precision * recall) / (precision + recall)
    return thresholds, {"precision": precision, "recall": recall, "f1": f1}


def compute_precision_recall(scores: np.ndarray, labels: np.ndarray,
                             thresholds: np.ndarray):
    """tp/fp counts at each threshold via one sort + cumulative sums."""
    order = np.argsort(scores, kind="stable")
    sorted_scores = scores[order]
    sorted_labels = labels[order].astype(np.int64)

    total_pos = int(np.sum(sorted_labels))
    n = len(sorted_scores)
    # suffix sums: number of (predicted-positive, true-positive) above a cut
    cum_labels = np.concatenate([[0], np.cumsum(sorted_labels)])

    precision, recall = [], []
    idx = np.searchsorted(sorted_scores, thresholds, side="right")
    for i in idx:
        pred_pos = n - i
        tp = total_pos - cum_labels[i]
        fp = pred_pos - tp
        precision.append(tp / (tp + fp) if (tp + fp) > 0 else np.nan)
        recall.append(tp / total_pos if total_pos > 0 else np.nan)
    return precision, recall
