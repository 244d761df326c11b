"""Energy-term calibration from GT (thresholds, remaps, area quantiles).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/calibration.py``. The
fits are host numpy: with the same ``np.random.Generator`` state they give
the JAX package's numbers. The 1-D logistic fit is a small IRLS (Newton)
solver, as there; the remap runs on the maps' device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.metrics.detection import (
    precision_recall_curve_on_detection_map,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import ValueMapping


def f_beta(p: float, r: float, beta: float) -> float:
    div = (beta ** 2 * p) + r
    return (1 + beta ** 2) * p * r / div if div > 0 else 0.0


def calibrate_detection_threshold(detection_maps: List[np.ndarray],
                                  labels: List[Dict], target: str = "f1"
                                  ) -> float:
    """Threshold at the max F-score of the pixelwise detection-map PR
    sweep."""
    target = target or "f1"
    thresh, metrics = precision_recall_curve_on_detection_map(
        detection_map=[np.asarray(d) for d in detection_maps], labels=labels,
        num_thresholds=100, dilation=2)
    beta = {"f1": 1.0, "f2": 2.0, "f0.5": 0.5}[target]
    scores = [f_beta(p, r, beta) for p, r in zip(
        np.nan_to_num(metrics["precision"]), np.nan_to_num(metrics["recall"]))]
    return float(thresh[int(np.argmax(scores))])


def _logistic_fit_1d(x: np.ndarray, y: np.ndarray, n_iter: int = 100
                     ) -> Tuple[float, float]:
    """Unpenalised 1-D logistic regression with balanced class weights via
    IRLS (sklearn's ``LogisticRegression(penalty='none',
    class_weight='balanced')`` on separable-ish calibration data)."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    n = len(y)
    n_pos, n_neg = max(y.sum(), 1), max(n - y.sum(), 1)
    sw = np.where(y > 0.5, n / (2 * n_pos), n / (2 * n_neg))
    w, b = 0.0, 0.0
    for _ in range(n_iter):
        z = w * x + b
        p = 1.0 / (1.0 + np.exp(-z))
        g_w = np.sum(sw * (p - y) * x)
        g_b = np.sum(sw * (p - y))
        r = np.maximum(sw * p * (1 - p), 1e-9)
        h_ww = np.sum(r * x * x) + 1e-9
        h_wb = np.sum(r * x)
        h_bb = np.sum(r) + 1e-9
        det = h_ww * h_bb - h_wb ** 2
        if abs(det) < 1e-12:
            break
        dw = (h_bb * g_w - h_wb * g_b) / det
        db = (h_ww * g_b - h_wb * g_w) / det
        # cap the Newton step: on separable data weights diverge; stop there
        step = np.hypot(dw, db)
        if step > 50:
            dw, db = dw / step * 50, db / step * 50
        w, b = w - dw, b - db
        if step < 1e-10 or abs(w) > 1e3:
            break
    return float(w), float(b)


def generate_wrong_value(gt_class: int, mapping: ValueMapping,
                         min_offset: int, rng: np.random.Generator) -> int:
    """A wrong class id at least ``min_offset`` bins away."""
    possible = set(range(mapping.n_classes)) - {gt_class}
    for v in range(1, min_offset):
        for o in (v, -v):
            c = gt_class + o
            if mapping.is_cyclic:
                c = c % mapping.n_classes
            possible -= {c}
    return int(rng.choice(sorted(possible)))


def calibrate_param_dists(param_dist_maps: List[List[np.ndarray]],
                          gt_centers: List[np.ndarray],
                          gt_marks: List[np.ndarray],
                          mappings: List[ValueMapping],
                          rng: np.random.Generator):
    """Per-mark logistic remap of distribution values: positives are the GT
    class's probability at the GT pixel, negatives a wrong class's. Returns
    (coefs, intercepts) defining ``E = -2*sigmoid(coef*p + intercept) + 1``."""
    coefs, intercepts = [], []
    for i_p, mapping in enumerate(mappings):
        values, labels = [], []
        for k in range(len(param_dist_maps)):
            centers, marks = gt_centers[k], gt_marks[k]
            dmap = np.asarray(param_dist_maps[k][i_p])
            for c, m in zip(centers, marks):
                xi = int(np.clip(c[0], 0, dmap.shape[0] - 1))
                yi = int(np.clip(c[1], 0, dmap.shape[1] - 1))
                local = dmap[xi, yi]
                gt_cls = int(mapping.value_to_class(float(m[i_p])))
                values.append(local[gt_cls])
                labels.append(1)
                wrong = generate_wrong_value(gt_cls, mapping, 2, rng)
                values.append(local[wrong])
                labels.append(0)
        coef, intercept = _logistic_fit_1d(np.array(values), np.array(labels))
        coefs.append(coef)
        intercepts.append(intercept)
    return coefs, intercepts


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
