"""Rotated-polygon IoU of the evaluator: ctypes binding to the C++ module.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/metrics/polyiou.py``'s
``poly_iou_batch``, the function the evaluator calls, and
``poly_iou_matrix``, the rotated NMS of BBAVectors' inference. The
library is built from ``native/polyiou.cpp`` with ``g++`` on first use
(``native.load``); a failed build raises, it is never replaced silently.
The numpy Sutherland-Hodgman functions below are the module's plain
version, used by the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mpp_cnn_rs_object_detection_torch import native

_LIB = None


def _get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib, _ = native.load("polyiou")
        dbl_p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.poly_iou_batch.restype = None
        lib.poly_iou_batch.argtypes = [dbl_p, dbl_p, ctypes.c_int, dbl_p]
        lib.poly_iou_matrix.restype = None
        lib.poly_iou_matrix.argtypes = [dbl_p, ctypes.c_int, dbl_p,
                                        ctypes.c_int, dbl_p]
        _LIB = lib
    return _LIB


def _as_flat8(poly) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(poly, dtype=np.float64).reshape(-1))
    assert arr.shape == (8,), f"expected 4 xy points, got shape {np.shape(poly)}"
    return arr


def _as_rows8(polys) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(polys, dtype=np.float64).reshape(-1, 8))


def poly_iou_batch(det, gts) -> np.ndarray:
    """IoU of one det polygon vs (N, 4, 2) (or (N, 8)) gt polygons."""
    gts = _as_rows8(gts)
    out = np.zeros(len(gts), dtype=np.float64)
    if len(gts):
        _get_lib().poly_iou_batch(_as_flat8(det), gts, len(gts), out)
    return out


def poly_iou_matrix(dets, gts) -> np.ndarray:
    """(N, M) IoU matrix between (N, 4, 2) and (M, 4, 2) polygon sets."""
    dets, gts = _as_rows8(dets), _as_rows8(gts)
    out = np.zeros((len(dets), len(gts)), dtype=np.float64)
    if len(dets) and len(gts):
        _get_lib().poly_iou_matrix(dets, len(dets), gts, len(gts), out)
    return out


# --- plain version (numpy Sutherland-Hodgman) -------------------------------


def _np_clip_halfplane(poly: np.ndarray, e0, e1, orient: float) -> np.ndarray:
    out = []
    for i in range(len(poly)):
        cur, prev = poly[i], poly[i - 1]
        c_cur = orient * ((e1[0] - e0[0]) * (cur[1] - e0[1])
                          - (e1[1] - e0[1]) * (cur[0] - e0[0]))
        c_prev = orient * ((e1[0] - e0[0]) * (prev[1] - e0[1])
                           - (e1[1] - e0[1]) * (prev[0] - e0[0]))
        inside_cur = c_cur >= -1e-12
        inside_prev = c_prev >= -1e-12
        if inside_cur != inside_prev:
            denom = c_prev - c_cur
            if abs(denom) > 1e-300:
                out.append(prev + c_prev / denom * (cur - prev))
        if inside_cur:
            out.append(cur)
    return np.array(out) if out else np.zeros((0, 2))


def _np_signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def poly_intersection_plain(p, q) -> float:
    p, q = _as_flat8(p).reshape(4, 2), _as_flat8(q).reshape(4, 2)
    orient = 1.0 if _np_signed_area(q) >= 0 else -1.0
    cur = p
    for e in range(len(q)):
        if len(cur) == 0:
            return 0.0
        cur = _np_clip_halfplane(cur, q[e], q[(e + 1) % len(q)], orient)
    if len(cur) < 3:
        return 0.0
    return abs(_np_signed_area(cur))


def poly_iou_plain(p, q) -> float:
    inter = poly_intersection_plain(p, q)
    union = (abs(_np_signed_area(_as_flat8(p).reshape(4, 2)))
             + abs(_np_signed_area(_as_flat8(q).reshape(4, 2))) - inter)
    return inter / union if union > 0 else 0.0
