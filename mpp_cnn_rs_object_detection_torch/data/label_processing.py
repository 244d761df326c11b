"""CNN training targets on the host, and analytic rectangle rasterisation.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/label_processing.py``:
the host pipeline's ``PosLabelProcessor`` (pointing vectors to the nearest
center and a validity mask, modes ``uvec``, ``vec`` and ``dist``) and
``ShapeLabelProcessor`` (per-pixel mark classes and a loss mask, modes
``shapes`` and ``gaussian``, with optional ``class_perturbation``), both
over the nearest-center fields of a KD-tree query (the reference's EDT +
watershed with point seeds), and ``rect_mask``. The device pipeline's
batched painters (``data/device_pipeline.py``) break ties between
equidistant centers by argmin and have neither ``dist``, ``vec`` nor the
class perturbation; these are the host path's own targets.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from scipy.spatial import cKDTree

from mpp_cnn_rs_object_detection_torch.data.dataset import LabelProcessor
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    ValueMapping,
    values_to_class_id,
)


@functools.lru_cache(maxsize=8)
def _pixel_grid(h: int, w: int) -> np.ndarray:
    """The (h * w, 2) (row, col) coordinates, read-only."""
    grid = np.stack(np.mgrid[:h, :w], axis=-1).reshape(-1, 2)
    grid.setflags(write=False)
    return grid


def nearest_center_fields(shape_hw: Tuple[int, int], centers: np.ndarray):
    """Per-pixel (nearest-center index, distance to it); with no centers,
    index 0 and an infinite distance."""
    h, w = shape_hw
    if len(centers) == 0:
        return (np.zeros((h, w), dtype=np.int64),
                np.full((h, w), np.inf, dtype=np.float64))
    dist, idx = cKDTree(np.asarray(centers, dtype=np.float64)).query(
        _pixel_grid(h, w))
    return idx.reshape(h, w), dist.reshape(h, w)


def _center_bin_map(shape_hw, centers) -> np.ndarray:
    m = np.zeros(shape_hw, dtype=bool)
    for c in centers:
        if 0 <= c[0] < shape_hw[0] and 0 <= c[1] < shape_hw[1]:
            m[int(c[0]), int(c[1])] = True
        else:
            logging.info(f"point ({c}) out of bounds in patch of shape "
                         f"{shape_hw}")
    return m


def _finite_distance(distance: np.ndarray) -> np.ndarray:
    return np.where(np.isinf(distance), 1e6, distance).astype(np.float32)


@dataclass
class PosLabelProcessor(LabelProcessor):
    """PosNet targets: (unit) vectors to the nearest center where it lies
    within ``max_distance`` (or, with ``"auto"``, within the mean of the
    nearest object's a and b), the mask of those pixels, the center map
    and its gaussian dilation; ``dist`` mode paints distance blobs."""

    max_distance: Union[str, float]
    mode: str = "uvec"
    n_classes: Optional[int] = None
    sigma_dil: Optional[float] = None

    def process(self, patch, centers, params, idx, draws=None):
        shape_hw = patch.shape[:2]
        centers = np.asarray(centers).reshape(-1, 2)
        center_bin = _center_bin_map(shape_hw, centers)
        nearest_idx, distance = nearest_center_fields(shape_hw, centers)

        sigma_dil = 0.6 if self.sigma_dil is None else self.sigma_dil
        with np.errstate(over="ignore"):
            center_bin_dil = np.exp(-0.5 * np.square(
                np.where(np.isinf(distance), 1e6, distance) / sigma_dil))
        center_bin_dil[center_bin_dil < 1e-5] = 0

        if self.max_distance == "auto":
            if len(centers) > 0:
                a_map = np.asarray(params)[:, 0][nearest_idx]
                b_map = np.asarray(params)[:, 1][nearest_idx]
                size_map = (a_map + b_map) / 2
            else:
                size_map = np.zeros(shape_hw)
        else:
            size_map = None

        if self.mode in ("vec", "uvec"):
            if len(centers) == 0:
                pointy = np.zeros(shape_hw + (2,))
                mask = np.ones(shape_hw, dtype=bool)
            else:
                coor = np.stack(np.mgrid[:shape_hw[0], :shape_hw[1]], axis=-1)
                pointy = centers[nearest_idx] - coor
                norm = np.linalg.norm(pointy, axis=-1) + 1e-8
                if self.mode == "uvec":
                    pointy = pointy / norm[..., None]
                    pointy[np.isnan(pointy)] = 0
                mask = norm > (size_map if size_map is not None
                               else self.max_distance)
            pointy = np.where(mask[..., None], 0.0, pointy)
            label = {
                "pointing_map": pointy.astype(np.float32),
                "mask": (~mask).astype(np.float32),
                "center_binary_map": center_bin,
                "center_binary_map_dil": center_bin_dil.astype(np.float32),
                "distance_map": _finite_distance(distance),
            }
        elif self.mode == "dist":
            sigma = (size_map / 4) if size_map is not None \
                else self.max_distance / 2
            blob = np.exp(-0.5 * np.square(distance / np.maximum(sigma, 1e-8)))
            blob[blob < 1e-3] = 0
            label = {
                "blob_map": blob.astype(np.float32),
                "blob_map_class": (blob * (self.n_classes - 1)).astype(
                    np.int64),
                "center_binary_map": center_bin,
                "center_binary_map_dil": center_bin_dil.astype(np.float32),
                "distance_map": _finite_distance(distance),
            }
        else:
            raise ValueError(self.mode)
        return patch.astype(np.float32), label


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


@dataclass
class ShapeLabelProcessor(LabelProcessor):
    """ShapeNet targets: per-pixel (size, ratio, angle) class maps and a
    normalised loss mask. ``shapes`` paints each object's classes inside
    its rectangle; ``gaussian`` paints the nearest object's classes,
    weighted by a gaussian of the distance (sigma = size / 4 with
    ``mask_sigma="auto"``). ``class_perturbation`` ({offset:
    probability}) moves each object's class of each feature by an offset
    drawn from ``rng`` (``draw``), wrapping cyclic mappings and clipping
    the others."""

    mappings: List[ValueMapping]
    mask_mode: str = "shapes"
    mask_sigma: Union[None, float, str] = None
    mask_cutoff_dist: Optional[float] = None
    class_perturbation: Optional[Dict[int, float]] = None
    rng: Optional[np.random.Generator] = None

    def draw(self, n_points: int) -> Optional[List[List]]:
        """The class offsets of ``n_points`` objects, object-major."""
        if self.class_perturbation is None or n_points == 0:
            return None
        rng = self.rng if self.rng is not None else np.random.default_rng()
        offsets = list(self.class_perturbation.keys())
        probs = list(self.class_perturbation.values())
        return [[rng.choice(offsets, p=probs)
                 for _ in range(len(self.mappings))]
                for _ in range(n_points)]

    def process(self, patch, centers, params, idx, draws=None):
        shape_hw = patch.shape[:2]
        centers = np.asarray(centers).reshape(-1, 2)
        params = np.asarray(params).reshape(-1, 3)
        n_points = len(centers)
        n_feat = len(self.mappings)

        # (a, b, w) -> (size, ratio, angle) classes
        params_sra = [((a + b) / 2, a / b, w % np.pi) for a, b, w in params]
        classes = values_to_class_id(params_sra, self.mappings)
        classes = [np.atleast_1d(np.asarray(c)).astype(np.int64)
                   for c in classes]

        if self.class_perturbation is not None and n_points > 0:
            if draws is None:
                draws = self.draw(n_points)
            for k in range(n_points):
                for i in range(n_feat):
                    c = classes[i][k] + draws[k][i]
                    m = self.mappings[i]
                    classes[i][k] = (c % m.n_classes if m.is_cyclic
                                     else int(np.clip(c, 0, m.n_classes - 1)))

        center_bin = _center_bin_map(shape_hw, centers)
        nearest_idx, distance = nearest_center_fields(shape_hw, centers)

        if self.mask_mode == "gaussian":
            value_class_map = [
                (classes[i][nearest_idx] if n_points > 0
                 else np.zeros(shape_hw, int)) for i in range(n_feat)]
            if n_points > 0:
                size_map = self.mappings[0].class_to_value(value_class_map[0])
                if self.mask_sigma == "auto":
                    sigma = np.maximum(size_map / 4, 1e-8)
                    loss_mask = np.exp(-0.5 * np.square(distance / sigma))
                    loss_mask[loss_mask < 1e-3] = 0
                else:
                    loss_mask = np.exp(
                        -0.5 * np.square(distance / self.mask_sigma))
                    loss_mask[distance >= self.mask_cutoff_dist] = 0
                loss_mask = loss_mask / np.sum(loss_mask)
            else:
                loss_mask = np.zeros(shape_hw)
        elif self.mask_mode == "shapes":
            value_class_map = [np.zeros(shape_hw, dtype=np.int64)
                               for _ in range(n_feat)]
            loss_mask = np.zeros(shape_hw, dtype=np.float64)
            for k in range(n_points):
                a, b, w = params[k]
                # the window holds the whole rectangle: the same mask
                obj = rect_mask(shape_hw, centers[k], a, b, w,
                                window=int(np.ceil(np.hypot(a, b) / 2)) + 1)
                loss_mask += obj
                for i in range(n_feat):
                    value_class_map[i][obj] = classes[i][k]
            if n_points == 0 or np.sum(loss_mask) == 0:
                loss_mask = np.zeros(shape_hw)
            else:
                loss_mask = loss_mask / np.sum(loss_mask)
        else:
            raise ValueError(self.mask_mode)

        label = {
            "value_class_map": [v.astype(np.int32) for v in value_class_map],
            "center_binary_map": center_bin,
            "distance_map": _finite_distance(distance),
            "loss_mask": loss_mask.astype(np.float32),
        }
        return patch.astype(np.float32), label
