"""Synthetic scenes and datasets made with numpy from a seed.

``synthetic_scene``: a textured gray background with small dark or bright
oriented rectangles that do not overlap; the image and its ground truth stay
in memory.

``make_synth`` / ``make_synth_dataset``: counterparts of
``mpp_cnn_rs_object_detection_tpu/data/synth.py``. The same seed draws the
same rectangles and paints the same image, and the dataset is written in the
standard layout (``images/NNNN.png``, ``annotations/NNNN.pkl``,
``metadata/NNNN.json`` per subset) with the port's PNG codec. The polygons
are float32, so an annotation's ``parameters`` agree with the JAX
package's to float32 rounding of the trigonometry.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Tuple

import numpy as np
import torch
from numpy.random import Generator

from mpp_cnn_rs_object_detection_torch.data.label_processing import rect_mask
from mpp_cnn_rs_object_detection_torch.ops.geometry import (
    convex_quad_intersection_area,
    marks_to_poly,
    polygon_to_abw,
    sra_to_wla,
)
from mpp_cnn_rs_object_detection_torch.utils.config import (
    get_dataset_base_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    NumpyEncoder,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import write_png


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


def _poly(c: dict) -> np.ndarray:
    """The candidate's float32 polygon (``marks_to_poly``)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return marks_to_poly(f32([c["x"], c["y"]]), f32(c["size"]),
                         f32(c["ratio"]), f32(c["angle"])).numpy()


def make_synth(rng: Generator, shape: Tuple[int, int], n_rect: int,
               noise: float):
    """Random non-overlapping rectangles painted on a noisy gray background.

    Returns (image (H, W, 3) float, list of candidate dicts with x, y, size,
    ratio and angle, their (4, 2) polygons)."""
    shape = tuple(int(s) for s in shape)
    cand = [
        dict(
            x=int(rng.integers(0, shape[0])),
            y=int(rng.integers(0, shape[1])),
            size=float(rng.normal(8, 1.0)),
            ratio=float(np.clip(rng.normal(0.5, 0.1), 0.1, 1)),
            angle=float(rng.uniform(0, np.pi)),
        )
        for _ in range(n_rect)
    ]
    valid: List[dict] = []
    valid_polys: List[np.ndarray] = []
    for c in cand:
        p = _poly(c)
        if valid_polys:
            inter = convex_quad_intersection_area(
                torch.from_numpy(p)[None],
                torch.from_numpy(np.stack(valid_polys)))
            if bool((inter != 0).any()):
                continue
        valid.append(c)
        valid_polys.append(p)

    image = np.ones(shape + (3,)) * 0.5
    for c in valid:
        a, b, _ = sra_to_wla(c["size"], c["ratio"], c["angle"])
        # poly_coord quirk: drawn rect uses (length, width, angle + pi/2)
        mask = rect_mask(shape, (c["x"], c["y"]), b, a, c["angle"] + np.pi / 2,
                         window=int(np.ceil(np.hypot(a, b) / 2)) + 1)
        image[mask] = rng.choice([0, 1.0]) + rng.normal(0, 0.1)
    image = np.clip(image, 0, 1)
    image = np.clip(image + rng.normal(0, noise, size=image.shape), 0, 1)
    return image, valid, valid_polys


def make_synth_dataset(name: str = "synth_01", n_items: int = 32,
                       shape: Tuple[int, int] = (256, 256), n_rect: int = 230,
                       noise: float = 0.02, seed: int = 0,
                       base_dir: str = None) -> str:
    dest_base = base_dir if base_dir is not None else get_dataset_base_path()
    save_dir = os.path.join(dest_base, name)
    make_if_not_exist(save_dir, recursive=True)

    rng = np.random.default_rng(seed)
    for ss in ["train", "val"]:
        subset_dir = os.path.join(save_dir, ss)
        make_if_not_exist(subset_dir)
        make_if_not_exist([os.path.join(subset_dir, s)
                           for s in ["images", "annotations", "metadata"]])
        for image_id in range(n_items):
            image, rects, polys = make_synth(rng, shape, n_rect, noise=noise)
            centers = np.array([[r["x"], r["y"]] for r in rects])
            parameters = np.array([polygon_to_abw(p) for p in polys])
            categories = np.array(["vehicle"] * len(rects))
            difficult = np.array([False] * len(rects))

            write_png(os.path.join(subset_dir, "images", f"{image_id:04}.png"),
                      (image * 255).astype(np.uint8))
            with open(os.path.join(subset_dir, "annotations",
                                   f"{image_id:04}.pkl"), "wb") as f:
                pickle.dump(
                    {
                        "centers": centers,
                        "parameters": parameters,
                        "categories": categories,
                        "difficult": difficult,
                    },
                    f,
                )
            with open(os.path.join(subset_dir, "metadata",
                                   f"{image_id:04}.json"), "w") as f:
                json.dump(
                    {"shape": list(image.shape), "n_objects": len(rects)},
                    f, cls=NumpyEncoder, indent=1,
                )
    return save_dir
