"""DOTA-devkit text-format writer for GT and detections.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/metrics/dota_writer.py``;
the formatting is the same, so identical inputs give byte-identical files.
The on-disk format is frozen (the devkit evaluator parses it):
``dota[postfix]/gt/NNNN.txt`` holds one GT per line — 8 integer coords +
category + difficulty — ``det/<class>.txt`` one detection per line —
image id, score, 8 float coords — and ``imageSet.txt`` the image ids.
Implementation is array-at-a-time: polygons are flipped/converted/formatted
as whole (N, 4, 2) batches rather than per-row string concatenation.
"""

from __future__ import annotations

import os
from typing import List, Union

import numpy as np

from mpp_cnn_rs_object_detection_torch.utils.files import make_if_not_exist


def polys_to_hbb(polys: np.ndarray) -> np.ndarray:
    """(N, 4, 2) polygons -> (N, 4, 2) axis-aligned corner rectangles
    (tl, tr, br, bl) — the devkit ``dots4ToRec4`` bound, batched."""
    lo = polys.min(axis=1)
    hi = polys.max(axis=1)
    return np.stack(
        [
            np.stack([lo[:, 0], lo[:, 1]], -1),
            np.stack([hi[:, 0], lo[:, 1]], -1),
            np.stack([hi[:, 0], hi[:, 1]], -1),
            np.stack([lo[:, 0], hi[:, 1]], -1),
        ],
        axis=1,
    )


def _coord_rows(polys: np.ndarray, fmt: str) -> List[str]:
    """Format each polygon's 8 coordinates as one space-joined string."""
    flat = polys.reshape(len(polys), 8)
    return [" ".join(fmt % v for v in row) for row in flat]


class DOTAResultsTranslator:
    """Accumulates per-image GT + detections, writes the devkit layout on
    ``save()``. ``flip_coor`` swaps (row, col) -> (x, y) to match the
    devkit's coordinate convention (reference behaviour preserved)."""

    def __init__(self, dataset: str, subset: str, results_dir: str, det_type: str,
                 all_classes: List[str], postfix: str = ""):
        assert det_type in ("obb", "hbb")
        self.det_type = det_type
        root = os.path.join(results_dir, "dota" + postfix)
        self.det_dir = os.path.join(root, "det")
        self.annot_dir = os.path.join(root, "gt")
        self.image_set_file = os.path.join(root, "imageSet.txt")
        self.image_set: List[str] = []
        self.det_lines_per_cat = {c: [] for c in all_classes}
        make_if_not_exist([self.det_dir, self.annot_dir], recursive=True)

    def add_gt(self, image_id: int, difficulty: Union[List, np.ndarray],
               polygons: np.ndarray, categories, flip_coor=True):
        self.image_set.append(f"{image_id:04}")
        polys = np.asarray(polygons, np.float64).reshape(-1, 4, 2)
        if flip_coor:
            polys = polys[..., ::-1]
        if self.det_type == "hbb":
            polys = polys_to_hbb(polys)
        # GT keeps one decimal, like the detections: the devkit evaluator
        # parses GT coords with float(), and integer truncation would cap
        # even GT echoed back as detections on ~5 px vehicles
        coords = _coord_rows(polys, "%.1f")
        lines = [
            f"{c} {cat} {int(bool(d))}"
            for c, cat, d in zip(coords, categories, difficulty)
        ]
        with open(os.path.join(self.annot_dir, f"{image_id:04}.txt"), "w") as f:
            f.write("\n".join(lines))

    def add_detections(self, image_id: int, scores, class_names,
                       polygons: np.ndarray = None, bbox=None, flip_coor=True):
        if polygons is not None:
            polys = np.asarray(polygons, np.float64).reshape(-1, 4, 2)
            if flip_coor:
                polys = polys[..., ::-1]
            coords = _coord_rows(polys, "%.1f")
        else:
            # [r1, c1, r2, c2] boxes -> "x1 y1 x2 y2"
            b = np.asarray(bbox, np.float64).reshape(-1, 4)
            if flip_coor:
                b = b[:, [1, 0, 3, 2]]
            coords = [" ".join("%.1f" % v for v in row) for row in b]
        for c, s, name in zip(coords, scores, class_names):
            self.det_lines_per_cat[name].append(f"{image_id:04} {s} {c}")

    def save(self):
        for class_name, det_lines in self.det_lines_per_cat.items():
            with open(os.path.join(self.det_dir, f"{class_name}.txt"), "w") as f:
                f.write("\n".join(det_lines))
        with open(self.image_set_file, "w") as f:
            f.write("\n".join(self.image_set))
