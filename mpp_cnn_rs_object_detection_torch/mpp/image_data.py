"""ImageWMaps: the CNN -> MPP data contract.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/image_data.py``
(``ImageWMaps``, ``labels_to_marks``, ``load_image_w_maps`` and
``crop_image_w_maps``; the tiled mode's splitting and merging are
``ROADMAP.md`` item 10). The maps may be numpy arrays or torch tensors;
exact-scene inference moves them to its device once.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mpp_cnn_rs_object_detection_torch.ops.mappings import ValueMapping
from mpp_cnn_rs_object_detection_torch.utils.config import (
    get_dataset_base_path,
    get_inference_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import load_results
from mpp_cnn_rs_object_detection_torch.utils.png import read_unit_image

PARAM_NAMES = ["size", "ratio", "angle"]


@dataclass
class ImageWMaps:
    image: Any                     # (H, W, 3)
    name: str
    shape: Tuple[int, int]
    detection_map: Any             # (H, W)
    param_dist_maps: Any           # 3 x (H, W, C), or stacked (3, H, W, C)
    mappings: List[ValueMapping]
    labels: Dict[str, np.ndarray]
    gt_centers: np.ndarray         # (N, 2)
    gt_marks: np.ndarray           # (N, 3) size/ratio/angle
    param_names: List[str] = field(default_factory=lambda: list(PARAM_NAMES))
    crop_data: Optional[Dict] = None


def labels_to_marks(labels: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """annotation dict -> (centers (N, 2), marks (N, 3)): (a, b, w) ->
    (size, ratio, angle)."""
    centers = np.asarray(labels["centers"], np.float32).reshape(-1, 2)
    params = np.asarray(labels["parameters"], np.float32).reshape(-1, 3)
    if len(params) == 0:
        return centers, np.zeros((0, 3), np.float32)
    a, b, w = params[:, 0], params[:, 1], params[:, 2]
    marks = np.stack([(a + b) / 2.0, a / b, w % np.pi], axis=-1)
    return centers, marks.astype(np.float32)


def load_image_w_maps(patch_id, dataset: str, subset: str, position_model,
                      shape_model: str) -> ImageWMaps:
    """Assemble an image's ImageWMaps from the PosNet/ShapeNet result
    pickles (either package's: ``utils/files.py:load_results``). A list of
    position models has its detection maps max-combined pixelwise."""
    patch_id = int(patch_id)
    base = os.path.join(get_dataset_base_path(), dataset, subset)
    image = read_unit_image(os.path.join(base, "images", f"{patch_id:04}.png"))
    with open(os.path.join(base, "annotations", f"{patch_id:04}.pkl"),
              "rb") as f:
        labels = pickle.load(f)

    pos_models = (position_model if isinstance(position_model, (list, tuple))
                  else [position_model])
    detection_map = None
    for pm in pos_models:
        m = load_results(os.path.join(get_inference_path(pm, dataset, subset),
                                      f"{patch_id:04}_results.pkl"))
        m = m["detection_map"]
        detection_map = m if detection_map is None else np.maximum(
            detection_map, m)
    shp = load_results(os.path.join(
        get_inference_path(shape_model, dataset, subset),
        f"{patch_id:04}_results.pkl"))
    param_dist_maps = [np.moveaxis(p[0], 0, -1) for p in shp["output"]]

    centers, marks = labels_to_marks(labels)
    return ImageWMaps(
        image=image, name=f"{patch_id:04}", shape=image.shape[:2],
        detection_map=detection_map, param_dist_maps=param_dist_maps,
        mappings=shp["mappings"], labels=labels, gt_centers=centers,
        gt_marks=marks,
    )


def crop_image_w_maps(data: ImageWMaps, tl_anchor: np.ndarray,
                      patch_size: int) -> ImageWMaps:
    """The ``patch_size`` crop at ``tl_anchor`` (views of the maps), with
    the labels whose centers fall inside it, in crop coordinates."""
    tl = np.asarray(tl_anchor, int)
    s = np.s_[tl[0]:tl[0] + patch_size, tl[1]:tl[1] + patch_size]
    image_crop = data.image[s]
    shape = image_crop.shape[:2]

    keep, new_centers = [], []
    centers = np.asarray(data.labels["centers"]).reshape(-1, 2)
    for j, c in enumerate(centers):
        nc = c - tl
        if np.all(nc >= 0) and np.all(nc < np.array(shape)):
            keep.append(j)
            new_centers.append(nc)
    keep = np.array(keep, int)

    def kept(key):
        a = np.asarray(data.labels[key])
        return a[keep] if len(a.shape) else np.array([])

    labels = {
        "centers": np.array(new_centers).reshape(-1, 2),
        "parameters": np.asarray(data.labels["parameters"]).reshape(-1, 3)[
            keep],
        "categories": kept("categories"),
        "difficult": kept("difficult"),
    }
    centers2, marks2 = labels_to_marks(labels)
    return ImageWMaps(
        image=image_crop, name=data.name, shape=shape,
        detection_map=data.detection_map[s],
        param_dist_maps=[p[s] for p in data.param_dist_maps],
        mappings=data.mappings, labels=labels, gt_centers=centers2,
        gt_marks=marks2, crop_data={"tl_anchor": tl},
    )
