"""ImageWMaps: the CNN -> MPP data contract.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/image_data.py``
(``ImageWMaps``, ``labels_to_marks``, ``load_image_w_maps``,
``crop_image_w_maps``, and the tiled mode's ``split_image`` and
``merge_patch_results``). The maps may be numpy arrays or torch tensors;
scene inference moves them to its device once, and crops are views.
"""

from __future__ import annotations

import logging
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mpp_cnn_rs_object_detection_torch.ops.mappings import ValueMapping
from mpp_cnn_rs_object_detection_torch.ops.nms import nms_distance
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
    the labels whose centers fall inside it, in crop coordinates (none for
    an unlabelled image)."""
    tl = np.asarray(tl_anchor, int)
    s = np.s_[tl[0]:tl[0] + patch_size, tl[1]:tl[1] + patch_size]
    image_crop = data.image[s]
    shape = image_crop.shape[:2]

    keep, new_centers = [], []
    centers = np.asarray(data.labels.get("centers", ())).reshape(-1, 2)
    for j, c in enumerate(centers):
        nc = c - tl
        if np.all(nc >= 0) and np.all(nc < np.array(shape)):
            keep.append(j)
            new_centers.append(nc)
    keep = np.array(keep, int)

    def kept(key):
        a = np.asarray(data.labels.get(key, ()))
        return a[keep] if len(a.shape) else np.array([])

    labels = {
        "centers": np.array(new_centers).reshape(-1, 2),
        "parameters": np.asarray(data.labels.get("parameters", ())).reshape(
            -1, 3)[keep],
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


def split_image(data: ImageWMaps, target_size: int, min_overlap: int
                ) -> List[ImageWMaps]:
    """Overlapping ``target_size`` tiles covering the image, anchored on a
    linspace grid (every tile has the same shape, so the tiles stack as
    the lanes of one chain); a tile-sized image is its own single tile."""
    shape = data.image.shape[:2]
    n_x = int(np.ceil(shape[0] / (target_size - min_overlap)))
    n_y = int(np.ceil(shape[1] / (target_size - min_overlap)))
    if (n_x <= 1 and n_y <= 1 and shape[0] == target_size
            and shape[1] == target_size):
        if data.crop_data is None:
            data.crop_data = {"tl_anchor": np.zeros(2, int)}
        return [data]
    x_anchors = np.linspace(0, max(shape[0] - target_size, 0),
                            num=max(n_x, 1), dtype=int)
    y_anchors = np.linspace(0, max(shape[1] - target_size, 0),
                            num=max(n_y, 1), dtype=int)
    patches = []
    for x in x_anchors:
        for y in y_anchors:
            p = crop_image_w_maps(data, np.array([x, y]), target_size)
            p.name = data.name + f"_p{x:04}-{y:04}"
            patches.append(p)
    logging.info(f"split image {data.name} {tuple(shape)} into "
                 f"{len(patches)} {target_size}px patches")
    return patches


def merge_patch_results(patch_list: List[ImageWMaps], centers_list,
                        marks_list, scores_list, distance: float = 3.0):
    """Per-tile detections offset to scene coordinates, then deduplicated
    within ``distance`` px keeping the higher score (the overlaps see the
    same objects twice). Returns (centers, marks, scores)."""
    all_c, all_m, all_s = [], [], []
    for patch, c, m, sc in zip(patch_list, centers_list, marks_list,
                               scores_list):
        if len(c) == 0:
            continue
        anchor = patch.crop_data["tl_anchor"]
        all_c.append(np.asarray(c) + np.asarray(anchor)[None])
        all_m.append(np.asarray(m))
        all_s.append(np.asarray(sc))
    if not all_c:
        return np.zeros((0, 2)), np.zeros((0, 3)), np.zeros((0,))
    centers = np.concatenate(all_c)
    marks = np.concatenate(all_m)
    scores = np.concatenate(all_s)
    _, _, keep = nms_distance(centers, scores, threshold=distance,
                              return_index=True)
    return centers[keep], marks[keep], scores[keep]
