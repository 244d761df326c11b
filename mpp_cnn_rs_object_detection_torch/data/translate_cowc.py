"""COWC car dataset -> the dataset layout the port reads (centers only,
fixed 4 x 4 marks).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/translate_cowc.py``
without PIL: each image ``X.png`` comes with ``X_Annotated_Cars.png``,
whose non-zero pixels are car centers. Images are rescaled from 0.15 m/px
to the target GSD with Pillow's bilinear reduction written out
(``data/image_ops.py:resize_bilinear_u8``, band by band), centers are
scaled along, and every car gets the parameters (4, 4, 0). Images are read
with ``utils/png.py:read_png`` (what Pillow reads) and written with
``write_png``. A gray + alpha image is resampled as Pillow resamples it,
with premultiplied alpha (``resize_la_u8``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import re
from typing import Dict

import numpy as np

from mpp_cnn_rs_object_detection_torch.data.image_ops import (
    resize_bilinear_u8,
)
from mpp_cnn_rs_object_detection_torch.utils.config import (
    get_dataset_base_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    NumpyEncoder,
    find_existing_path,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import read_png, write_png

COWC_GSD = 0.15


def fetch_cowc_paths(data_path: str):
    """(image, annotation) file pairs: ``X.png`` + ``X_Annotated_Cars.png``."""
    png_files = sorted(glob.glob(os.path.join(data_path, "*", "*.png")))
    ann_re = re.compile(r"(.*)_Annotated_Cars\.png")
    skip_re = re.compile(r"(.*)_Annotated_(Cars|Negatives)\.png")
    annotations = [s for s in png_files if ann_re.match(s)]
    images = [s for s in png_files if not skip_re.match(s)]
    assert len(images) == len(annotations), (len(images), len(annotations))
    return list(zip(images, annotations))


def resize_la_u8(img: np.ndarray, size) -> np.ndarray:
    """Pillow's bilinear ``resize`` of an (H, W, 2) uint8 gray + alpha
    (``LA``) image: converted to premultiplied ``La`` (``L * A / 255``
    rounded as Pillow's ``MULDIV255``), each band resized, then converted
    back (``255 * L // A``, clipped; 0 where A is 0)."""
    gray, alpha = img[..., 0].astype(np.int64), img[..., 1]
    tmp = gray * alpha + 128
    pre = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)
    gray_r = resize_bilinear_u8(pre, size).astype(np.int64)
    alpha_r = resize_bilinear_u8(alpha, size).astype(np.int64)
    gray_r = np.where(alpha_r == 0, 0, np.clip(
        255 * gray_r // np.maximum(alpha_r, 1), 0, 255))
    return np.stack([gray_r, alpha_r], axis=-1).astype(np.uint8)


def _prepare_one(image_id: int, path_image: str, path_label: str,
                 save_folder: str, scale: float) -> Dict:
    image = read_png(path_image).astype(np.float32)[..., :3]
    if image.max() > 1.0:
        image = image / 255.0
    annot = read_png(path_label)
    centers = np.array(np.where(np.any(annot > 0, axis=-1))).T

    h, w = image.shape[:2]
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    resize = (resize_la_u8 if image.ndim == 3 and image.shape[2] == 2
              else resize_bilinear_u8)
    image_r = resize((image * 255).astype(np.uint8),
                     (nw, nh)).astype(np.float32) / 255.0
    centers = (centers * scale).astype(int)

    parameters = np.array([[4.0, 4.0, 0.0]] * len(centers)).reshape(-1, 3)
    categories = np.array(["vehicle"] * len(centers))
    difficult = np.zeros(len(centers), dtype=bool)

    write_png(os.path.join(save_folder, "images", f"{image_id:04}.png"),
              (image_r * 255).astype(np.uint8))
    with open(os.path.join(save_folder, "annotations",
                           f"{image_id:04}.pkl"), "wb") as f:
        pickle.dump({"centers": centers, "parameters": parameters,
                     "categories": categories, "difficult": difficult}, f)
    meta = {
        "source_image": path_image,
        "original_gsd": COWC_GSD,
        "scale": scale,
        "shape": list(image_r.shape),
        "n_objects": int(len(centers)),
    }
    with open(os.path.join(save_folder, "metadata",
                           f"{image_id:04}.json"), "w") as f:
        json.dump(meta, f, cls=NumpyEncoder, indent=1)
    return meta


def translate_cowc(config: Dict) -> Dict[str, int]:
    """config keys: ``cowc_path`` (raw data candidates; the reference's
    ``cowc_base_path`` / ``name`` spellings too), ``dataset_name``,
    ``target_gsd`` (default 0.5), ``val_fraction`` (default 0.25),
    ``seed`` (default 0). Returns the images written per subset."""
    path_cfg = config.get("cowc_path", config.get("cowc_base_path"))
    raw = find_existing_path(
        path_cfg if isinstance(path_cfg, list) else [path_cfg])
    name = config.get("dataset_name", config.get("name", "COWC_gsd50"))
    scale = COWC_GSD / config.get("target_gsd", 0.5)

    pairs = fetch_cowc_paths(raw)
    order = np.random.default_rng(config.get("seed", 0)).permutation(
        len(pairs))
    n_val = max(1, int(len(pairs) * config.get("val_fraction", 0.25)))
    subsets = {"val": order[:n_val], "train": order[n_val:]}

    base = get_dataset_base_path()
    for subset, idx in subsets.items():
        folder = os.path.join(base, name, subset)
        make_if_not_exist([os.path.join(folder, d) for d in
                           ["images", "annotations", "metadata"]],
                          recursive=True)
        for local_id, i in enumerate(idx):
            meta = _prepare_one(local_id, pairs[i][0], pairs[i][1], folder,
                                scale)
            logging.info(f"[{name}/{subset}] {local_id:04}: "
                         f"{meta['n_objects']} cars")
    logging.info(f"COWC translated to {os.path.join(base, name)}")
    return {subset: len(idx) for subset, idx in subsets.items()}
