"""Dataset files: images and annotation pickles.

Counterpart of ``load_image`` and ``load_annotation`` in
``mpp_cnn_rs_object_detection_tpu/data/dataset.py``, the part the
device-resident CNN training path reads (``data/device_pipeline.py``). The
host pipeline's ``ImageDataset``, ``PatchDataset`` and ``BatchLoader`` are
not ported (``ROADMAP.md`` item 12).

Dataset-on-disk format: ``<root>/<dataset>/<subset>/{images/NNNN.png,
annotations/NNNN.pkl, metadata/NNNN.json}``; an annotation holds
``centers (N, 2), parameters (N, 3) (a, b, angle), categories,
difficult``.
"""

from __future__ import annotations

import pickle

import numpy as np

from mpp_cnn_rs_object_detection_torch.utils.png import read_png


def load_image(path: str) -> np.ndarray:
    """PNG -> float32 RGB, divided by 255 only if its max exceeds 1 (the
    JAX package's rule: an image whose levels are all 0 or 1 stays as
    read)."""
    arr = read_png(path).astype(np.float32)
    if arr.max() > 1.0:
        arr = arr / 255.0
    return arr[..., :3]


def load_annotation(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
