"""Workspaces of the PyTorch port's MPP tests: a directory with its own
``paths_config.json``, a synthetic dataset and oracle CNN result pickles
(Gaussian blobs at the GT centers, one-hot mark distributions at the
nearest GT mark, the mappings pickled by the JAX package), so both
packages' MPP models run without CNNs."""

import contextlib
import json
import os
import pickle
import shutil

import numpy as np

from mpp_cnn_rs_object_detection_tpu.mpp.image_data import labels_to_marks
from mpp_cnn_rs_object_detection_tpu.ops.mappings import default_mappings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS, SHAPE = "pos_oracle", "shape_oracle"


@contextlib.contextmanager
def inside(ws):
    old = os.getcwd()
    os.chdir(ws)
    try:
        yield
    finally:
        os.chdir(old)


def workspace(ws):
    """An empty workspace at ``ws`` (a pathlib.Path)."""
    (ws / "data").mkdir(parents=True)
    (ws / "models").mkdir()
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    return ws


def oracle_pickles(ws, dataset, subset, n_images, shape):
    """Oracle result pickles of ``n_images`` images of ``subset``."""
    mappings = default_mappings(n_classes=32, size_min=0.0, size_max=32.0)
    base = ws / "data" / dataset / subset
    inf = ws / "data" / "inference" / dataset / subset
    for name in (POS, SHAPE):
        (inf / name).mkdir(parents=True)
    gy, gx = np.mgrid[:shape[0], :shape[1]]
    for i in range(n_images):
        with open(base / "annotations" / f"{i:04}.pkl", "rb") as f:
            centers, marks = labels_to_marks(pickle.load(f))
        d2 = ((gy[..., None] - centers[:, 0]) ** 2
              + (gx[..., None] - centers[:, 1]) ** 2)
        det = np.exp(-d2.min(-1) / (2 * 1.5 ** 2)).astype(np.float32)
        nearest = d2.argmin(-1)
        output = []
        for k, m in enumerate(mappings):
            cls = m.value_to_class(marks[nearest, k])
            output.append(np.moveaxis(np.eye(32, dtype=np.float32)[cls], -1,
                                      0)[None])
        with open(inf / POS / f"{i:04}_results.pkl", "wb") as f:
            pickle.dump({"detection_map": det}, f)
        with open(inf / SHAPE / f"{i:04}_results.pkl", "wb") as f:
            pickle.dump({"output": output, "mappings": mappings}, f)


def mpp_config(base, name, dataset, **dataset_kw):
    """``model_configs/mpp/<base>.json`` named ``name`` on the oracle
    models of ``dataset``."""
    with open(os.path.join(ROOT, "model_configs", "mpp",
                           base + ".json")) as f:
        cfg = json.load(f)
    cfg["model_name"] = name
    cfg["dataset"].update(dataset=dataset, position_model=[POS],
                          shape_model=SHAPE, **dataset_kw)
    return cfg


def copy_dataset(src_ws, dst_ws, dataset):
    shutil.copytree(src_ws / "data" / dataset, dst_ws / "data" / dataset)
