"""Raw DOTA v2 -> the dataset layout the port reads.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/translate_dota.py``
without pandas, PIL or OpenCV: reads the DOTA images, their 8-coordinate
polygon label files and per-image meta files (date, source, GSD), keeps
the configured categories, GSDs and sources, rescales each image to the
target GSD, converts the polygons to (a, b, angle) with ``polygon_to_abw``
and writes ``images/NNNN.png``, ``annotations/NNNN.pkl`` and
``metadata/NNNN.json`` under ``<dataset_path>/<name>/<subset>``.

What the JAX package leaves to its libraries is written out:
  - label files are split on single spaces, and each column takes the type
    pandas' ``read_csv`` infers for it over the whole file: int64 when
    every value is an integer, float64 when every value is a number
    (missing ones NaN), strings otherwise;
  - ``pd.to_datetime`` of the meta date is written out for the forms DOTA
    uses ("2017-08-13", "2016/05/12", "" -> "NaT"; "None" -> None); any
    other string raises, naming it;
  - ``cv2.resize(INTER_AREA)`` is ``data/image_ops.py:resize_area``, equal
    to OpenCV at integer and fractional factors;
  - images are read with ``utils/png.py:read_png`` (8-bit non-interlaced
    gray, gray + alpha, RGB, RGBA; palette, 16-bit and interlaced raise)
    and written with ``write_png``;
  - ``df_paths_and_meta.pkl``, which nothing reads, holds a dict of the
    same columns in the same row order (lists of values) instead of a
    DataFrame; a missing date or source is None in it.

As in the JAX package, a gray image's ``image[..., :3]`` keeps its first
three columns (the reference slices the 2-D array's last axis).
"""

from __future__ import annotations

import datetime
import glob
import json
import logging
import math
import os
import pickle
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from mpp_cnn_rs_object_detection_torch.data.image_ops import resize_area
from mpp_cnn_rs_object_detection_torch.ops.geometry import polygon_to_abw
from mpp_cnn_rs_object_detection_torch.utils.config import (
    get_dataset_base_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    NumpyEncoder,
    find_existing_path,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import read_png, write_png

SCALE_ACCEPTABLE_DELTA = 1e-2

LABEL_COLUMNS = ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4", "category",
                 "difficult")
# pandas' default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?[0-9]+\Z")
_DATE = re.compile(r"([0-9]{4})([-/])([0-9]{1,2})\2([0-9]{1,2})\Z")


def _typed_column(values: List[Optional[str]]) -> np.ndarray:
    """One column as pandas types it: int64, float64 or strings."""
    present = [v for v in values if v is not None and v not in _NA]
    if len(present) == len(values) and all(_INT.match(v) for v in present):
        return np.array([int(v) for v in present], np.int64)
    try:
        return np.array([float(v) if v is not None and v not in _NA
                         else math.nan for v in values], np.float64)
    except ValueError:
        return np.array(values, dtype=object)


def parse_label_file(label_file: str) -> Dict[str, np.ndarray]:
    """The columns of a DOTA label file (``x1 y1 ... y4 category
    difficult`` per line), each typed as ``pd.read_csv(sep=" ")`` types it
    over the whole file; blank lines are skipped."""
    with open(label_file) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    rows = []
    for ln in lines:
        fields = ln.split(" ")
        if len(fields) > len(LABEL_COLUMNS):
            raise ValueError(f"{label_file}: {len(fields)} fields in "
                             f"{ln!r}, at most {len(LABEL_COLUMNS)} read")
        rows.append(fields + [None] * (len(LABEL_COLUMNS) - len(fields)))
    return {c: _typed_column([r[i] for r in rows])
            for i, c in enumerate(LABEL_COLUMNS)}


def parse_date(text: str) -> Optional[str]:
    """``str(pd.to_datetime(text))`` for the date forms DOTA's meta files
    use: "YYYY-MM-DD" or "YYYY/MM/DD" -> "YYYY-MM-DD 00:00:00", "" ->
    "NaT", "None" -> None (pandas raises there, and the JAX package keeps
    None). Any other string raises."""
    if text == "":
        return "NaT"
    if text == "None":
        return None
    m = _DATE.match(text)
    if m is None:
        raise ValueError(f"acquisition date {text!r} is not a form this "
                         "translator reads (YYYY-MM-DD, YYYY/MM/DD, None or "
                         "empty)")
    day = datetime.date(int(m.group(1)), int(m.group(3)), int(m.group(4)))
    return f"{day.isoformat()} 00:00:00"


def _ids(paths: List[str], pattern: str) -> Dict[int, str]:
    """id -> path, in glob order (``str.extract(pattern).astype(int)``)."""
    out = {}
    for p in paths:
        m = re.search(pattern, p)
        if m is None:
            raise ValueError(f"{p}: no id matches {pattern}")
        out.setdefault(int(m.group(1)), p)
    return out


def _read_meta(path_meta: str):
    with open(path_meta) as f:
        text = f.readlines()
    date = re.match(r"acquisition dates?:([^\n]*)", text[0]).group(1)
    source = re.match(r"imagesource:([^\n]*)", text[1]).group(1)
    gsd = re.match(r"gsd:([^\n]*)", text[2]).group(1)
    try:
        gsd = float(gsd)
    except ValueError:
        gsd = None
    return parse_date(date), None if source == "None" else source, gsd


def fetch_dota_paths(base_path: str, subset: str) -> List[Dict[str, Any]]:
    """The subset's rows (dicts) in the JAX package's order: images in
    glob order that have a label and a meta file, with the meta's date,
    source and GSD (None where missing)."""
    assert subset in ["train", "val"]
    images = _ids(glob.glob(os.path.join(base_path, subset, "images",
                                         "P*.png")), r"P([0-9]+).png")
    labels = _ids(glob.glob(os.path.join(
        base_path, subset, f"DOTA-v2.0_{subset}", "P*.txt")),
        r"P([0-9]+).txt")
    metas = _ids(glob.glob(os.path.join(base_path, subset, "meta",
                                        "P*.txt")), r"P([0-9]+).txt")
    rows = []
    for i, p in images.items():
        if i in labels and i in metas:
            date, source, gsd = _read_meta(metas[i])
            rows.append({"path_image": p, "id": i, "path_label": labels[i],
                         "path_meta": metas[i], "date": date,
                         "source": source, "gsd": gsd})
    return rows


def extract_image_and_boxes(image_file: str, label_file: str,
                            target_categories: List[str]):
    """(image / 255 as float64, polygons (N, 4, 2) (row, col) in the
    labels' type, integer centers, categories, difficult) of the target
    categories."""
    label = parse_label_file(label_file)
    image = read_png(image_file) / 255
    keep = np.isin(label["category"], target_categories)
    ys = np.stack([label[c][keep] for c in ("y1", "y2", "y3", "y4")], -1)
    xs = np.stack([label[c][keep] for c in ("x1", "x2", "x3", "x4")], -1)
    all_boxes = np.stack((ys, xs), axis=-1)
    centers = np.mean(all_boxes, axis=1).astype(int)
    return (image, all_boxes, centers, label["category"][keep],
            label["difficult"][keep])


def prepare_one_image(image_id: int, path_image: str, path_label: str,
                      target_categories: List[str], save_folder: str,
                      n_objects: int, scale: float, info: dict):
    image, polygons, centers, categories, difficult = \
        extract_image_and_boxes(path_image, path_label, target_categories)

    shutil.copy(path_label, os.path.join(save_folder, "raw_annotations",
                                         f"{image_id:04}.txt"))
    shutil.copy(path_image, os.path.join(save_folder, "raw_images",
                                         f"{image_id:04}.png"))

    if abs(1 - scale) > SCALE_ACCEPTABLE_DELTA:
        assert scale <= 1
        h, w = image.shape[:2]
        image = resize_area(image.astype(np.float32),
                            (int(round(w * scale)), int(round(h * scale))))
        polygons = polygons * scale
        centers = (centers * scale).astype(int)

    parameters = np.array([polygon_to_abw(p) for p in polygons])

    if len(centers) == 0:
        centers = np.array([])
        parameters = np.array([])
        categories = np.array([])
        difficult = np.array([])

    image = np.clip(image[..., :3], 0, 1)
    write_png(os.path.join(save_folder, "images", f"{image_id:04}.png"),
              (image * 255).astype(np.uint8))
    with open(os.path.join(save_folder, "annotations",
                           f"{image_id:04}.pkl"), "wb") as f:
        pickle.dump({"centers": centers, "parameters": parameters,
                     "categories": categories, "difficult": difficult}, f)
    with open(os.path.join(save_folder, "metadata",
                           f"{image_id:04}.json"), "w") as f:
        json.dump({"shape": list(image.shape), "n_objects": n_objects,
                   "scale": scale, **info}, f, cls=NumpyEncoder, indent=1)


def make_dataset(subset: str, data_path: str, save_dir: str,
                 categories: List[str], target_gsd: float, prune_empty: bool,
                 drop_rate: float, rng_seed: int,
                 banned_sources: List[str] = None) -> int:
    """Translate one subset; returns the number of images written."""
    assert subset in ["train", "val"]
    rows = fetch_dota_paths(data_path, subset=subset)
    for r in rows:
        labels = parse_label_file(r["path_label"])
        r["n_objects"] = int(np.sum(np.isin(labels["category"], categories)))
    if banned_sources is not None:
        rows = [r for r in rows if r["source"] not in banned_sources]
    rows = [r for r in rows if r["gsd"] is not None and r["gsd"] <= target_gsd]
    for r in rows:
        r["scale"] = r["gsd"] / target_gsd
    if prune_empty:
        rows = [r for r in rows if r["n_objects"] > 0]

    rng = np.random.default_rng(rng_seed)
    if drop_rate > 0:
        assert drop_rate < 1.0
        keep = rng.choice(range(len(rows)),
                          size=int(len(rows) * (1 - drop_rate)),
                          replace=False)
        rows = [rows[i] for i in np.sort(keep)]

    columns = ["path_image", "id", "path_label", "path_meta", "date",
               "source", "gsd", "n_objects", "scale"]
    with open(os.path.join(save_dir, "df_paths_and_meta.pkl"), "wb") as f:
        pickle.dump({c: [r[c] for r in rows] for c in columns}, f)

    for r in rows:
        prepare_one_image(
            image_id=r["id"], path_image=r["path_image"],
            path_label=r["path_label"], target_categories=categories,
            save_folder=save_dir, scale=r["scale"],
            n_objects=r["n_objects"],
            info={"original_gsd": r["gsd"], "source": r["source"],
                  "date": str(r["date"])})
    return len(rows)


def translate_dota(config: Dict[str, Any]) -> Dict[str, int]:
    """Translate the config's subsets (``model_configs/translation/
    translate_DOTA_config.json``) into ``<dataset_path>/<name>``; returns
    the images written per subset."""
    source_base = find_existing_path(config["dota_base_path"])
    save_dir = os.path.join(get_dataset_base_path(), config["name"])
    make_if_not_exist(save_dir)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)

    drop_rate = config.get("drop_rate", {ss: 0.0 for ss in config["subsets"]})
    sub_folders = ["raw_images", "images", "raw_annotations", "annotations",
                   "metadata", "images_w_annotations"]
    counts = {}
    for ss in config["subsets"]:
        subset_dir = os.path.join(save_dir, ss)
        make_if_not_exist(subset_dir)
        make_if_not_exist([os.path.join(subset_dir, s) for s in sub_folders])
        counts[ss] = make_dataset(
            subset=ss, save_dir=subset_dir, data_path=source_base,
            categories=config["categories"],
            target_gsd=config["target_gsd"],
            banned_sources=config["banned_sources"],
            prune_empty=bool(config["prune_empty"]),
            drop_rate=drop_rate[ss], rng_seed=0)
        logging.info(f"[{config['name']}/{ss}] {counts[ss]} images")
    return counts
