"""DOTA task-1 style AP evaluation over the devkit text format.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/metrics/dota_eval.py``:
the VOC detection-AP protocol over oriented polygons. Detections are
matched greedily in score order to unmatched GT with polygon IoU >=
threshold; difficult GT never count as tp/fp nor toward npos; AP is the
all-points interpolated area under the PR curve (``use_07_metric=False``). Both OBB (polygon IoU via the C++
polyiou module) and HBB (axis-aligned IoU) are supported.

Evaluates at IoU in {0.05, 0.1, 0.25, 0.5, 0.75} and writes
``metrics{iou}.json`` and, with ``make_plots`` (the default), the PR curve
``prec_rec_curve_{iou}.png`` (recall on x, precision on y, 8 x 4 inches at
100 dpi), drawn with ``utils/raster_plot.py`` (the GPU host has no
matplotlib); as in the JAX package each class overwrites that file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from mpp_cnn_rs_object_detection_torch.metrics.polyiou import poly_iou_batch
from mpp_cnn_rs_object_detection_torch.utils.config import get_inference_path
from mpp_cnn_rs_object_detection_torch.utils import raster_plot
from mpp_cnn_rs_object_detection_torch.utils.files import NumpyEncoder

IOU_THRESHOLDS = [0.05, 0.1, 0.25, 0.5, 0.75]


def _parse_gt_file(path: str):
    """gt txt line: 8 coords + category + difficult."""
    records = []
    if not os.path.exists(path):
        return records
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 10:
                continue
            coords = np.array([float(v) for v in parts[:8]]).reshape(4, 2)
            records.append(
                {"poly": coords, "category": parts[8], "difficult": int(parts[9])}
            )
    return records


def _hbb_iou(det_poly: np.ndarray, gt_polys: np.ndarray) -> np.ndarray:
    def bounds(p):
        return p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()

    dx1, dy1, dx2, dy2 = bounds(det_poly)
    out = np.zeros(len(gt_polys))
    for i, g in enumerate(gt_polys):
        gx1, gy1, gx2, gy2 = bounds(g)
        ix1, iy1 = max(dx1, gx1), max(dy1, gy1)
        ix2, iy2 = min(dx2, gx2), min(dy2, gy2)
        iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
        inter = iw * ih
        union = (dx2 - dx1) * (dy2 - dy1) + (gx2 - gx1) * (gy2 - gy1) - inter
        out[i] = inter / union if union > 0 else 0.0
    return out


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(detpath: str, annopath: str, imagesetfile: str, classname: str,
             ovthresh: float = 0.5, use_07_metric: bool = False,
             det_type: str = "obb"):
    """Returns (recall, precision, ap) for one class."""
    with open(imagesetfile, "r") as f:
        image_ids = [line.strip() for line in f if line.strip()]
    image_ids = sorted(set(image_ids))

    class_recs: Dict[str, dict] = {}
    npos = 0
    for img in image_ids:
        records = [
            r for r in _parse_gt_file(annopath.format(img)) if r["category"] == classname
        ]
        difficult = np.array([r["difficult"] for r in records], dtype=bool)
        class_recs[img] = {
            "polys": np.array([r["poly"] for r in records]).reshape(-1, 4, 2),
            "difficult": difficult,
            "det": [False] * len(records),
        }
        npos += int(np.sum(~difficult))

    det_file = detpath.format(classname)
    if not os.path.exists(det_file):
        return np.zeros(0), np.zeros(0), 0.0
    with open(det_file, "r") as f:
        lines = [line.strip().split(" ") for line in f if line.strip()]
    if len(lines) == 0:
        return np.zeros(0), np.zeros(0), 0.0

    det_img = [l[0] for l in lines]
    det_score = np.array([float(l[1]) for l in lines])
    if len(lines[0]) >= 10:
        # task1 (OBB): imgid score x1 y1 ... x4 y4
        det_poly = np.array(
            [[float(v) for v in l[2:10]] for l in lines]
        ).reshape(-1, 4, 2)
    else:
        # task2 (HBB): imgid score xmin ymin xmax ymax
        boxes = np.array([[float(v) for v in l[2:6]] for l in lines])
        x1, y1, x2, y2 = boxes.T
        det_poly = np.stack(
            [
                np.stack([x1, y1], -1),
                np.stack([x2, y1], -1),
                np.stack([x2, y2], -1),
                np.stack([x1, y2], -1),
            ],
            axis=1,
        )

    order = np.argsort(-det_score)
    det_img = [det_img[i] for i in order]
    det_poly = det_poly[order]

    nd = len(det_img)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = class_recs.get(det_img[d])
        if rec is None or len(rec["polys"]) == 0:
            fp[d] = 1.0
            continue
        if det_type == "obb":
            overlaps = poly_iou_batch(det_poly[d], rec["polys"])
        else:
            overlaps = _hbb_iou(det_poly[d], rec["polys"])
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp_cum = np.cumsum(fp)
    tp_cum = np.cumsum(tp)
    recall = tp_cum / max(npos, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
    ap = voc_ap(recall, precision, use_07_metric)
    return recall, precision, ap


def pr_curve_plot(recall, precision, path: str) -> raster_plot.Axes:
    """The precision-recall curve, as the JAX package's ``plt.figure(
    figsize=(8, 4))``; returns its axes (``to_pixel`` finds a point)."""
    fig = raster_plot.figure(figsize=(8, 4))
    ax = fig.gca()
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.plot(recall, precision)
    fig.savefig(path)
    return ax


def dota_eval(model_dir: str, dataset: str, subset: str, det_type: str,
              postfix: str = "", classnames: List[str] = None,
              make_plots: bool = True) -> Dict[float, Dict]:
    """Evaluate a model's devkit-format output dir at all IoU thresholds."""
    assert det_type in ["obb", "hbb"]
    model_name = os.path.split(model_dir)[1]
    dota_files_path = os.path.join(
        get_inference_path(model_name=model_name, dataset=dataset, subset=subset),
        "dota" + postfix,
    )
    det_path = os.path.join(dota_files_path, "det", "{:s}.txt")
    annot_path = os.path.join(dota_files_path, "gt", "{:s}.txt")
    image_set_file = os.path.join(dota_files_path, "imageSet.txt")

    if classnames is None:
        classnames = ["vehicle"]

    all_results = {}
    for iou_t in IOU_THRESHOLDS:
        results = {}
        mean_ap = 0.0
        for classname in classnames:
            rec, prec, ap = voc_eval(
                detpath=det_path,
                annopath=annot_path,
                imagesetfile=image_set_file,
                classname=classname,
                ovthresh=iou_t,
                use_07_metric=False,
                det_type=det_type,
            )
            mean_ap += ap
            results[classname] = {"ap": ap, "precision": prec, "recall": rec}
            if make_plots:
                pr_curve_plot(rec, prec, os.path.join(
                    dota_files_path, f"prec_rec_curve_{iou_t:.2f}.png"))
        mean_ap /= len(classnames)
        print(f"IoU {iou_t}: mAP = {mean_ap:.4f}")

        with open(os.path.join(dota_files_path, f"metrics{iou_t:.2f}.json"), "w") as f:
            json.dump(results, f, cls=NumpyEncoder, indent=1)
        all_results[iou_t] = results
    return all_results
