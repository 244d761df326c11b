"""Evaluation of the PyTorch port against the JAX package: the rotated
polygon IoU library, the DOTA devkit writer (byte-identical files for
identical inputs) and AP evaluation (identical AP, precision and recall at
every IoU threshold)."""

import importlib
import json
import os

import numpy as np
import pytest

from mpp_cnn_rs_object_detection_torch.metrics import dota_eval as teval
from mpp_cnn_rs_object_detection_torch.metrics import dota_writer as twriter
from mpp_cnn_rs_object_detection_torch.metrics import polyiou as tpoly
from mpp_cnn_rs_object_detection_torch.ops.geometry import rect_to_poly_np
from mpp_cnn_rs_object_detection_torch.utils.png import png_header
from tests._dota_util import dota_snapshot

# the modules (the JAX package's metrics/__init__ re-exports functions of
# the same names)
jeval = importlib.import_module(
    "mpp_cnn_rs_object_detection_tpu.metrics.dota_eval")
jwriter = importlib.import_module(
    "mpp_cnn_rs_object_detection_tpu.metrics.dota_writer")
jpoly = importlib.import_module(
    "mpp_cnn_rs_object_detection_tpu.metrics.polyiou")

N_PAIRS = 1000


def _quads(n, seed, spread=6.0):
    """n random rectangles (4, 2) each and n partners near them, so that
    most pairs overlap partly."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 50, (n, 2))
    a = rng.uniform(2, 8, (2, n))
    b = a + rng.uniform(0, 8, (2, n))
    ang = rng.uniform(0, np.pi, (2, n))
    c2 = c + rng.uniform(-spread, spread, (n, 2))
    return (rect_to_poly_np(c, a[0], b[0], ang[0]),
            rect_to_poly_np(c2, a[1], b[1], ang[1]))


def test_polyiou_against_jax_and_plain():
    """The library's one entry point, ``poly_iou_batch``, pair by pair and
    one det against many, against the JAX package's module and the plain
    version."""
    p, q = _quads(N_PAIRS, seed=0)
    lib = np.array([tpoly.poly_iou_batch(a, b[None])[0]
                    for a, b in zip(p, q)])
    ref = np.array([jpoly.poly_iou(a, b) for a, b in zip(p, q)])
    plain = np.array([tpoly.poly_iou_plain(a, b) for a, b in zip(p, q)])
    assert (lib > 0).mean() > 0.5 and (lib == 0).any()
    np.testing.assert_allclose(lib, ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(lib, plain, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        [tpoly.poly_intersection_plain(a, b) for a, b in zip(p, q)],
        [jpoly.poly_intersection(a, b) for a, b in zip(p, q)],
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(tpoly.poly_iou_batch(p[0], q[:50]),
                               jpoly.poly_iou_batch(p[0], q[:50]), atol=1e-9)
    assert tpoly.poly_iou_batch(p[0], q[:0]).shape == (0,)


def _fill(mod, results_dir, det_type, postfix, seed):
    """Feed a translator a fixed set of GT and detections of 3 images:
    polygons for OBB, [r1, c1, r2, c2] boxes for HBB (as PosNet does)."""
    rng = np.random.default_rng(seed)
    tr = mod.DOTAResultsTranslator("ds", "val", results_dir, det_type,
                                   all_classes=["vehicle", "car"],
                                   postfix=postfix)
    for img in (3, 0, 12):
        gt, det = _quads(6, seed=img + seed, spread=1.5)
        diff = rng.uniform(size=6) < 0.3
        tr.add_gt(image_id=img, difficulty=diff, polygons=gt,
                  categories=["vehicle"] * 4 + ["car"] * 2)
        scores = rng.uniform(size=6).astype(np.float32)
        names = ["vehicle"] * 5 + ["car"]
        if det_type == "obb":
            tr.add_detections(image_id=img, scores=scores, polygons=det,
                              flip_coor=True, class_names=names)
        else:
            lo, hi = det.min(axis=1), det.max(axis=1)
            tr.add_detections(image_id=img, scores=scores.astype(float),
                              bbox=np.concatenate([lo, hi], axis=1),
                              flip_coor=True, class_names=names)
    tr.save()


@pytest.mark.parametrize("det_type,postfix", [("obb", ""), ("hbb", "-SV")])
def test_writer_byte_identical(tmp_path, det_type, postfix):
    dirs = []
    for mod, name in ((jwriter, "jax"), (twriter, "torch")):
        d = tmp_path / name
        _fill(mod, str(d), det_type, postfix, seed=1)
        dirs.append(d)
    snap_j, snap_t = dota_snapshot(str(dirs[0])), dota_snapshot(str(dirs[1]))
    assert len(snap_t) == 6  # det/{vehicle,car}, gt/3 images, imageSet
    assert snap_t == snap_j
    polys = _quads(5, seed=2)[0]
    np.testing.assert_array_equal(twriter.polys_to_hbb(polys),
                                  jwriter.polys_to_hbb(polys))


def _compare_results(rt, rj):
    assert sorted(rt) == sorted(rj) == teval.IOU_THRESHOLDS
    for iou in rt:
        for cls in rj[iou]:
            a, b = rj[iou][cls], rt[iou][cls]
            assert b["ap"] == a["ap"], (iou, cls)
            np.testing.assert_array_equal(b["precision"], a["precision"])
            np.testing.assert_array_equal(b["recall"], a["recall"])


@pytest.mark.parametrize("det_type", ["obb", "hbb"])
def test_eval_identical(tmp_path, monkeypatch, det_type):
    """voc_eval and dota_eval of both packages on one DOTA dir."""
    ws = tmp_path / "ws"
    results = ws / "data" / "inference" / "ds" / "val" / "model"
    (ws / "models").mkdir(parents=True)
    results.mkdir(parents=True)
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    monkeypatch.chdir(ws)
    _fill(twriter, str(results), det_type, "", seed=3)
    dota = results / "dota"
    for iou in (0.05, 0.5, 0.75):
        kw = dict(detpath=str(dota / "det" / "{:s}.txt"),
                  annopath=str(dota / "gt" / "{:s}.txt"),
                  imagesetfile=str(dota / "imageSet.txt"),
                  classname="vehicle", ovthresh=iou, det_type=det_type)
        rec_t, prec_t, ap_t = teval.voc_eval(**kw)
        rec_j, prec_j, ap_j = jeval.voc_eval(**kw)
        assert ap_t == ap_j
        assert ap_t > 0 or iou > 0.05
        np.testing.assert_array_equal(rec_t, rec_j)
        np.testing.assert_array_equal(prec_t, prec_j)
    classes = ["vehicle", "car"]
    rt = teval.dota_eval(str(ws / "models" / "model"), "ds", "val", det_type,
                         classnames=classes)
    with open(dota / "metrics0.50.json") as f:
        written_t = f.read()
    rj = jeval.dota_eval(str(ws / "models" / "model"), "ds", "val", det_type,
                         classnames=classes, make_plots=False)
    with open(dota / "metrics0.50.json") as f:
        assert f.read() == written_t
    _compare_results(rt, rj)
    # the port's eval also writes the PR curves (JAX's, make_plots=False
    # here, are held to them in tests/test_torch_figures.py)
    curves = [f"prec_rec_curve_{t:.2f}.png" for t in teval.IOU_THRESHOLDS]
    assert sorted(os.listdir(dota)) == sorted(
        ["det", "gt", "imageSet.txt"] + curves
        + [f"metrics{t:.2f}.json" for t in teval.IOU_THRESHOLDS])
    for name in curves:
        assert png_header(str(dota / name)) == (400, 800, 4)


def test_voc_ap_matches():
    rng = np.random.default_rng(4)
    rec = np.sort(rng.uniform(size=40))
    prec = rng.uniform(size=40)
    for m07 in (False, True):
        assert teval.voc_ap(rec, prec, m07) == jeval.voc_ap(rec, prec, m07)
