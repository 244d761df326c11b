"""The port's overlays and image stacks against the JAX package's:
``utils/display.py`` (OpenCV's thickness-1 ``polylines`` and
``rectangle`` written out in numpy) pixel-equal to the JAX package's
``cv2`` drawing over about 1,000 seeded rectangles -- crossing every
border of the image, degenerate, far outside, in both parametrisations and
both colour modes -- ``light_display`` equal to JAX's, ``save_image``
read back equal, and the overlays ``MPPModel.infer`` writes per scene
equal to the JAX package's drawing of the same result."""

import json
import pickle
import zlib

import numpy as np
import pytest

from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    load_image_w_maps,
)
from mpp_cnn_rs_object_detection_torch.utils import display as td
from mpp_cnn_rs_object_detection_torch.utils import light_display as tld
from mpp_cnn_rs_object_detection_torch.utils.png import read_png
from mpp_cnn_rs_object_detection_tpu.utils import display as jd
from mpp_cnn_rs_object_detection_tpu.utils import light_display as jld
from tests import _torch_workspace as tw
from tests._torch_util import one_torch_thread  # noqa: F401
from tests.test_torch_mesh_scenes import (  # noqa: F401
    DATASET,
    N_IMAGES,
    mpp_r2_copy,
    results_dir,
    workspace,
)


def _rectangles(rng, n, h, w):
    """Centers over and beyond the image (every border crossed), sizes
    from zero (a point) to larger than the image, any angle."""
    centers = np.stack([rng.uniform(-0.3 * h, 1.3 * h, n),
                        rng.uniform(-0.3 * w, 1.3 * w, n)], -1)
    params = np.stack([rng.uniform(0, 0.6 * h, n), rng.uniform(0, 0.6 * w, n),
                       rng.uniform(-np.pi, np.pi, n)], -1)
    params[::9, :2] = 0.0  # degenerate
    params[1::9, 0] = 0.0  # a segment
    centers[2::9] = [[-5.0 * h, 3.0 * w]]  # far outside
    return centers, params


@pytest.mark.parametrize("param_type", ["wla", "sra"])
@pytest.mark.parametrize("color", [(0, 255, 0), (1, 0, 0), "plasma"])
def test_rectangles_match_cv2(param_type, color):
    """200 rectangles over each of 5 images (float, gray and uint8), as
    the JAX package draws them with ``cv2.polylines``."""
    rng = np.random.default_rng(zlib.crc32(f"{param_type}{color}".encode()))
    for k, (h, w) in enumerate([(37, 53), (64, 64), (9, 120), (120, 9),
                                (97, 71)]):
        if k == 1:
            image = rng.uniform(size=(h, w))  # gray
        elif k == 2:
            image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            image = rng.uniform(-0.2, 1.2, (h, w, 4))  # clipped, RGBA
        centers, params = _rectangles(rng, 200, h, w)
        if param_type == "sra":
            params[:, 1] = rng.uniform(0.05, 1.0, len(params))
        scores = rng.uniform(0, 3, len(centers)).astype(np.float32)
        kw = dict(param_type=param_type, color=color)
        if color == "plasma":
            kw.update(scores=scores, max_score=2.5)
        want = jd.rectangles_over_image(image.copy(), centers, params, **kw)
        got = td.rectangles_over_image(image, centers, params, **kw)
        np.testing.assert_array_equal(got, want)


def test_bboxes_and_comparison_figure_match_cv2():
    """Axis-aligned boxes (``cv2.rectangle``), over and beyond the image,
    in both colour modes, and the side-by-side detection / GT figure."""
    rng = np.random.default_rng(11)
    image = rng.uniform(size=(50, 70, 3))
    boxes = np.concatenate([rng.uniform(-30, 100, (150, 4)),
                            np.array([[10, 10, 10, 10], [5, 40, 5, 2]])])
    scores = rng.uniform(0, 1, len(boxes))
    for kw in (dict(color=(255, 0, 255)),
               dict(color="plasma", scores=scores, max_score=0.7)):
        np.testing.assert_array_equal(
            td.bboxes_over_image(image, boxes, **kw),
            jd.bboxes_over_image(image, boxes, **kw))
    centers, params = _rectangles(rng, 60, 50, 70)
    gt_c, gt_p = _rectangles(rng, 20, 50, 70)
    args = (image, centers, params, rng.uniform(0, 2, 60), gt_c, gt_p)
    np.testing.assert_array_equal(
        td.detection_comparison_figure(*args, max_score=2.0),
        jd.detection_comparison_figure(*args, max_score=2.0))
    with pytest.raises(NotImplementedError, match="thickness 2"):
        td.rectangles_over_image(image, centers, params, thickness=2)


def test_light_display_matches_jax():
    rng = np.random.default_rng(2)
    imgs = [rng.uniform(-1, 2, (8, 10)), rng.uniform(size=(8, 10, 3)),
            rng.uniform(size=(8, 10, 4))]
    for img in imgs:
        for kw in ({}, {"normalize": True}, {"cmap_range": (-0.5, 0.5)}):
            np.testing.assert_array_equal(tld.to_rgb(img, **kw),
                                          jld.to_rgb(img, **kw))
    rgb = jld.to_rgb(imgs[1])
    np.testing.assert_array_equal(
        tld.draw_text(rgb, "0.5 val-e? 12", origin=(1, 2), scale=2),
        jld.draw_text(rgb, "0.5 val-e? 12", origin=(1, 2), scale=2))
    np.testing.assert_array_equal(tld.make_image_from_bunch(imgs, border=3),
                                  jld.make_image_from_bunch(imgs, border=3))
    rows = [imgs[:2], imgs]
    np.testing.assert_array_equal(
        tld.stack_rows(rows, labels=["in", "out"]),
        jld.stack_rows(rows, labels=["in", "out"]))


def test_save_image_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    for image in (rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
                  rng.uniform(size=(13, 17)), rng.uniform(size=(5, 6, 4))):
        path = str(tmp_path / "x.png")
        td.save_image(path, image)
        np.testing.assert_array_equal(read_png(path), td._to_u8(image))


def test_cli_overlays_match_jax(workspace):
    """``-p infereval`` on the mpp_r2 copy of
    ``tests/test_torch_mesh_scenes.py``: each scene's
    ``NNNN_detection.png`` equals the JAX package's
    ``rectangles_over_image`` of its result pickle (score-coloured over the
    scene's largest score), and ``NNNN_gt.png`` its GT in green."""
    from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main

    path = mpp_r2_copy(workspace, "r2_overlays")
    with tw.inside(workspace):
        t_main(["-p", "infereval", "-m", "mpp", "-c", str(path)],
               device="cpu")
        cfg = json.loads(path.read_text())
        datas = [load_image_w_maps(i, DATASET, "val",
                                   cfg["dataset"]["position_model"],
                                   cfg["dataset"]["shape_model"])
                 for i in range(N_IMAGES)]
    rd = results_dir(workspace, "r2_overlays")
    for i, data in enumerate(datas):
        with open(rd / f"{i:04}_results.pkl", "rb") as f:
            res = pickle.load(f)
        scores = res["detection_score"]
        assert len(scores) > 0
        want = jd.rectangles_over_image(
            data.image, res["detection_center"], res["detection_params"],
            scores=scores, color="plasma",
            max_score=max(1e-6, float(np.max(scores))))
        np.testing.assert_array_equal(
            read_png(str(rd / f"{i:04}_detection.png")), want)
        want = jd.rectangles_over_image(
            data.image, data.labels["centers"], data.labels["parameters"],
            color=(0, 255, 0))
        np.testing.assert_array_equal(read_png(str(rd / f"{i:04}_gt.png")),
                                      want)
