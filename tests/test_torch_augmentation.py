"""The host augmentation of the PyTorch port against OpenCV, Pillow and the
JAX package:

  - ``data/image_ops.py``, the OpenCV and Pillow calls written out in
    numpy, against the libraries: RGB <-> Lab on all 2^24 inputs of each
    direction, CLAHE, ``fillPoly`` over random 3-5-vertex polygons (most
    self-intersect) and Pillow's bilinear downscale exactly; the area and
    linear resizes and the 3 x 3 blur within 1e-5 (float32 and float64
    inputs, the dtypes the augmentation feeds them);
  - ``DataAugment`` at both levels, with histogram matching, on the same
    patches and generator seed as the JAX package's: the same centers and
    marks, images within 1e-5 (the linear resize's rounding), and the same
    generator state after every item, which shows the draws come in JAX's
    order.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from PIL import Image

from mpp_cnn_rs_object_detection_torch.data import augmentation as taug
from mpp_cnn_rs_object_detection_torch.data import image_ops
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_tpu.data import augmentation as jaug

# float32 images after a resize written out against OpenCV's SIMD one
RESIZE_TOL = 1e-5


def test_lab_conversions_equal_opencv_on_every_input():
    """Both directions over all 2^24 uint8 triples, in 16 chunks."""
    axis = np.arange(256, dtype=np.uint8)
    for hi in range(16):
        rgb = np.stack(np.meshgrid(axis[hi * 16:(hi + 1) * 16], axis, axis,
                                   indexing="ij"), -1).reshape(4096, -1, 3)
        np.testing.assert_array_equal(image_ops.rgb_to_lab(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB))
        np.testing.assert_array_equal(image_ops.lab_to_rgb(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_LAB2RGB))


@pytest.mark.parametrize("h,w", [(128, 128), (32, 32), (100, 90), (33, 77)])
def test_clahe_equals_opencv(h, w):
    """Tile grids that divide the image and ones OpenCV pads (reflect-101
    on both sides)."""
    rng = np.random.default_rng(h * w)
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    yy, xx = np.mgrid[:h, :w]
    for i in range(6):
        if i % 2:
            img = rng.normal(rng.uniform(30, 200), rng.uniform(2, 60), (h, w))
        else:
            img = 128 + 60 * np.sin(xx / rng.uniform(3, 20)) \
                + 40 * np.cos(yy / 7) + rng.normal(0, 5, (h, w))
        img = np.clip(img, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(image_ops.clahe(img, 2.0, (8, 8)),
                                      clahe.apply(img))


def test_fill_poly_equals_opencv():
    """The shadow's polygons: 3-5 integer vertices anywhere in the image."""
    rng = np.random.default_rng(0)
    for t in range(1500):
        h, w = [(128, 128), (32, 32), (40, 70)][t % 3]
        n = rng.integers(3, 6)
        poly = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)],
                        -1).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [poly], 1)
        got = image_ops.fill_poly(np.zeros((h, w), np.uint8), poly, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(poly.tolist()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("h,w", [(128, 128), (32, 32), (40, 70)])
def test_resizes_and_blur_match_opencv(h, w, dtype):
    img = np.random.default_rng(h + w).random((h, w, 3)).astype(dtype)
    size = (int(w * 0.9), int(h * 0.9))
    small = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    got = image_ops.resize_area(img, size)
    assert got.dtype == small.dtype
    np.testing.assert_allclose(got, small, rtol=0, atol=RESIZE_TOL)
    up = image_ops.resize_linear(small, (w, h))
    assert up.dtype == img.dtype
    np.testing.assert_allclose(
        up, cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR),
        rtol=0, atol=RESIZE_TOL)
    blur = image_ops.box_blur3(img)
    assert blur.dtype == img.dtype
    np.testing.assert_allclose(blur, cv2.blur(img, (3, 3)), rtol=0,
                               atol=RESIZE_TOL)


@pytest.mark.parametrize("h,w", [(512, 512), (958, 926), (96, 64),
                                 (13, 200)])
def test_pillow_bilinear_downscale_is_exact(h, w):
    """Hard mining's 8x downscale of an 8-bit error map."""
    rng = np.random.default_rng(w)
    for img in (rng.integers(0, 256, (h, w)),
                np.clip(rng.normal(30, 40, (h, w)), 0, 255)):
        img = img.astype(np.uint8)
        nh, nw = max(1, int(h / 8)), max(1, int(w / 8))
        np.testing.assert_array_equal(
            image_ops.resize_bilinear_u8(img, (nw, nh)),
            np.asarray(Image.fromarray(img).resize((nw, nh),
                                                   Image.BILINEAR)))


@pytest.fixture(scope="module")
def hist_ws(tmp_path_factory):
    """A dataset whose train scenes are the histogram-match references."""
    ws = tmp_path_factory.mktemp("aug_ws")
    (ws / "data").mkdir()
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    make_synth_dataset(name="refs", n_items=3, shape=(80, 72), n_rect=20,
                       seed=3, base_dir=str(ws / "data"))
    return ws


def _items(n, seed):
    """Patches (some non-square) with objects, and some without."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (32, 32) if i % 3 else (24, 40)
        patch = rng.random((h, w, 3)).astype(np.float32)
        k = 0 if i % 5 == 4 else int(rng.integers(1, 8))
        centers = np.stack([rng.integers(0, h, k), rng.integers(0, w, k)],
                           -1).astype(np.int64)
        params = np.stack([rng.uniform(2, 5, k), rng.uniform(5, 10, k),
                           rng.uniform(0, np.pi, k)], -1)
        if k == 0:
            centers, params = np.array([]), np.array([])
        out.append((patch, centers, params))
    return out


@pytest.mark.parametrize("level,hist", [("medium", False), ("medium", True),
                                        ("strong", True)])
def test_data_augment_matches_jax(hist_ws, monkeypatch, level, hist):
    monkeypatch.chdir(hist_ws)
    kw = dict(dataset="refs", subset="train", hist_match_images=hist,
              aug_level=level)
    j = jaug.DataAugment(rng=np.random.default_rng(11), **kw)
    t = taug.DataAugment(rng=np.random.default_rng(11), **kw)
    assert j.hist_match_images_paths == t.hist_match_images_paths
    for i, (patch, centers, params) in enumerate(_items(60, 5)):
        want = j.transform(patch, centers, params)
        got = t.transform(patch, centers, params)
        assert got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=RESIZE_TOL,
                                   err_msg=f"item {i}")
        for g, w in zip(got[1:3], want[1:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"item {i}")
        assert t.rng.bit_generator.state == j.rng.bit_generator.state, i


def test_draws_then_apply_equal_transform(hist_ws, monkeypatch):
    """``transform`` is ``apply`` of ``draw``: draws taken ahead (as the
    loader's parent does) give the same items, in any order of
    application."""
    monkeypatch.chdir(hist_ws)
    kw = dict(dataset="refs", subset="train", hist_match_images=True,
              aug_level="strong")
    a = taug.DataAugment(rng=np.random.default_rng(2), **kw)
    b = taug.DataAugment(rng=np.random.default_rng(2), **kw)
    items = _items(12, 9)
    draws = [b.draw(p.shape) for p, _, _ in items]
    applied = [b.apply(*items[i], draws[i]) for i in reversed(range(12))]
    for i, item in enumerate(items):
        want = a.transform(*item)
        got = applied[11 - i]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_reference_cache_is_bounded_and_gives_the_same_items(hist_ws,
                                                             monkeypatch):
    """With room for one sorted scene, items applied by 4 threads equal
    those of the default cache, and the cache never holds more than its
    bytes."""
    monkeypatch.chdir(hist_ws)
    kw = dict(dataset="refs", subset="train", hist_match_images=True,
              aug_level="strong")
    a = taug.DataAugment(rng=np.random.default_rng(4), **kw)
    items = _items(24, 6)
    want = [a.transform(*item) for item in items]
    scene = 80 * 72 * 3 * 4  # one synthetic scene's sorted float32 channels
    monkeypatch.setattr(taug, "REFERENCE_CACHE_BYTES", scene)
    b = taug.DataAugment(rng=np.random.default_rng(4), **kw)
    draws = [b.draw(p.shape) for p, _, _ in items]
    assert len({d["hist"]["ref"] for d in draws if "hist" in d}) > 1
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda i: b.apply(*items[i], draws[i]),
                            range(len(items))))
    assert len(b._references) == 1 and b._reference_bytes == scene
    for g, w in zip(got, want):
        for x, y in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(x, y)
