"""The device-resident CNN data pipeline of the PyTorch port against the
JAX package's (``data/device_pipeline.py``, ``data/copy_paste.py``):

  - ``build_patch_stack`` from the same numpy seed on a synthetic dataset
    the port writes: the same patches, annotations and generator state;
  - the copy-paste helpers that replace OpenCV, against ``cv2``;
  - augmentation: the port's deterministic apply fed the variates that
    JAX's ``augment_batch`` draws, rebuilt from JAX's own key splits;
  - the target painters over a batch, against JAX's vmapped ones.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.data import copy_paste as tcp
from mpp_cnn_rs_object_detection_torch.data import device_pipeline as tdp
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.data import copy_paste as jcp
from mpp_cnn_rs_object_detection_tpu.data import device_pipeline as jdp
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)

from _torch_util import one_torch_thread  # noqa: F401

P, M = 32, 16
STACK = dict(n_patches=48, patch_size=P, unf_weight=0.33, obj_weight=0.66,
             sigma=10.0, max_objects=M)


@pytest.fixture(scope="module")
def dataset_ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("pipeline_ws")
    (ws / "data").mkdir()
    (ws / "paths_config.json").write_text(
        '{"dataset_path": ["%s"], "model_path": ["%s"]}'
        % (ws / "data", ws / "models"))
    make_synth_dataset(name="tiny", n_items=3, shape=(96, 80), n_rect=40,
                       seed=3, base_dir=str(ws / "data"))
    return ws


@pytest.mark.parametrize("copy_paste", [None, {"p": 0.7, "n_range": [1, 4]}])
def test_build_patch_stack_matches_jax(dataset_ws, monkeypatch, copy_paste):
    monkeypatch.chdir(dataset_ws)
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    want = jdp.build_patch_stack("tiny", "train", rng=rng_j,
                                 copy_paste=copy_paste, **STACK)
    got = tdp.build_patch_stack("tiny", "train", rng=rng_t,
                                copy_paste=copy_paste, **STACK)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_array_equal(got.params, want.params)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    diff = np.abs(got.images.astype(int) - want.images.astype(int))
    if copy_paste is None:
        assert diff.max() == 0
    else:
        # pasted pixels are float blends truncated to uint8: the rotation's
        # float32 rounding (~1e-5, test below) may move one across a level
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
        assert got.valid.sum() > STACK["n_patches"]  # objects were pasted


def test_rotate_crop_and_blur_match_opencv():
    rng = np.random.default_rng(0)
    for _ in range(12):
        s = int(rng.integers(8, 40)) * 2
        crop = rng.random((s, s, 3)).astype(np.float32)
        delta, scale = rng.uniform(0, np.pi), rng.uniform(0.9, 1.15)
        # float32 bilinear weights in another rounding than OpenCV's
        np.testing.assert_allclose(tcp._rotate_crop(crop, delta, scale),
                                   jcp._rotate_crop(crop, delta, scale),
                                   rtol=0, atol=1e-5)
        alpha = (rng.random((s, s)) > 0.5).astype(np.float32)
        np.testing.assert_allclose(tcp._gaussian_blur(alpha, 3, 1.5),
                                   cv2.GaussianBlur(alpha, (3, 3), 1.5),
                                   rtol=0, atol=1e-6)
    # the whole paste against the JAX module on one patch
    patch = rng.random((48, 48, 3)).astype(np.float32)
    cen = np.array([[10.0, 12.0], [30.0, 33.0]])
    par = np.array([[4.0, 9.0, 0.3], [5.0, 10.0, 2.0]])
    bank_t = [tcp.PasteObject(crop=rng.random((18, 18, 3)).astype(
        np.float32), a=4.5, b=9.5, angle=0.7, category="vehicle")]
    bank_j = [jcp.PasteObject(**vars(o)) for o in bank_t]
    out_t = tcp.paste_objects(patch, cen, par, np.zeros(2), np.zeros(2),
                              bank_t, np.random.default_rng(4), n_paste=3)
    out_j = jcp.paste_objects(patch, cen, par, np.zeros(2), np.zeros(2),
                              bank_j, np.random.default_rng(4), n_paste=3)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=0, atol=1e-5)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a, b)


def _jax_variates(key, b, p):
    """Every random number JAX's ``augment_batch(key, ...)`` draws, by the
    same key splits, as the port's ``AugmentVariates``."""
    cols = {f: [] for f in tdp.AugmentVariates._fields}
    for key_i in jax.random.split(key, b):
        kk, kf0, kf1, kp = jax.random.split(key_i, 4)
        k1, k2, k3, k4, k5 = jax.random.split(kp, 5)
        cols["k"].append(jax.random.randint(kk, (), 0, 4))
        cols["f0"].append(jax.random.uniform(kf0) < 0.5)
        cols["f1"].append(jax.random.uniform(kf1) < 0.5)
        cols["r"].append(jax.random.uniform(k1))
        cols["shift"].append(jax.random.uniform(k2, (3,), minval=-0.08,
                                                maxval=0.08))
        cols["blur"].append(jax.random.uniform(k3))
        cols["sigma"].append(jax.random.uniform(k4, maxval=0.03))
        cols["noise"].append(jax.random.normal(k5, (p, p, 3)))
    return tdp.AugmentVariates(**{
        f: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
        for f, v in cols.items()})


def _batch(seed, b=6, n_obj=5, integer=False):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, P, P, 3)).astype(np.uint8)
    cen = np.zeros((b, M, 2), np.float32)
    par = np.zeros((b, M, 3), np.float32)
    val = np.zeros((b, M), bool)
    for i in range(b):
        n = min(n_obj + i % 3, M) if n_obj else 0
        c = rng.uniform(2, P - 2, (n, 2))
        cen[i, :n] = np.trunc(c) if integer else c
        par[i, :n] = np.stack([rng.uniform(3, 6, n), rng.uniform(6, 12, n),
                               rng.uniform(0, np.pi, n)], -1)
        val[i, :n] = True
    return imgs, cen, par, val


def test_augmentation_from_jax_variates_matches_jax():
    imgs, cen, par, val = _batch(1, b=8)
    key = jax.random.PRNGKey(7)
    want = jdp.augment_batch(key, imgs, cen, par, val)
    v = _jax_variates(key, imgs.shape[0], P)
    assert len(set(v.k.tolist())) > 1 and v.f0.any() and not v.f0.all()
    got = tdp.augment_batch(*(torch.from_numpy(a) for a in
                              (imgs, cen, par, val)), v)
    # the image mean and the blur sum in another float32 order
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _flip_share(got, want):
    return float(np.mean(np.asarray(got) != np.asarray(want)))


@pytest.mark.parametrize("n_obj", [0, 1, 5])
@pytest.mark.parametrize("max_distance", [8.0, "auto"])
@pytest.mark.parametrize("integer", [False, True])
def test_pos_targets_match_jax(n_obj, max_distance, integer):
    _, cen, par, val = _batch(n_obj + 20, n_obj=n_obj, integer=integer)
    want = jax.vmap(lambda c, p, v: jdp.pos_targets(
        c, p, v, P, max_distance, sigma_dil=0.6))(cen, par, val)
    got = tdp.pos_targets(torch.from_numpy(cen), torch.from_numpy(par),
                          torch.from_numpy(val), P, max_distance,
                          sigma_dil=0.6)
    assert set(got) == set(want)
    # the same float32 formulas; equidistant pixels pick the first
    # nearest center in both packages
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_obj", [0, 1, 5])
@pytest.mark.parametrize("mask_mode", ["shapes", "gaussian"])
def test_shape_targets_match_jax(n_obj, mask_mode):
    _, cen, par, val = _batch(n_obj + 30, n_obj=n_obj, integer=True)
    want = jax.vmap(lambda c, p, v: jdp.shape_targets(
        c, p, v, P, j_mappings(16, 0, 16), mask_mode=mask_mode,
        mask_sigma="auto"))(cen, par, val)
    got = tdp.shape_targets(torch.from_numpy(cen), torch.from_numpy(par),
                            torch.from_numpy(val), P, t_mappings(16, 0, 16),
                            mask_mode=mask_mode, mask_sigma="auto")
    # a pixel on a rectangle's edge may flip with the last ulp of cos/sin:
    # at most 0.5 % of the pixels change class, and the loss mask moves
    # by that share of its mass
    for g, w in zip(got["value_class_map"], want["value_class_map"]):
        assert _flip_share(g.numpy(), w) <= 5e-3
    lm_t, lm_j = got["loss_mask"].numpy(), np.asarray(want["loss_mask"])
    np.testing.assert_allclose(lm_t.sum(axis=(1, 2)), lm_j.sum(axis=(1, 2)),
                               atol=1e-5)
    assert np.abs(lm_t - lm_j).sum(axis=(1, 2)).max() <= 1e-2
    assert _flip_share(lm_t > 0, lm_j > 0) <= 5e-3
