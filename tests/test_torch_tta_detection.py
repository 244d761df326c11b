"""The TTA-fused detection map of the PyTorch port against the JAX package:
the dihedral elements' affine index maps against ``transform_points``, and
the fused wrapper's plain version (what it runs on CPU tensors) against the
JAX composition -- per view the Pallas kernel (interpret mode) or the flax
DivClassifier head, then ``tta_scalar_map``'s pull-back and mean -- on
head planes whose padding holds large noise. The kernel itself runs only
on a card: ``tests/test_torch_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk
from mpp_cnn_rs_object_detection_torch.ops.dihedral import view_index_map
from mpp_cnn_rs_object_detection_tpu.models.unet import DivClassifier
from mpp_cnn_rs_object_detection_tpu.ops.dihedral import (
    D4_ELEMENTS,
    tta_scalar_map,
    transform_image,
    transform_points,
)
from mpp_cnn_rs_object_detection_tpu.ops.pallas_kernels import (
    detection_map_fused,
)
from tests._torch_util import noisy_view_planes, one_torch_thread  # noqa: F401

# float32 stencil arithmetic in a different association order than the
# Pallas body: the tolerance of tests/test_torch_detection_kernel.py
RTOL, ATOL = 1e-5, 1e-6
CLF_W, CLF_B = -3.5, 0.25


@pytest.mark.parametrize("element", D4_ELEMENTS)
@pytest.mark.parametrize("shape", [(70, 90), (2, 7), (33, 5)])
def test_view_index_map_matches_transform_points(shape, element):
    h, w = shape
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([ii.ravel(), jj.ravel()], axis=-1)
    a0, ai, aj, b0, bi, bj = view_index_map(*element, h, w)
    got = np.stack([a0 + ai * pts[:, 0] + aj * pts[:, 1],
                    b0 + bi * pts[:, 0] + bj * pts[:, 1]], axis=-1)
    np.testing.assert_array_equal(got, transform_points(pts, h, w, *element))
    # and the transformed image holds each pixel where the map says
    img = np.arange(h * w).reshape(h, w)
    np.testing.assert_array_equal(
        transform_image(img, *element)[got[:, 0], got[:, 1]], img.ravel())


def _jax_view_map(planes, crop, epilogue, mask_is_logit):
    """One view's map by the JAX package, from its cropped planes."""
    p = jnp.asarray(planes[:, :crop[0], :crop[1]])
    vec = jnp.moveaxis(p[:2], 0, -1)
    if epilogue == "detection":
        return np.asarray(detection_map_fused(vec, p[2], interpret=True,
                                              mask_is_logit=mask_is_logit))
    prob = jax.nn.sigmoid(p[2]) if mask_is_logit else p[2]
    params = {"Conv_0": {"kernel": jnp.full((1, 1, 1, 1), CLF_W, jnp.float32),
                         "bias": jnp.full((1,), CLF_B, jnp.float32)}}
    vm = jnp.concatenate([vec, prob[..., None]], axis=-1)
    return np.asarray(jax.nn.sigmoid(
        DivClassifier().apply({"params": params}, vm[None])[0]))


@pytest.mark.parametrize("n_views", [8, 1])
@pytest.mark.parametrize("epilogue", ["detection", "div_clf"])
@pytest.mark.parametrize("mask_is_logit", [True, False])
def test_tta_plain_matches_jax_composition(n_views, epilogue, mask_is_logit):
    h, w = 70, 90
    views = noisy_view_planes(h, w, D4_ELEMENTS[:n_views], pad=128, seed=5)
    if not mask_is_logit:
        for planes, (ch, cw), _ in views:
            planes[2, :ch, :cw] = 1.0 / (1.0 + np.exp(-planes[2, :ch, :cw]))
    maps = [_jax_view_map(p, crop, epilogue, mask_is_logit)
            for p, crop, _ in views]
    if n_views == 8:
        it = iter(maps)
        want = tta_scalar_map(lambda _: next(it), np.zeros((h, w)))
    else:
        want = maps[0]
    got = dk.detection_map_tta(
        [dk.View(torch.from_numpy(p), crop, el) for p, crop, el in views],
        (h, w), mask_is_logit=mask_is_logit, epilogue=epilogue,
        clf_w=CLF_W, clf_b=CLF_B)
    assert got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_tta_wrapper_checks_views_on_the_cpu_too():
    views = [dk.View(torch.from_numpy(p), crop, el) for p, crop, el in
             noisy_view_planes(20, 24, D4_ELEMENTS, pad=32)]
    with pytest.raises(ValueError):  # crops of a (24, 20) frame expected
        dk.detection_map_tta(views, (24, 20))
    with pytest.raises(ValueError):
        dk.detection_map_tta(views + views[:1], (20, 24))
    with pytest.raises(ValueError):
        dk.detection_map_tta(views, (20, 24), epilogue="nope")
    thin = [dk.View(torch.zeros((3, 4, 24)), (1, 24))]
    with pytest.raises(ValueError, match="at least 2"):
        dk.detection_map_tta(thin, (1, 24))
    before = dk.KERNEL.launches
    dk.detection_map_tta(views, (20, 24))
    assert dk.KERNEL.launches == before and dk.KERNEL._fn is None
