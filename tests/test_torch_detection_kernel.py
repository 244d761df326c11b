"""Detection-map stencil of the PyTorch port: the plain version (what the
CUDA wrapper runs on CPU tensors) against the JAX package's Pallas kernel
(interpret mode) and its jnp reference, and the DivClassifier epilogue
against the flax DivClassifier head. The kernel itself runs only on a card:
``tests/test_torch_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk
from mpp_cnn_rs_object_detection_tpu.models.unet import DivClassifier
from mpp_cnn_rs_object_detection_tpu.ops.pallas_kernels import (
    detection_map_fused,
    detection_map_reference,
)
from tests._torch_util import one_torch_thread  # noqa: F401

# float32 stencil arithmetic in a different association order than the
# Pallas body: the tolerance of tests/test_pallas_kernels.py
RTOL, ATOL = 1e-5, 1e-6


def _inputs(shape=(64, 96), seed=0):
    rng = np.random.default_rng(seed)
    vec = rng.normal(size=shape + (2,)).astype(np.float32)
    mask = rng.normal(size=shape).astype(np.float32)
    return vec, mask


@pytest.mark.parametrize("mask_is_logit", [True, False])
@pytest.mark.parametrize("shape", [(64, 96), (2, 7), (33, 5)])
def test_detection_epilogue_matches_pallas(shape, mask_is_logit):
    vec, mask = _inputs(shape)
    m = mask if mask_is_logit else np.array(jax.nn.sigmoid(mask))
    want = np.asarray(detection_map_fused(
        jnp.asarray(vec), jnp.asarray(m), interpret=True,
        mask_is_logit=mask_is_logit))
    got = dk.detection_map(torch.from_numpy(vec), torch.from_numpy(m),
                           mask_is_logit=mask_is_logit).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref = np.asarray(detection_map_reference(jnp.asarray(vec),
                                             jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_planar_input_and_batch_match_channels_last():
    vec, mask = _inputs((3, 20, 30), seed=1)
    v, mk = torch.from_numpy(vec), torch.from_numpy(mask)
    whole = dk.detection_map(v, mk)
    planes = dk.detection_map((v[..., 0], v[..., 1]), mk)
    np.testing.assert_array_equal(whole.numpy(), planes.numpy())
    for b in range(3):
        np.testing.assert_array_equal(
            whole[b].numpy(), dk.detection_map(v[b], mk[b]).numpy())


@pytest.mark.parametrize("mask_is_logit", [True, False])
def test_div_clf_epilogue_matches_flax_head(mask_is_logit):
    vec, mask = _inputs((48, 40), seed=2)
    prob = np.array(jax.nn.sigmoid(mask))
    w, b = -3.5, 0.25
    params = {"Conv_0": {"kernel": jnp.full((1, 1, 1, 1), w, jnp.float32),
                         "bias": jnp.full((1,), b, jnp.float32)}}
    vm = jnp.concatenate([jnp.asarray(vec), jnp.asarray(prob)[..., None]],
                         axis=-1)
    want = np.asarray(jax.nn.sigmoid(
        DivClassifier().apply({"params": params}, vm[None])[0]))
    m = mask if mask_is_logit else prob
    got = dk.detection_map(torch.from_numpy(vec), torch.from_numpy(m),
                           mask_is_logit=mask_is_logit, epilogue="div_clf",
                           clf_w=w, clf_b=b).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cpu_call_does_not_launch_or_build():
    before = dk.KERNEL.launches
    vec, mask = _inputs((8, 8))
    dk.detection_map(torch.from_numpy(vec), torch.from_numpy(mask))
    assert dk.KERNEL.launches == before
    assert dk.KERNEL._fn is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    vec, mask = _inputs((8, 8))
    with pytest.raises(ValueError):
        dk.detection_map(torch.from_numpy(vec[..., :1]), torch.from_numpy(mask))
    with pytest.raises(ValueError):
        dk.detection_map(torch.from_numpy(vec), torch.from_numpy(mask),
                         epilogue="nope")
