"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips (with a reason) where no CUDA device is
present. This file imports neither JAX nor the JAX package, so it also runs
on a GPU host without them:
``python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk

# fp32 stencil arithmetic in another association order than the plain
# composition (sqrt/div/exp are IEEE / few-ulp on both sides)
RTOL, ATOL = 1e-5, 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", ["detection", "div_clf"])
@pytest.mark.parametrize("mask_is_logit", [True, False])
def test_detection_map_kernel_matches_plain(epilogue, mask_is_logit):
    _need_cuda()
    rng = np.random.default_rng(3)
    for shape in [(8, 256, 256), (3, 469, 753), (1, 2, 64), (37, 2)]:
        vec = torch.from_numpy(rng.normal(size=shape + (2,)).astype(
            np.float32)).cuda()
        mask = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda()
        before = dk.KERNEL.launches
        got = dk.detection_map(vec, mask, mask_is_logit=mask_is_logit,
                               epilogue=epilogue, clf_w=-2.0, clf_b=0.5)
        torch.cuda.synchronize()
        assert dk.KERNEL.launches == before + 1
        want = dk.detection_map_plain(vec, mask, mask_is_logit, epilogue,
                                      -2.0, 0.5)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        planes = dk.detection_map((vec[..., 0].contiguous(),
                                   vec[..., 1].contiguous()), mask,
                                  mask_is_logit=mask_is_logit,
                                  epilogue=epilogue, clf_w=-2.0, clf_b=0.5)
        torch.testing.assert_close(planes, got, rtol=0, atol=0)


@pytest.mark.gpu
def test_detection_map_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    vec = torch.zeros((16, 16, 2), device="cuda", dtype=torch.float64)
    mask = torch.zeros((16, 16), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        dk.detection_map(vec, mask)
    vec = torch.zeros((16, 16, 2), device="cuda")
    with pytest.raises(ValueError):
        dk.detection_map(vec, torch.zeros((16, 16)))  # mask on the CPU
    with pytest.raises(ValueError):
        dk.detection_map(vec[:1], torch.zeros((1, 16), device="cuda"))
    with pytest.raises(ValueError):
        dk.detection_map(vec.transpose(0, 1), torch.zeros((16, 16),
                                                           device="cuda"))
