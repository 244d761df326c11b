"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips (with a reason) where no CUDA device is
present. This file imports neither JAX nor the JAX package, so it also runs
on a GPU host without them:
``python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk
from mpp_cnn_rs_object_detection_torch.ops.dihedral import D4_ELEMENTS
# by its own name: pytest puts this directory on sys.path, and a GPU host
# may have another package named ``tests`` installed
from _torch_util import noisy_view_planes

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


def _cuda_views(h, w, elements, pad, seed=0, pitch_extra=0):
    return [dk.View(torch.from_numpy(p).cuda(), crop, el) for p, crop, el in
            noisy_view_planes(h, w, elements, pad, seed, pitch_extra)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_views", [8, 1])
@pytest.mark.parametrize("epilogue", ["detection", "div_clf"])
@pytest.mark.parametrize("mask_is_logit", [True, False])
def test_tta_kernel_matches_plain(n_views, epilogue, mask_is_logit):
    """Noise-filled padding around every crop; frames whose sides are not
    tile multiples, a pitch wider than the pad, and 2-row / 2-column
    crops (the one-sided differences on both edges of a view)."""
    _need_cuda()
    elements = D4_ELEMENTS[:n_views]
    cases = [((70, 90), 128, 0), ((300, 173), 320, 8), ((2, 37), 40, 4),
             ((41, 2), 44, 0)]
    for seed, ((h, w), pad, extra) in enumerate(cases):
        views = _cuda_views(h, w, elements, pad, seed, extra)
        if not mask_is_logit:
            for v in views:
                v.planes[2] = torch.sigmoid(v.planes[2])
        kw = dict(mask_is_logit=mask_is_logit, epilogue=epilogue,
                  clf_w=-2.0, clf_b=0.5)
        before = dk.KERNEL.launches
        got = dk.detection_map_tta(views, (h, w), **kw)
        torch.cuda.synchronize()
        assert dk.KERNEL.launches == before + 1
        assert got.shape == (h, w)
        want = dk.detection_map_tta_plain(views, (h, w), **kw)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_tta_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    views = _cuda_views(20, 24, D4_ELEMENTS, 32)
    # a row pitch that is not a multiple of 4
    odd = [dk.View(torch.zeros((3, 20, 30), device="cuda"), (20, 24))]
    with pytest.raises(ValueError, match="pitch"):
        dk.detection_map_tta(odd, (20, 24))
    with pytest.raises(TypeError):
        dk.detection_map_tta([v._replace(planes=v.planes.double())
                              for v in views], (20, 24))
    with pytest.raises(ValueError):  # one view's planes on the CPU
        dk.detection_map_tta(views[:7] + [views[7]._replace(
            planes=views[7].planes.cpu())], (20, 24))
    thin = [dk.View(torch.zeros((3, 32, 32), device="cuda"), (1, 24))]
    with pytest.raises(ValueError, match="at least 2"):
        dk.detection_map_tta(thin, (1, 24))
    with pytest.raises(ValueError):  # a crop that is not the view's frame
        dk.detection_map_tta(views, (24, 20))


@pytest.mark.gpu
def test_cnn_train_step_on_the_card_matches_the_cpu(tmp_path, monkeypatch):
    """One PosNet train step (augmentation, targets, DivClassifier head,
    adam) in float32 with TF32 off, from the same state, batch and
    variates on the card and on the CPU."""
    _need_cuda()
    import json
    import os

    from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
        AugmentVariates,
        draw_augment_variates,
    )
    from mpp_cnn_rs_object_detection_torch.data.synth import (
        make_synth_dataset,
    )
    from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
        PosNetModel,
    )
    from mpp_cnn_rs_object_detection_torch.models.train_utils import (
        recentred_bias,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(tmp_path / "data")],
         "model_path": [str(tmp_path / "models")]}))
    make_synth_dataset(name="tiny", n_items=2, shape=(128, 128), n_rect=60,
                       seed=0, base_dir=str(tmp_path / "data"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "model_configs", "posnet",
                           "pos_r2cp.json")) as f:
        cfg = json.load(f)
    cfg["model_name"] = "gpu_step"
    cfg["data_loader"]["dataset"] = "tiny"
    cfg["data_loader"]["patch_maker_params"].update(
        patch_size=64, n_patches=64, val_patches=64)
    cfg["trainer"]["batch_size"] = 16
    model = PosNetModel(cfg, device="cuda", train=True)
    card, cpu = model.train_replica("cuda"), model.train_replica("cpu")
    idx = torch.arange(16, device="cuda")
    batch = model.train_stack.batch(idx, int(model.train_stack.counts.max()))
    v = draw_augment_variates(torch.Generator("cuda").manual_seed(0), 16,
                              64, "cuda")
    got = card.train_batch(batch, v)
    want = cpu.train_batch(tuple(t.cpu() for t in batch),
                           AugmentVariates(*(t.cpu() for t in v)))
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=1e-6)
    for name, p in cpu.state.params.items():
        # one adam step of at most the learning rate (1e-3): the two
        # devices' float32 gradient sums part far less than a step, but
        # for the re-centred biases, which follow float noise
        tol = 2e-3 if recentred_bias(name) else 1e-4
        diff = card.state.params[name].detach().cpu() - p.detach()
        assert float(diff.abs().max()) <= tol, name
