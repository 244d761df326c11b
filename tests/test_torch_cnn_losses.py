"""The CNN losses of the PyTorch port against the JAX package's: the same
seeded numpy inputs through ``models/losses.py`` of both packages (the
port takes channels-first outputs), values and gradients, over the
options the configs use; and the DivClassifier head under autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.models import losses as tl
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_from_jax,
)
from mpp_cnn_rs_object_detection_torch.models.unet import DivClassifier
from mpp_cnn_rs_object_detection_tpu.models import losses as jl
from mpp_cnn_rs_object_detection_tpu.models.unet import (
    DivClassifier as JDivClassifier,
)

from _torch_util import one_torch_thread  # noqa: F401

B, H, W = 2, 12, 10
# float32 reductions over a few hundred elements in another order
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _pos_inputs(seed):
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    vec = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    mask = (rng.random((B, H, W)) < 0.3).astype(np.float32)
    vec *= mask[..., None]
    div = rng.normal(size=(B, H, W)).astype(np.float32)
    center = np.where(rng.random((B, H, W)) < 0.1,
                      rng.random((B, H, W)), 0.0).astype(np.float32)
    return out, vec, mask, div, center


POS_CASES = [
    dict(),
    dict(vec_loss_on_prod=True, focal_loss=True),
    dict(vec_loss_on_prod=False, compute_mask=True),
    dict(vec_loss_on_prod=False, compute_mask=False, balanced_mask_loss=False),
    dict(learn_mask=False),
    dict(with_div=True, vec_loss_on_prod=True),
    dict(with_div=True, focal_loss=True),
    dict(with_div=True, balanced_mask_loss=False, vec_loss_on_prod=False),
]


@pytest.mark.parametrize("case", range(len(POS_CASES)))
def test_pointing_vector_loss_matches_jax(case):
    kw = dict(POS_CASES[case])
    with_div = kw.pop("with_div", False)
    kw.setdefault("vec_loss_on_prod", True)
    out, vec, mask, div, center = _pos_inputs(case)
    target_mask = mask if kw.get("learn_mask", True) else None

    def jloss(o, d):
        return jl.pointing_vector_loss(
            o, vec, target_mask=target_mask,
            div_score=d if with_div else None,
            center_bin_map=center if with_div else None, **kw)

    want = jloss(out, div)
    g_out, g_div = jax.grad(lambda o, d: jloss(o, d)["loss"],
                            argnums=(0, 1))(out, div)

    t_out = _to_nchw(out).requires_grad_(True)
    t_div = torch.from_numpy(div).requires_grad_(True)
    got = tl.pointing_vector_loss(
        t_out, torch.from_numpy(vec),
        target_mask=None if target_mask is None
        else torch.from_numpy(target_mask),
        div_score=t_div if with_div else None,
        center_bin_map=torch.from_numpy(center) if with_div else None, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **VAL_TOL)
    got["loss"].backward()
    np.testing.assert_allclose(t_out.grad.numpy(),
                               np.moveaxis(np.asarray(g_out), -1, 1),
                               **GRAD_TOL)
    if with_div:
        np.testing.assert_allclose(t_div.grad.numpy(), np.asarray(g_div),
                                   **GRAD_TOL)


@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_pixel_ce_loss_matches_jax(focal, sigma):
    rng = np.random.default_rng(int(focal) * 2 + int(sigma))
    n_cls = 8
    logits = [rng.normal(size=(B, H, W, n_cls)).astype(np.float32)
              for _ in range(3)]
    targets = [rng.integers(0, n_cls, (B, H, W)).astype(np.int32)
               for _ in range(3)]
    lm = rng.random((B, H, W)).astype(np.float32)
    lm /= lm.sum(axis=(1, 2), keepdims=True)
    kw = dict(focal_loss=focal, focal_alpha=0.5, focal_gamma=2.0,
              label_smoothing_sigma=sigma)

    want = jl.pixel_ce_loss(logits, targets, lm, **kw)
    g = jax.grad(lambda ls: jl.pixel_ce_loss(ls, targets, lm, **kw)["loss"])(
        logits)

    t_logits = [_to_nchw(x).requires_grad_(True) for x in logits]
    got = tl.pixel_ce_loss(t_logits,
                           [torch.from_numpy(t).long() for t in targets],
                           torch.from_numpy(lm), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **VAL_TOL)
    got["loss"].backward()
    for t, gj in zip(t_logits, g):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.moveaxis(np.asarray(gj), -1, 1),
                                   **GRAD_TOL)


def test_div_head_matches_jax_under_autograd():
    """The DivClassifier head on ``concat(vec, sigmoid(mask))`` and its
    gradients with respect to its input and its two parameters."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    target = (rng.random((B, H, W)) < 0.2).astype(np.float32)
    head = JDivClassifier()
    params = head.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))[
        "params"]

    def jloss(p, xx):
        score = head.apply({"params": p}, xx)
        return jl._balanced_bce(score, target, True), score

    (want, score), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)

    t_head = DivClassifier()
    t_head.load_state_dict(params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, params)}))
    tx = torch.from_numpy(x).requires_grad_(True)
    t_score = t_head(tx)
    got = tl._balanced_bce(t_score, torch.from_numpy(target), True)
    np.testing.assert_allclose(t_score.detach().numpy(), np.asarray(score),
                               **VAL_TOL)
    np.testing.assert_allclose(got.item(), float(want), **VAL_TOL)
    got.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(
        t_head.Conv_0.weight.grad.numpy().reshape(()),
        np.asarray(gp["Conv_0"]["kernel"]).reshape(()), **GRAD_TOL)
    np.testing.assert_allclose(
        t_head.Conv_0.bias.grad.numpy().reshape(()),
        np.asarray(gp["Conv_0"]["bias"]).reshape(()), **GRAD_TOL)
