"""The baseline detectors' functions and modules in the PyTorch port against
the JAX package's, on the CPU at tiny sizes (depth 18-50, width 8, 32-96
px, float32) from seeded numpy inputs:

  - anchors, the box codec, ``box_iou``, ``masked_nms`` and
    ``select_proposals`` (the same keep sets and indices; bf16 logits with
    ties included), ``roi_align`` and its gradient, the RPN and ROI
    targets and losses;
  - ``ctrbox_targets``, ``focal_loss``, ``ctrbox_loss`` and
    ``ctrbox_decode`` (tied zero scores included);
  - ResNet-18/34/50, FPN and ``CombinationModule`` forwards in eval and
    train mode (BatchNorm statistics included);
  - both detectors on the checked-in JAX-trained ``*_quick`` weights,
    loaded into both packages at float32: the forwards and ``_detect``.

Tolerances: rtol 1e-4 + atol 1e-5 for elementwise parts; sums and deep
forwards are held relative to their largest magnitude, with the reason
beside each.
"""

import json
import os
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from mpp_cnn_rs_object_detection_torch.models import backbones as tbb
from mpp_cnn_rs_object_detection_torch.models import bbavec_arch as tba
from mpp_cnn_rs_object_detection_torch.models import fasterrcnn_arch as tfa
from mpp_cnn_rs_object_detection_torch.models import fasterrcnn_model as tfm
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_from_jax,
    params_to_jax,
)
from mpp_cnn_rs_object_detection_torch.models.unet import init_like_flax_
from mpp_cnn_rs_object_detection_torch.ops.nms import nms as t_nms
from mpp_cnn_rs_object_detection_tpu.models import backbones as jbb
from mpp_cnn_rs_object_detection_tpu.models import bbavec_arch as jba
from mpp_cnn_rs_object_detection_tpu.models import fasterrcnn_arch as jfa
from mpp_cnn_rs_object_detection_tpu.models import fasterrcnn_model as jfm
from mpp_cnn_rs_object_detection_tpu.ops.nms import nms as j_nms

from _torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(ROOT, "artifacts", "models_storage")
RTOL, ATOL = 1e-4, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def close_scaled(got, want, tol, what=""):
    """|got - want| <= tol * max |want|: for sums and deep stacks whose
    float32 rounding scales with the largest term, not with each entry."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1.0), (what, err)


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, shape, hw=64.0, lo=2.0, hi=24.0):
    c = rng.uniform(0, hw, shape + (2,))
    s = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)


def gt_batch(rng, b, m, n_valid, hw=64.0):
    gt = random_boxes(rng, (b, m), hw)
    valid = np.zeros((b, m), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    return np.where(valid[..., None], gt, 0.0).astype(np.float32), valid


# ------------------------------------------------------------ box functions


def test_anchors_and_box_codec():
    rng = np.random.default_rng(0)
    fm = [(16, 12), (8, 6), (4, 3), (2, 2), (1, 1)]
    strides, sizes = (4, 8, 16, 32, 64), (4, 8, 16, 32, 64)
    ja = jfa.make_anchors(fm, strides, sizes, (0.5, 1.0, 2.0))
    ta = tfa.make_anchors(fm, strides, sizes, (0.5, 1.0, 2.0))
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    anchors = np.concatenate(ja)
    deltas = rng.normal(0, 2.5, anchors.shape).astype(np.float32)
    close(tfa.decode_boxes(t(anchors), t(deltas)),
          jfa.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas)),
          what="decode (exp clipped at +-4)")
    boxes = random_boxes(rng, (len(anchors),))
    close(tfa.encode_boxes(t(anchors), t(boxes)),
          jfa.encode_boxes(jnp.asarray(anchors), jnp.asarray(boxes)),
          what="encode")
    a, b = random_boxes(rng, (40,)), random_boxes(rng, (30,))
    close(tfa.box_iou(t(a), t(b)), jfa.box_iou(jnp.asarray(a),
                                               jnp.asarray(b)), what="iou")
    # the final host NMS of Faster R-CNN
    xyxy = random_boxes(rng, (60,))
    scores = np.round(rng.random(60), 2)
    assert t_nms(xyxy, scores, 0.3, return_index=True)[2] \
        == j_nms(xyxy, scores, 0.3, return_index=True)[2]


def _pool(rng, b, n, tied):
    boxes = random_boxes(rng, (b, n), hw=48.0, lo=4.0, hi=16.0)
    if tied:  # bf16 scores on a coarse grid: many exact ties
        scores = np.round(rng.normal(0, 1, (b, n)) * 4) / 4
    else:
        scores = rng.normal(0, 1, (b, n))
    valid = rng.random((b, n)) > 0.2
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize("tied", [False, True])
def test_masked_nms_keep_sets(tied):
    rng = np.random.default_rng(1 + tied)
    boxes, scores, valid = _pool(rng, 3, 96, tied)
    sdt = torch.bfloat16 if tied else torch.float32
    jdt = jnp.bfloat16 if tied else jnp.float32
    idx, kv = tfa.masked_nms(t(boxes), t(scores).to(sdt), t(valid), 0.5, 24)
    jnms = jax.jit(lambda b, sc, v: jfa.masked_nms(b, sc, v, 0.5, 24))
    for i in range(3):
        jidx, jkv = jnms(jnp.asarray(boxes[i]), jnp.asarray(scores[i], jdt),
                         jnp.asarray(valid[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(kv[i].numpy(), np.asarray(jkv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_select_proposals(dtype):
    """Per-level top-K, decode, clip, pool and NMS for a batch of 3 against
    JAX image by image: equal boxes, scores and valid flags. bf16 logits
    (the real configs') are full of ties."""
    rng = np.random.default_rng(3)
    hw = (64, 48)
    fm = [(-(-hw[0] // s), -(-hw[1] // s)) for s in tfm.FPN_STRIDES]
    anchors = jfa.make_anchors(fm, tfm.FPN_STRIDES, (4, 8, 16, 32, 64),
                               (0.5, 1.0, 2.0))
    n = sum(len(a) for a in anchors)
    logits = rng.normal(0, 2, (3, n)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (3, n, 4)).astype(np.float32)
    if dtype == "bfloat16":
        logits = np.round(logits * 8) / 8
        deltas = deltas.astype(ml_dtypes.bfloat16).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = tfa.select_proposals(t(logits).to(tdt), t(deltas).to(tdt),
                               [t(a) for a in anchors], hw, 64, 16)
    jsel = jax.jit(lambda lg, dl: jfa.select_proposals(lg, dl, anchors, hw,
                                                         64, 16))
    for i in range(3):
        want = jsel(jnp.asarray(logits[i], dtype),
                    jnp.asarray(deltas[i], dtype))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        assert got[2][i].any()
        close(got[0][i], want[0], what="proposals")
        np.testing.assert_array_equal(got[1][i].float().numpy(),
                                      np.asarray(want[1], np.float32))


def _levels(rng, b, c, hw=(64, 48)):
    return [rng.normal(0, 1, (b, -(-hw[0] // s), -(-hw[1] // s), c))
            .astype(np.float32) for s in (4, 8, 16, 32)]


def test_roi_align_and_gradient():
    """Boxes from 1 px to beyond the image, over all four levels (the FPN
    rule's boundaries included); the gradient of a weighted sum reaches
    only each box's level."""
    rng = np.random.default_rng(4)
    feats = _levels(rng, 2, 5)
    boxes = random_boxes(rng, (2, 40), hw=64.0, lo=1.0, hi=700.0)
    boxes[0, :4] = [[0, 0, 112, 112], [0, 0, 224, 224], [3, 3, 451, 451],
                    [10, 10, 10.5, 10.5]]
    w = rng.normal(0, 1, (2, 40, 7, 7, 5)).astype(np.float32)
    tf = [t(f).permute(0, 3, 1, 2).requires_grad_(True) for f in feats]
    rois = tfa.roi_align(tf, t(boxes), (4, 8, 16, 32))
    grads = torch.autograd.grad((rois * t(w)).sum(), tf)

    def jloss(fs):
        out = jnp.stack([jfa.roi_align([f[i] for f in fs],
                                       jnp.asarray(boxes[i]), (4, 8, 16, 32))
                         for i in range(2)])
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    close(rois, want, what="rois")
    for g, jg in zip(grads, jgrads):
        close(g.permute(0, 2, 3, 1), jg, what="grad")


def test_rpn_and_roi_targets_and_losses():
    rng = np.random.default_rng(5)
    hw = (64, 48)
    fm = [(-(-hw[0] // s), -(-hw[1] // s)) for s in tfm.FPN_STRIDES]
    anchors = np.concatenate(jfa.make_anchors(
        fm, tfm.FPN_STRIDES, (4, 8, 16, 32, 64), (0.5, 1.0, 2.0)))
    gt, gv = gt_batch(rng, 3, 10, (10, 4, 0), hw=48.0)
    logits = rng.normal(0, 2, (3, len(anchors))).astype(np.float32)
    deltas = rng.normal(0, 0.3, (3, len(anchors), 4)).astype(np.float32)
    lab, matched = tfa.rpn_targets(t(anchors), t(gt), t(gv), 0.5, 0.25)
    cls, reg = tfa.rpn_loss(t(logits), t(deltas), t(anchors), t(gt), t(gv),
                            pos_iou=0.5, neg_iou=0.25)
    jl, jm = jax.jit(jax.vmap(lambda g, v: jfa.rpn_targets(
        jnp.asarray(anchors), g, v, 0.5, 0.25)))(gt, gv)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    close(matched, jm, what="matched")
    jc, jr = jax.jit(jax.vmap(lambda lg, dl, g, v: jfa.rpn_loss(
        lg, dl, jnp.asarray(anchors), g, v, pos_iou=0.5, neg_iou=0.25)))(
            logits, deltas, gt, gv)
    # sums over ~600 anchors in another order
    close(cls, jc, rtol=1e-5, atol=1e-6, what="rpn cls")
    close(reg, jr, rtol=1e-5, atol=1e-6, what="rpn reg")
    props = random_boxes(rng, (3, 16), hw=48.0)
    props[:, :6] = gt[:, :6] + rng.normal(0, 1, (3, 6, 4))
    valid = rng.random((3, 16)) > 0.2
    rcls = rng.normal(0, 1, (3, 16, 2)).astype(np.float32)
    rreg = rng.normal(0, 0.2, (3, 16, 4)).astype(np.float32)
    labels, tm, pos = tfa.roi_targets(t(props), t(valid), t(gt), t(gv))
    c2, r2 = tfa.roi_loss(t(rcls), t(rreg), t(props), labels, tm, pos,
                          t(valid))
    jl, jm, jp = jax.jit(jax.vmap(jfa.roi_targets))(props, valid, gt, gv)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    close(tm, jm, what="roi matched")
    jc, jr = jax.jit(jax.vmap(jfa.roi_loss))(rcls, rreg, props, jl, jm, jp,
                                             valid)
    close(c2, jc, what="roi cls")
    close(r2, jr, what="roi reg")
    assert pos.any()


# ------------------------------------------------------------------ CTRBOX


def _marks(rng, b, m, n_valid, p):
    cen = rng.uniform(0, p, (b, m, 2)).astype(np.float32)
    par = np.stack([rng.uniform(2, 6, (b, m)), rng.uniform(3, 14, (b, m)),
                    rng.uniform(0, np.pi, (b, m))], -1).astype(np.float32)
    par[0, 0, 2] = 0.0  # a horizontal box: cls_theta 0
    val = np.zeros((b, m), bool)
    for i, n in enumerate(n_valid):
        val[i, :n] = True
    return cen, par, val


def test_ctrbox_targets_losses_and_decode():
    rng = np.random.default_rng(6)
    p = 32
    cen, par, val = _marks(rng, 3, 12, (12, 5, 0), p)
    tt = tba.ctrbox_targets(t(cen), t(par), t(val), (p, p), 4)
    jt = jax.jit(jax.vmap(lambda c, q, v: jba.ctrbox_targets(
        c, q, v, (p, p), 4)))(cen, par, val)
    assert set(tt) == set(jt)
    for k in jt:
        close(tt[k], jt[k], what=k)
    outs = {k: rng.normal(0, 1.5, (3, p // 4, p // 4, c)).astype(np.float32)
            for k, c in tba.HEADS.items()}
    touts = {k: t(v).permute(0, 3, 1, 2) for k, v in outs.items()}
    got = tba.ctrbox_loss(touts, tt)
    want = jax.jit(jax.vmap(jba.ctrbox_loss))(outs, jt)
    for k in want:
        # sums over the 8 x 8 heatmap and the objects
        close(got[k], want[k], rtol=1e-5, atol=1e-6, what=k)
    close(tba.focal_loss(touts["hm"][:, 0], tt["hm"]),
          jax.jit(jax.vmap(jba.focal_loss))(outs["hm"][..., 0], jt["hm"]),
          rtol=1e-5, atol=1e-6, what="focal")

    # decode: a map with flat plateaus (tied maxima) and more K than peaks
    dec = {k: v[0].copy() for k, v in outs.items()}
    dec["hm"][2:5, 2:5] = 3.0
    dec["hm"][6:, :] = -50.0
    for k in (500, 7):
        tg = tba.ctrbox_decode({kk: t(v).permute(2, 0, 1)
                                for kk, v in dec.items()}, k=k)
        jg = jax.jit(partial(jba.ctrbox_decode, k=k))(dec)
        for a, b in zip(tg, jg):
            close(a, b, what=f"decode k={k}")


# ---------------------------------------------------------------- backbones


def _variables(module, seed):
    """``module`` initialised as flax would (``init_like_flax_``), its
    BatchNorm running statistics drawn off their initial values, and the
    same variables as a flax tree (numpy leaves) for the JAX module."""
    init_like_flax_(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                b.add_(torch.rand(b.shape, generator=gen) * 0.6 + 0.2)
    return params_to_jax(module.state_dict())


def _bn_stats(mutated):
    return params_from_jax({"batch_stats": mutated["batch_stats"]})


def _check_stats(tmod, jstats, what):
    sd = tmod.state_dict()
    for k, v in jstats.items():
        if "running" in k:
            close(sd[k], v.numpy(), what=f"{what} {k}")


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_resnet_fpn_forward(depth):
    """ResNet + FPN in eval mode (running statistics drawn off their
    initial values) and train mode (batch statistics; the running ones
    updated), flax SAME padding on a 64 x 96 input."""
    rng = np.random.default_rng(depth)
    x = rng.random((2, 64, 96, 3)).astype(np.float32)
    jres = jbb.ResNet(depth=depth, width=8)
    tres = tbb.ResNet(depth=depth, width=8)
    v = _variables(tres, depth)
    assert tres.out_channels == jres.out_channels
    tres.eval()
    want = jax.jit(partial(jres.apply, train=False))(v, jnp.asarray(x))
    got = tres(t(x).permute(0, 3, 1, 2))
    for i, (g, w) in enumerate(zip(got, want)):
        close_scaled(g.permute(0, 2, 3, 1), w, 1e-5, f"C{i + 2} eval")
    # train mode: batch statistics over as few as 2 x 3 x 2 values per
    # channel (C5) amplify float32 rounding layer by layer, JAX's as much
    # as the port's; both are held to JAX's float64 forward, the port no
    # further from it than JAX's own float32 forward is
    tres.train(True)
    want, mut = jax.jit(partial(jres.apply, train=True, mutable=[
        "batch_stats"]))(v, jnp.asarray(x))
    got = tres(t(x).permute(0, 3, 1, 2))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        want64 = jax.jit(partial(
            jbb.ResNet(depth=depth, width=8, dtype=jnp.float64).apply,
            train=True, mutable=["batch_stats"]))(
                v64, jnp.asarray(x, jnp.float64))[0]
        want64 = [np.asarray(w) for w in want64]
    for i, (g, w, w64) in enumerate(zip(got, want, want64)):
        own = np.abs(np.asarray(w, np.float64) - w64).max()
        err = np.abs(g.permute(0, 2, 3, 1).detach().numpy() - w64).max()
        assert err <= own + 1e-6, (f"C{i + 2} train", err, own)
    _check_stats(tres, _bn_stats(mut), "resnet")
    feats = [rng.normal(0, 1, (2, 64 // s, 96 // s, c)).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), tres.out_channels)]
    jfpn = jbb.FPN(out_channels=16)
    tfpn = tbb.FPN(tres.out_channels, 16)
    fv = _variables(tfpn, 1)
    got = tfpn([t(f).permute(0, 3, 1, 2) for f in feats])
    want = jax.jit(jfpn.apply)(fv, [jnp.asarray(f) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close_scaled(g.permute(0, 2, 3, 1), w, 1e-5, "fpn")


def test_combination_module_odd_sizes():
    """The decoder block on a skip of odd size (the upsample cropped)."""
    rng = np.random.default_rng(7)
    deep = rng.normal(0, 1, (2, 3, 4, 12)).astype(np.float32)
    skip = rng.normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    jm = jbb.CombinationModule(6)
    tm = tbb.CombinationModule(12, 6, 6)
    v = _variables(tm, 0)
    for train in (False, True):
        tm.train(train)
        want, mut = jax.jit(partial(
            jm.apply, train=train, mutable=["batch_stats"] if train else []))(
                v, jnp.asarray(deep), jnp.asarray(skip))
        got = tm(t(deep).permute(0, 3, 1, 2), t(skip).permute(0, 3, 1, 2))
        close_scaled(got.permute(0, 2, 3, 1), want, 1e-5, f"comb {train}")
        if train:
            _check_stats(tm, _bn_stats(mut), "comb")


# -------------------------------------------------- checked-in quick weights


def _quick(kind, name):
    with open(os.path.join(STORE, kind, name, "config.json")) as f:
        cfg = json.load(f)
    cfg["model"]["dtype"] = "float32"
    # the floor of model_configs/*/*_quick.json
    cfg["inference"] = {"min_confidence": 0.02}
    return cfg


@pytest.fixture(scope="module")
def quick_store(tmp_path_factory):
    """A workspace whose model store links the checked-in ``*_quick``
    directories (read only: the models load, nothing is written there)."""
    ws = tmp_path_factory.mktemp("quick_ws")
    for kind, name in (("fasterrcnn", "fasterrcnn_quick"),
                       ("bbavec", "bbavec_quick")):
        os.makedirs(ws / "models" / kind)
        os.symlink(os.path.join(STORE, kind, name),
                   ws / "models" / kind / name)
    (ws / "data").mkdir()
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    return ws


def _scene(seed, h, w):
    from mpp_cnn_rs_object_detection_torch.data.synth import synthetic_scene

    return synthetic_scene(h, w, 40, seed=seed)[0].astype(np.float32)


@pytest.mark.parametrize("kind", ["fasterrcnn", "bbavec"])
def test_quick_weights_forward_and_detect(kind, quick_store, monkeypatch):
    """The JAX-trained ``*_quick`` checkpoint in both packages at float32:
    ``params_from_jax`` gives the port's state_dict, the forward on a
    synthetic scene agrees, and ``_detect`` returns the same detections
    (scores within 1e-4 of each other; those within 1e-4 of the floor
    may fall on either side of it)."""
    name = f"{kind}_quick"
    monkeypatch.chdir(quick_store)
    cfg = _quick(kind, name)
    tcls = tfm.FasterRCNNModel if kind == "fasterrcnn" else tfm.BBAVecModel
    tm = tcls(dict(cfg), device="cpu", load=True, train=False)
    # the JAX model's network and detection code, its weights read by
    # flax (its own constructor would first initialise the network
    # eagerly, which costs the CPU tests tens of seconds)
    with open(os.path.join(STORE, kind, name, "model.msgpack"), "rb") as f:
        ck = serialization.msgpack_restore(f.read())
    jm = jfm.FasterRCNNModel.__new__(
        jfm.FasterRCNNModel if kind == "fasterrcnn" else jfm.BBAVecModel)
    jm.config = cfg
    jm._build_net()
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    jm.state = SimpleNamespace(**variables)
    sd = params_from_jax(variables)
    own = tm.net.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy(), err_msg=k)
    assert tm.last_epoch == int(ck["epoch"])
    # fasterrcnn_quick holds the chain's optimizer state, which the port
    # restores; bbavec_quick predates the chain (plain adam's layout), so
    # both packages restore its weights only
    chained = kind == "fasterrcnn"
    assert tm.state.opt.count == (int(ck["opt_state"]["1"]["0"]["count"])
                                  if chained else 0)

    img = _scene(11, 100 if kind == "fasterrcnn" else 90, 120)
    x = np.pad(img, ((0, 28), (0, 8), (0, 0)))[None]
    with torch.no_grad():
        got = tm.net(t(x).permute(0, 3, 1, 2))
    want = jax.jit(partial(jm.net.apply, train=False))(variables,
                                                       jnp.asarray(x))
    if kind == "fasterrcnn":
        for g, w in zip(got[0], want[0]):
            # 18 layers deep, trained weights
            close_scaled(g.permute(0, 2, 3, 1), w, 1e-5, "feature")
        close_scaled(got[1], want[1], 1e-5, "rpn logits")
        close_scaled(got[2], want[2], 1e-5, "rpn deltas")
    else:
        for k in want:
            # 34 layers deep, trained weights
            close_scaled(got[k].permute(0, 2, 3, 1), want[k], 1e-5, k)

    floor = cfg["inference"]["min_confidence"]
    tol = 1e-4
    jd = jm._detect(img, floor)
    td = tm._detect(img, floor)
    scores_j = np.asarray(jd[1] if kind == "fasterrcnn" else jd[0])
    scores_t = np.asarray(td[1] if kind == "fasterrcnn" else td[0])
    geo_j = np.asarray(jd[0] if kind == "fasterrcnn" else jd[1])
    geo_t = np.asarray(td[0] if kind == "fasterrcnn" else td[1])
    keep_j = scores_j >= floor + tol
    keep_t = scores_t >= floor + tol
    assert keep_j.sum() == keep_t.sum() > 0
    oj, ot = np.argsort(-scores_j[keep_j]), np.argsort(-scores_t[keep_t])
    np.testing.assert_allclose(scores_t[keep_t][ot], scores_j[keep_j][oj],
                               rtol=0, atol=tol)
    # boxes / quads in pixels of a ~120 px image
    np.testing.assert_allclose(geo_t[keep_t][ot], geo_j[keep_j][oj],
                               rtol=0, atol=1e-2)
