"""The port's energy-weight training against the JAX package: every
combiner kind's ``combine`` and regulariser on the same parameters, their
JSON across the packages, both criteria's losses and gradients on the same
vectors, whole trainings of 20 optimiser steps (Adam with the exponential
decay, and SGD) on the same vectors, the laned energy vectors of GT and
perturbed configurations, the gaussian perturbation presets' laws, and the
ordering criterion training on real perturbations."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import image_data as tid
from mpp_cnn_rs_object_detection_torch.mpp import perturbations as tpert
from mpp_cnn_rs_object_detection_torch.mpp import train_weights as ttw
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState as TState,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp import energy_setups as jes
from mpp_cnn_rs_object_detection_tpu.mpp import image_data as jid
from mpp_cnn_rs_object_detection_tpu.mpp import perturbations as jpert
from mpp_cnn_rs_object_detection_tpu.mpp import train_weights as jtw
from mpp_cnn_rs_object_detection_tpu.mpp.state import PointsState as JState
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401

H = W = 48
C = 8
# per-point combined energies (float32, another library)
COMB_ATOL = 1e-6
# losses and gradients: float32 sums over (B, S, K) in another order
GRAD_ATOL = 1e-5
# parameters after 20 optimiser steps
PARAM_ATOL = 1e-4
# laned energy vectors against one configuration at a time (the quad
# clipping's float32 sums in another order)
VEC_ATOL = 1e-5
NO_CALIB = jes.NO_CALIB_NAMES + ("RatioPriorEnergy",)
KINDS = ["sum", "manual_hierarchical", "hierarchical", "hierarchical_fixed",
         "logistic", "linear", "mlp", "mlp_raw"]


def _jax_combiner(kind, seed=0):
    """A JAX combiner of ``kind`` with seeded parameters off their initial
    values."""
    rng = np.random.default_rng(seed)
    if kind in ("hierarchical", "hierarchical_fixed"):
        names = jes.LEGACY_NAMES
    else:
        names = NO_CALIB
    if kind == "manual_hierarchical":
        c = jcomb.manual_hierarchical(
            names, {n: float(rng.uniform(0.1, 1)) for n in names},
            threshold=0.1)
    elif kind == "hierarchical_fixed":
        c = jcomb.hierarchical_fixed(names, [0.7, 0.3], [0.5, 0.2, 0.3],
                                     [0.6, 0.4], threshold=-0.2, bias=0.05)
    elif kind.startswith("mlp"):
        c = jcomb.mlp(names, hidden_features=6,
                      raw_energy=kind == "mlp_raw")
    else:
        c = jcomb.init_combiner(kind, names)
    params = {k: (v if k in jtw.NON_TRAINABLE or kind == "sum"
                  else v + jnp.asarray(rng.normal(0, 0.3, v.shape),
                                       jnp.float32))
              for k, v in c.params.items()}
    return c.replace(params=params)


def _vectors(n_energies, shape=(2, 3, 10), seed=1):
    rng = np.random.default_rng(seed)
    vec = rng.normal(0, 1, shape + (n_energies,)).astype(np.float32)
    alive = rng.uniform(size=shape) < 0.7
    return vec, alive


def _j_combine(c, vec):
    flat = vec.reshape(-1, *vec.shape[-2:])
    return jax.vmap(lambda v: jcomb.combine(c, v))(flat).reshape(
        vec.shape[:-1])


@pytest.mark.parametrize("kind", KINDS)
def test_combiner_matches_jax(kind, tmp_path):
    """``combine`` on (B, S, K, E) vectors and ``regularisation`` on the
    JAX parameters carried across by ``combiner_from_dict``; the JSON each
    package writes loads in the other with the same energies."""
    jc = _jax_combiner(kind)
    tc = tcomb.combiner_from_dict(jcomb.combiner_to_dict(jc))
    vec, _ = _vectors(len(jc.names))
    want = np.asarray(_j_combine(jc, jnp.asarray(vec)))
    got = tcomb.combine(tc, torch.from_numpy(vec)).numpy()
    np.testing.assert_allclose(got, want, atol=COMB_ATOL, rtol=COMB_ATOL)
    np.testing.assert_allclose(float(tcomb.regularisation(tc)),
                               float(jcomb.regularisation(jc)),
                               atol=COMB_ATOL)
    tcomb.save_combiner(str(tmp_path / "t.json"), tc)
    jcomb.save_combiner(str(tmp_path / "j.json"), jc)
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    back = jcomb.load_combiner(str(tmp_path / "t.json"))
    np.testing.assert_array_equal(np.asarray(_j_combine(back,
                                                        jnp.asarray(vec))),
                                  want)
    there = tcomb.load_combiner(str(tmp_path / "j.json"))
    np.testing.assert_array_equal(tcomb.combine(there,
                                                torch.from_numpy(vec)).numpy(),
                                  got)
    assert tcomb.combiner_as_report_dict(tc).keys() == \
        jcomb.combiner_as_report_dict(jc).keys()


@pytest.mark.parametrize("kind", ["sum", "hierarchical", "logistic",
                                  "linear"])
def test_initial_combiners_match_jax(kind):
    names = jes.LEGACY_NAMES if kind == "hierarchical" else NO_CALIB
    assert tcomb.combiner_to_dict(tcomb.init_combiner(kind, names)) == \
        jcomb.combiner_to_dict(jcomb.init_combiner(kind, names))


def _t_leaf(c):
    return c.replace(params={
        k: v.clone().requires_grad_(k not in ttw.NON_TRAINABLE)
        for k, v in c.params.items()})


def _jax_loss(criterion, jc, vecs, reg_weight):
    """The JAX train steps' loss, written as ``train_ordering_criterion``
    and ``train_integral_criterion`` write it."""
    def u(c, vec, alive):
        return jnp.sum(jnp.where(alive, _j_combine(c, vec), 0.0), axis=-1)

    def loss_fn(p):
        c = jc.replace(params=p)
        if criterion == "ordering":
            vec_gt, alive_gt, vec_pert, alive_pert = vecs
            loss = -jnp.mean(u(c, vec_pert, alive_pert)
                             - u(c, vec_gt, alive_gt)[:, None])
            if reg_weight:
                loss = loss + reg_weight * jcomb.regularisation(c)
            return loss
        e_plus = jnp.mean(u(c, vecs[0], vecs[1]))
        e_minus = jnp.mean(u(c, vecs[2], vecs[3]))
        loss = e_plus - e_minus
        if reg_weight:
            loss = loss + reg_weight * (e_plus ** 2 + e_minus ** 2)
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(jc.params)
    return float(loss), jtw._masked_grads(grads)


@pytest.mark.parametrize("criterion", ["ordering", "integral"])
@pytest.mark.parametrize("kind,reg_weight", [
    ("logistic", 0.0), ("hierarchical", 0.1), ("linear", 0.0),
    ("mlp", 0.05)])
def test_loss_and_gradients_match_jax(criterion, kind, reg_weight):
    jc = _jax_combiner(kind, seed=2)
    tc = _t_leaf(tcomb.combiner_from_dict(jcomb.combiner_to_dict(jc)))
    e = len(jc.names)
    if criterion == "ordering":
        v_gt, a_gt = _vectors(e, (2, 10), seed=3)
        v_p, a_p = _vectors(e, (2, 3, 10), seed=4)
        vecs = (v_gt, a_gt, v_p, a_p)
        loss_t = ttw.ordering_loss
    else:
        vecs = _vectors(e, (2, 3, 10), seed=5) + _vectors(e, (2, 3, 10),
                                                          seed=6)
        loss_t = ttw.integral_loss
    want, want_g = _jax_loss(criterion, jc,
                             [jnp.asarray(x) for x in vecs], reg_weight)
    loss = loss_t(tc, *[torch.from_numpy(x) for x in vecs],
                  reg_weight=reg_weight)
    trained = [k for k, v in tc.params.items() if v.requires_grad]
    grads = ttw._masked_grads(tc.params, dict(zip(trained, torch.autograd.grad(
        loss, [tc.params[k] for k in trained], allow_unused=True))))
    np.testing.assert_allclose(float(loss.detach()), want, atol=GRAD_ATOL,
                               rtol=GRAD_ATOL)
    assert grads.keys() == want_g.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want_g[k]),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL,
                                   err_msg=k)


# ------------------------------------------------------------- crops


def _crops(pkg, n=4, n_obj=6, seed=0):
    """Crops with Gaussian blobs at their GT centers (the JAX package's
    ``tests/test_weight_training.py`` crops), in package ``pkg``."""
    rng = np.random.default_rng(seed)
    mod = tid if pkg == "torch" else jid
    mappings = (t_mappings if pkg == "torch" else j_mappings)(C, 0, 16)
    crops = []
    gy, gx = np.mgrid[:H, :W]
    for i in range(n):
        centers = rng.integers(8, H - 8, size=(n_obj, 2)).astype(np.float32)
        marks = np.stack([rng.uniform(4, 10, n_obj),
                          rng.uniform(0.3, 0.8, n_obj),
                          rng.uniform(0, np.pi, n_obj)], -1).astype(
            np.float32)
        det = np.zeros((H, W), np.float32)
        for c in centers:
            det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / 8.0)
        dist = rng.dirichlet(np.ones(C), size=(H, W)).astype(np.float32)
        crops.append(mod.ImageWMaps(
            image=rng.random((H, W, 3)).astype(np.float32), name=f"c{i}",
            shape=(H, W), detection_map=np.clip(det, 0, 1),
            param_dist_maps=[dist] * 3, mappings=mappings, labels={},
            gt_centers=centers, gt_marks=marks))
    return crops


def _setup(pkg):
    es = tes if pkg == "torch" else jes
    setup = es.NoCalibrationEnergySetup(ratio_prior=True)
    setup.calibrate(_crops(pkg), np.random.default_rng(0), save_path=None)
    return setup


# the same fake perturbations and vectors in both packages: functions of
# the GT configuration and the sample index only


def _fake_vec(xy, marks, alive, lib):
    e = len(NO_CALIB)
    cols = [lib.sin(0.07 * (i + 1) * xy[..., 0] + 0.03 * xy[..., 1])
            + 0.1 * marks[..., i % 3] for i in range(e)]
    vec = lib.stack(cols, -1)
    return lib.where(alive[..., None], vec, 0.0 * vec)


def _offset(s, preset=None):
    return (0.5 if preset is None else 0.05 * preset["position_sigma"]) * (
        s + 1)


def _fake_pert_j(gt, n_samples, preset=None):
    s = jnp.arange(n_samples)
    k = jnp.arange(gt.xy.shape[0])
    return JState(
        xy=gt.xy[None] + _offset(s, preset)[:, None, None],
        marks=jnp.broadcast_to(gt.marks[None], (n_samples,) + gt.marks.shape),
        alive=gt.alive[None] & (k[None] % (s[:, None] + 2) != 0))


def _fake_pert_t(gt, n_samples, preset=None):
    s = torch.arange(n_samples)
    k = torch.arange(gt.xy.shape[-2])
    b = gt.xy.shape[0]
    return TState(
        xy=gt.xy[:, None] + _offset(s, preset)[None, :, None, None],
        marks=gt.marks[:, None].expand(b, n_samples, *gt.marks.shape[1:]),
        alive=gt.alive[:, None] & (k % (s[:, None] + 2) != 0)[None])


def _fake_jax(monkeypatch):
    monkeypatch.setattr(jtw, "sample_kernel_perturbed_batch",
                        lambda key, gt, kd, n_moves, n: _fake_pert_j(gt, n))
    monkeypatch.setattr(jtw, "sample_perturbed_batch",
                        lambda key, gt, kd, hw, preset, n: _fake_pert_j(
                            gt, n, preset))
    monkeypatch.setattr(jtw, "energy_vectors", lambda st, maps, spec:
                        _fake_vec(st.xy, st.marks, st.alive, jnp))
    monkeypatch.setattr(jtw, "_chunked_energy_vectors", lambda st, maps, spec:
                        _fake_vec(st.xy, st.marks, st.alive, jnp))


def _fake_torch(monkeypatch):
    monkeypatch.setattr(ttw, "sample_kernel_perturbed_batch",
                        lambda gen, gt, kd, n_moves, n: _fake_pert_t(gt, n))
    monkeypatch.setattr(ttw, "sample_perturbed_batch",
                        lambda gen, gt, kd, hw, preset, n: _fake_pert_t(
                            gt, n, preset))
    monkeypatch.setattr(ttw, "lane_energy_vectors", lambda st, maps, spec:
                        _fake_vec(st.xy, st.marks, st.alive, torch))


@pytest.mark.parametrize("criterion,kind,optim", [
    ("ordering", "logistic", "adam"), ("ordering", "hierarchical", "sgd"),
    ("integral", "logistic", "adam"), ("integral", "linear", "adam")])
def test_training_matches_jax(monkeypatch, criterion, kind, optim):
    """Both packages' trainers, fed the same vectors: 4 crops in batches
    of 2 for 10 epochs (the same ``rng.permutation`` per epoch), 20 steps
    with the learning rate decayed by 0.9 per step; the parameters
    agree."""
    _fake_jax(monkeypatch)
    _fake_torch(monkeypatch)
    kw = dict(logger=None, save_dir=None, n_epochs=10, samples_per_image=3,
              learning_rate=0.05, optim=optim, weight_model_type=kind,
              lr_scheduler=True, lr_scheduler_params={"gamma": 0.9},
              batch_size=2, capacity=16, reg_weight=0.01, device="cpu")
    fn = "train_ordering_criterion" if criterion == "ordering" else \
        "train_integral_criterion"
    jc = getattr(jtw, fn)(_crops("jax"), _setup("jax"),
                          rng=np.random.default_rng(4), **kw)
    seconds = {}
    tc = getattr(ttw, fn)(_crops("torch"), _setup("torch"),
                          rng=np.random.default_rng(4), seconds=seconds, **kw)
    want = jcomb.combiner_to_dict(jc)["params"]
    got = tcomb.combiner_to_dict(tc)["params"]
    init = jcomb.combiner_to_dict(jcomb.init_combiner(kind, jc.names))[
        "params"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                   err_msg=k)
    assert max(np.abs(np.subtract(got[k], init[k])).max() for k in got
               if k not in ttw.NON_TRAINABLE) > 1e-3
    assert set(seconds) == set(ttw.TRAIN_STAGES)


# ------------------------------------------------------ vectors, laws


def test_lane_energy_vectors_match_jax():
    """GT and two kernel-perturbed samples of each of 2 crops as one laned
    call, against the JAX package's one configuration at a time."""
    tcrops, jcrops = _crops("torch", n=2), _crops("jax", n=2)
    ts, js = _setup("torch"), _setup("jax")
    maps_b, kd_b, gt_b = ttw.prepare_batch(tcrops, ts, 32, "cpu")
    pert = tpert.sample_kernel_perturbed_batch(
        torch.Generator().manual_seed(0), gt_b, kd_b, 6, 2)
    both = TState(xy=torch.cat([gt_b.xy[:, None], pert.xy], 1),
                  marks=torch.cat([gt_b.marks[:, None], pert.marks], 1),
                  alive=torch.cat([gt_b.alive[:, None], pert.alive], 1))
    got = ten.lane_energy_vectors(both, maps_b, ts.spec)
    assert got.shape == (2, 3, 32, len(NO_CALIB))
    for b in range(2):
        jmaps = js.make_maps(jcrops[b])
        for s in range(3):
            st = JState(xy=jnp.asarray(both.xy[b, s].numpy()),
                        marks=jnp.asarray(both.marks[b, s].numpy()),
                        alive=jnp.asarray(both.alive[b, s].numpy()))
            np.testing.assert_allclose(
                got[b, s].numpy(), np.asarray(jen.energy_vectors(
                    st, jmaps, js.spec)), atol=VEC_ATOL, rtol=VEC_ATOL)
    # the samples moved away from GT, each its own way
    assert not torch.equal(pert.xy[:, 0], pert.xy[:, 1])


def test_kernel_perturbations_keep_gt_and_stay_valid():
    tcrops = _crops("torch")
    maps_b, kd_b, gt_b = ttw.prepare_batch(tcrops, _setup("torch"), 16, "cpu")
    gt_copy = TState(xy=gt_b.xy.clone(), marks=gt_b.marks.clone(),
                     alive=gt_b.alive.clone())
    pert = tpert.sample_kernel_perturbed_batch(
        torch.Generator().manual_seed(1), gt_b, kd_b, 12, 5)
    assert pert.xy.shape == (4, 5, 16, 2)
    for f in ("xy", "marks", "alive"):
        assert torch.equal(getattr(gt_b, f), getattr(gt_copy, f))
    xy, marks = pert.xy[pert.alive], pert.marks[pert.alive]
    assert bool((xy >= 0).all() and (xy < H + 1).all())
    assert bool((marks[:, 0] >= 0).all() and (marks[:, 0] <= 16).all())
    assert bool((marks[:, 2] >= 0).all() and (marks[:, 2] <= np.pi).all())
    changed = (pert.xy != gt_b.xy[:, None]).any(-1) | (
        pert.alive != gt_b.alive[:, None])
    assert changed.any(-1).all()


@pytest.mark.parametrize("preset", ["light", "medium", "strong"])
def test_gaussian_presets_follow_jax_laws(preset):
    """400 gaussian perturbations of one GT configuration in each package:
    the mean point count, the share of GT points kept in place, and the
    mean mark shift agree within 5 standard errors."""
    n = 400
    tcrop, jcrop = _crops("torch", n=1)[0], _crops("jax", n=1)[0]
    maps_b, kd_b, gt_b = ttw.prepare_batch([tcrop], _setup("torch"), 16,
                                           "cpu")
    t = tpert.sample_perturbed_batch(torch.Generator().manual_seed(2), gt_b,
                                     kd_b, (H, W), tpert.PRESETS[preset], n)
    _, jkd, jgt = jtw.prepare_batch([jcrop], _setup("jax"), 16)
    j = jax.jit(lambda k: jpert.sample_perturbed_batch(
        k, jax.tree_util.tree_map(lambda x: x[0], jgt),
        jax.tree_util.tree_map(lambda x: x[0], jkd), (H, W),
        jpert.PRESETS[preset], n))(jax.random.PRNGKey(2))

    def stats(xy, marks, alive, gxy, gmarks, galive):
        still = (alive & galive & (np.abs(xy - gxy).sum(-1) == 0)).sum(-1)
        shift = np.where(alive & galive, np.abs(marks - gmarks).sum(-1),
                         0.0).sum(-1)
        return alive.sum(-1).astype(float), still.astype(float), shift

    g = [x[0].numpy() for x in (gt_b.xy, gt_b.marks, gt_b.alive)]
    st = stats(t.xy[0].numpy(), t.marks[0].numpy(), t.alive[0].numpy(), *g)
    sj = stats(np.asarray(j.xy), np.asarray(j.marks), np.asarray(j.alive),
               *g)
    for a, b in zip(st, sj):
        se = np.sqrt(a.var() / n + b.var() / n) + 1e-9
        assert abs(a.mean() - b.mean()) <= 5 * se, (a.mean(), b.mean(), se)
    if preset == "light":
        assert st[0].max() <= 6


def test_ordering_criterion_learns_separation():
    """The port's trainer on real perturbations and vectors: the weights
    move, and kernel perturbations of GT then raise the combined energy on
    average."""
    crops, setup = _crops("torch"), _setup("torch")
    comb = ttw.train_ordering_criterion(
        crops, setup, logger=None, save_dir=None,
        rng=np.random.default_rng(2), n_epochs=3, samples_per_image=4,
        batch_size=2, capacity=16, device="cpu")
    report = tcomb.combiner_as_report_dict(comb)
    assert max(abs(v - 1.0) for k, v in report.items()
               if k.endswith("_weight")) > 1e-3, report
    maps_b, kd_b, gt_b = ttw.prepare_batch(crops, setup, 16, "cpu")
    vec_gt, alive_gt, vec_p, alive_p = ttw.ordering_vectors(
        torch.Generator().manual_seed(9), maps_b, kd_b, gt_b, setup.spec,
        6, 4, ttw._Stages(None, "cpu"))
    with torch.no_grad():
        assert float(ttw.ordering_loss(comb, vec_gt, alive_gt, vec_p,
                                       alive_p)) < 0.0


@pytest.mark.parametrize("fn", ["train_ordering_criterion",
                                "train_integral_criterion"])
def test_trainers_default_to_the_card(monkeypatch, fn):
    """Called without a device, a trainer runs on the CUDA device: with
    none present it raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(ttw, fn)(_crops("torch", n=2), _setup("torch"), logger=None,
                         save_dir=None, rng=np.random.default_rng(0),
                         n_epochs=1, batch_size=2, capacity=16)
