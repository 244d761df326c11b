"""Batched exact scenes, restarts, polish and refine of the PyTorch port.

A batch of B scenes is one laned program: at equal capacity each scene of
the batch equals its single-scene run, draw for draw (the JAX package's
contract, ``tests/test_batched_scenes.py``). Restarts are lanes over one
scene: the kept lane has the least energy and lane 0 is the one-lane run.
Polish and refine are deterministic given the chain's output, so they are
held to the JAX functions on the same inputs."""

import os
import shutil

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import rjmcmc as trj
from mpp_cnn_rs_object_detection_torch.mpp.combinators import EnergyCombiner
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
    NoCalibrationEnergySetup,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.polish import polish_state
from mpp_cnn_rs_object_detection_torch.mpp.refine import (
    snap_centers_to_map,
)
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
from mpp_cnn_rs_object_detection_torch.mpp.scene import (
    run_exact_scene,
    run_exact_scenes_batched,
    segment_seed,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    expand_lanes,
    lane,
    state_from_arrays as t_state,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import default_mappings
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp import polish as jpolish
from mpp_cnn_rs_object_detection_tpu.mpp import refine as jrefine
from mpp_cnn_rs_object_detection_tpu.mpp import rjmcmc as jrj
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_default_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401

C = 8
# 320 moves at 0.98 -> the 64 px bucket's budget in segments of 128 moves
PARAMS = RJMCMCParams(n_steps=320, alpha_t=0.98, n_samples=0,
                      samples_interval=16)


def _scene(seed: int, n_obj: int = 6, hw=(64, 64)) -> ImageWMaps:
    """The scene of tests/test_batched_scenes.py, in the port's types."""
    rng = np.random.default_rng(seed)
    h, w = hw
    gy, gx = np.mgrid[:h, :w]
    centers = rng.integers(10, [h - 10, w - 10], size=(n_obj, 2)).astype(
        np.float32)
    det = np.zeros((h, w))
    for c in centers:
        det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / (2 * 2.0**2))
    det = np.clip(det, 0, 1).astype(np.float32)
    dist = np.full((h, w, C), 1.0, np.float32)
    dist[..., 3] = 6.0
    dist /= dist.sum(-1, keepdims=True)
    marks = np.tile(np.asarray([[5.0, 0.5, 0.3]], np.float32), (n_obj, 1))
    return ImageWMaps(
        image=np.stack([det] * 3, -1), name=f"s{seed}", shape=(h, w),
        detection_map=det, param_dist_maps=[dist.copy() for _ in range(3)],
        mappings=default_mappings(C, 0, 16), labels={}, gt_centers=centers,
        gt_marks=marks)


def _energy_model(datas):
    setup = NoCalibrationEnergySetup()
    setup.calibrate(datas, None, save_path="")
    return setup, EnergyCombiner(kind="sum", names=setup.spec.names)


def _same(a, b):
    np.testing.assert_array_equal(a.centers, b.centers)
    np.testing.assert_array_equal(a.marks, b.marks)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_batched_matches_sequential():
    """Each scene of a B = 2 batch equals its single-scene run at equal
    capacity: centers, marks and scores identical."""
    setup, comb = _energy_model([_scene(1), _scene(2, n_obj=4)])
    seeds = [7, 11]
    seq = [run_exact_scene(d, setup, comb, PARAMS, seed=s, capacity=128,
                           segment_size=128, device="cpu")
           for d, s in zip([_scene(1), _scene(2, n_obj=4)], seeds)]
    bat = run_exact_scenes_batched([_scene(1), _scene(2, n_obj=4)], setup,
                                   comb, PARAMS, seeds=seeds, capacity=128,
                                   segment_size=128, device="cpu")
    assert len(bat) == len(seq) == 2
    for r_seq, r_bat in zip(seq, bat):
        assert len(r_seq.centers) > 0
        assert r_bat.capacity == r_seq.capacity == 128
        assert r_bat.supersteps == r_seq.supersteps == r_seq.planned_supersteps
        _same(r_bat, r_seq)
        assert float(r_bat.chain.energy) == float(r_seq.chain.energy)
    assert not np.array_equal(bat[0].centers, bat[1].centers)


def test_restarts_keep_the_least_energy_lane():
    setup, comb = _energy_model([_scene(3)])
    out = run_exact_scene(_scene(3), setup, comb, PARAMS, seed=5,
                          capacity=128, segment_size=128, restarts=3,
                          device="cpu")
    u = np.array(out.lane_energies)
    assert len(u) == 3 and len(np.unique(u)) == 3, u
    assert out.best_lane == int(np.argmin(u))
    # the kept configuration is the chain's lane of that energy
    st = t_state(out.centers, out.marks, 128)
    maps = setup.make_maps(_scene(3))
    e = float(ten.total_energy(st, maps, setup.spec, comb))
    np.testing.assert_allclose(e, u.min(), rtol=1e-4, atol=1e-4)
    assert float(out.chain.energy) == u.min()


def test_one_restart_is_the_one_lane_run():
    """``restarts: 1`` is the one-lane run (the batched entry on one scene,
    seeded ``segment_seed(seed, done)``), and lane 0 of more restarts
    draws what it draws."""
    setup, comb = _energy_model([_scene(4)])
    kw = dict(capacity=128, segment_size=128, device="cpu")
    one = run_exact_scene(_scene(4), setup, comb, PARAMS, seed=9, **kw)
    bat = run_exact_scenes_batched([_scene(4)], setup, comb, PARAMS,
                                   seeds=[9], **kw)[0]
    _same(one, bat)
    assert one.lane_energies == [float(one.chain.energy)]
    three = run_exact_scene(_scene(4), setup, comb, PARAMS, seed=9,
                            restarts=3, **kw)
    assert three.lane_energies[0] == one.lane_energies[0]
    assert segment_seed(9, 16) == segment_seed(9, 16, 0) == int(
        np.random.SeedSequence([9, 16]).generate_state(1, np.uint64)[0])
    assert segment_seed(9, 16, 1) != segment_seed(9, 16)


def test_restarts_checkpoint_pins_the_lane_count(tmp_path):
    """An interrupted restart run resumes to the uninterrupted run's
    result; its checkpoint's fingerprint holds the lane count, so a run
    with another ``restarts`` starts over. With no segment run (the budget
    cut to 0 segments), each lane's energy is recomputed."""
    setup, comb = _energy_model([_scene(5)])
    kw = dict(seed=2, capacity=128, segment_size=128, device="cpu")
    ck = str(tmp_path / "0000_chains.ck.npz")
    whole = run_exact_scene(_scene(5), setup, comb, PARAMS, restarts=2, **kw)
    first = run_exact_scene(_scene(5), setup, comb, PARAMS, restarts=2,
                            checkpoint_path=ck, max_segments=1, **kw)
    assert first.supersteps < whole.supersteps
    saved = np.load(ck)
    assert saved["xy"].shape[0] == 2 and saved["fingerprint"][8] == 2
    other = run_exact_scene(_scene(5), setup, comb, PARAMS, restarts=3,
                            checkpoint_path=str(tmp_path / "other.ck.npz"),
                            max_segments=1, **kw)
    assert len(other.lane_energies) == 3
    resumed = run_exact_scene(_scene(5), setup, comb, PARAMS, restarts=2,
                              checkpoint_path=ck, **kw)
    assert not os.path.exists(ck)
    _same(resumed, whole)
    assert resumed.lane_energies == whole.lane_energies
    shutil.copy(str(tmp_path / "other.ck.npz"), ck)
    fresh = run_exact_scene(_scene(5), setup, comb, PARAMS, restarts=2,
                            checkpoint_path=ck, max_segments=1, **kw)
    _same(fresh, first)  # the 3-lane file was not resumed
    none = run_exact_scene(_scene(5), setup, comb, PARAMS, restarts=2,
                           max_segments=0, **kw)
    assert none.supersteps == 0 and none.best_lane == 0
    assert none.lane_energies[0] == none.lane_energies[1]
    assert np.isfinite(none.lane_energies).all()


@pytest.mark.parametrize("option,value,item", [
    ("superstep_split_merge", True, None), ("superstep_move_switch", True, None),
    ("scene_mesh", True, None), ("batch_mesh", True, None),
    ("tile_mesh", True, None)])
def test_unported_options_still_raise(option, value, item):
    """No option raises any more: the superstep's split/merge pair and
    move switch are ported, and the meshes (which raised with ROADMAP.md
    item 15) too."""
    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm

    config = tmm.load_mpp_config("mpp_log_r12tta")
    tmm.check_inference_config(config)  # refine, blend, backfill: ported
    block = config["inference"]
    if option.startswith("superstep"):
        block = block["rjmcmc_params"]
    block[option] = value
    if item is None:
        tmm.check_inference_config(config)
        if option.startswith("superstep"):
            assert tmm.chain_options(config)[option[len("superstep_"):]]
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tmm.check_inference_config(config)


@pytest.mark.parametrize("name,item", [
    ("mpp_log_r8", None), ("mpp_log_r10", None), ("mpp_log_r10dd", None),
    ("mpp_log_r10pol", None), ("mpp_log_r10rst", None),
    ("mpp_log_r10tta", None), ("mpp_log_r11ls", None),
    ("mpp_log_r11lstta", None), ("mpp_log_r12tta", None),
    ("mpp_log_r10sm", None), ("mpp_log_r10ttasm", None)])
def test_trained_extension_configs(name, item):
    """The trained extension configs: the port accepts every switch they
    turn on (the split/merge pair of ``_r10sm`` and ``_r10ttasm`` too) and
    loads their trained energy model, or raises with the ROADMAP item of
    a switch it lacks."""
    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm

    config = tmm.load_mpp_config(name)
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tmm.check_inference_config(config)
        return
    tmm.check_inference_config(config)
    inf = config["inference"]
    opts = tmm.chain_options(config)
    assert opts["polish_steps"] == inf.get("polish_steps", 0)
    assert inf.get("refine_centers") and inf.get("backfill_threshold")
    setup, comb = tmm.load_energy_model(
        config, os.path.join(tmm.MODELS_ROOT, "mpp", config["model_name"]),
        "cpu")
    assert comb.names == setup.spec.names


# --- polish, against tests/test_polish.py's setup
H = W = 64
NAMES = ("position", "size", "ratio", "angle", "overlap", "align", "area")
SPEC_J = jen.EnergySpec(names=NAMES, shape_mode="separate",
                        rewarding_align=False)
SPEC_T = ten.EnergySpec(names=NAMES, shape_mode="separate",
                        rewarding_align=False)
# U of the same state through the two packages' float32 energies
U_RTOL = 1e-4
# the polished states after 40 Adam steps agree to 3.4e-5 px and 7.2e-6 in
# the marks (float32 gradients in another order); later, near the optimum,
# Adam's normalised step (lr * m / sqrt(v)) turns last-bit gradient
# differences into steps of up to lr, so the test stops at 40
XY_ATOL, MARK_ATOL = 1e-3, 1e-4


def _polish_inputs():
    gy, gx = np.mgrid[:H, :W]
    centers = np.array([(16.0, 16.0), (40.0, 40.0), (16.0, 48.0)],
                       np.float32)
    det = np.zeros((H, W))
    for c in centers:
        det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / (2 * 2.0**2))
    det = np.clip(det, 0, 1).astype(np.float32)
    ramp = np.arange(1, C + 1, dtype=np.float32)
    dist = np.broadcast_to(ramp / ramp.sum(), (H, W, C)).astype(np.float32)
    jm, tm = j_default_mappings(C, 0, 16), default_mappings(C, 0, 16)
    jmaps = jen.make_energy_maps(det, [-dist] * 3, 0.5, 4.0, 200.0, jm)
    tmaps = ten.make_energy_maps(det, [-torch.from_numpy(dist)] * 3, 0.5,
                                 4.0, 200.0, tm)
    xy0 = centers + np.asarray([[1.5, -1.5], [-1.5, 1.5], [1.5, 1.5]],
                               np.float32)
    marks0 = np.tile(np.asarray([[6.0, 0.5, 0.8]], np.float32), (3, 1))
    # a crowded pair too, so the overlap and alignment terms act
    xy0 = np.concatenate([xy0, [[42.5, 44.0]]]).astype(np.float32)
    marks0 = np.concatenate([marks0, [[5.0, 0.6, 1.4]]]).astype(np.float32)
    return jmaps, tmaps, xy0, marks0


def test_polish_matches_jax():
    jmaps, tmaps, xy0, marks0 = _polish_inputs()
    jc = jcomb.sum_combiner(NAMES)
    tc = EnergyCombiner(kind="sum", names=NAMES)
    js, ts = j_state(xy0, marks0, capacity=8), t_state(xy0, marks0, 8)
    j_out, (ju0, ju1) = jpolish.polish_state(js, jmaps, SPEC_J, jc,
                                             n_steps=40)
    t_out, (tu0, tu1) = polish_state(ts, tmaps, SPEC_T, tc, n_steps=40)
    np.testing.assert_allclose(float(tu0), float(ju0), rtol=U_RTOL)
    assert float(ju1) <= float(ju0) and float(tu1) <= float(tu0)
    assert float(tu1) < float(tu0) - 0.1  # it did descend
    np.testing.assert_allclose(float(tu1), float(ju1), rtol=U_RTOL,
                               atol=U_RTOL)
    np.testing.assert_allclose(t_out.xy.numpy(), np.asarray(j_out.xy),
                               atol=XY_ATOL)
    np.testing.assert_allclose(t_out.marks.numpy(), np.asarray(j_out.marks),
                               atol=MARK_ATOL)
    np.testing.assert_array_equal(t_out.alive.numpy(), np.asarray(
        j_out.alive))
    # the reported energy is the returned state's (safe distances)
    st1, maps1 = expand_lanes(t_out, 1), expand_lanes(tmaps, 1)
    cache = trj.build_cache(st1, maps1, SPEC_T, safe_dist=True)
    np.testing.assert_allclose(
        float(trj.energy_from_cache(st1, maps1, SPEC_T, tc, cache)[0]),
        float(tu1), rtol=1e-5, atol=1e-5)


def test_build_cache_safe_dist_matches_jax():
    jmaps, tmaps, xy0, marks0 = _polish_inputs()
    js, ts = j_state(xy0, marks0, capacity=8), t_state(xy0, marks0, 8)
    jca = jrj.build_cache(js, jmaps, SPEC_J, safe_dist=True)
    tca = lane(trj.build_cache(expand_lanes(ts, 1), expand_lanes(tmaps, 1),
                               SPEC_T, safe_dist=True), 0)
    for f in ("dist", "overlap", "align", "pos_e", "mark_e"):
        np.testing.assert_allclose(getattr(tca, f).numpy(),
                                   np.asarray(getattr(jca, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert float(tca.dist[0, 0]) == pytest.approx(1e-6)


def test_snap_centers_matches_jax():
    rng = np.random.default_rng(3)
    gy, gx = np.mgrid[:48, :40]
    det = np.zeros((48, 40))
    for c in rng.uniform(2, 38, (7, 2)):
        det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / 3.0)
    det = np.clip(det, 0, 1).astype(np.float32)
    centers = np.concatenate([rng.uniform(0, 40, (12, 2)),
                              [[0.2, 39.6], [47.4, 0.0], [100.0, 100.0]]]
                             ).astype(np.float32)
    got = snap_centers_to_map(centers, det)
    np.testing.assert_array_equal(got, jrefine.snap_centers_to_map(
        centers, det))
    assert not np.array_equal(got, centers)
    empty = np.zeros((0, 2), np.float32)
    assert snap_centers_to_map(empty, det) is empty
