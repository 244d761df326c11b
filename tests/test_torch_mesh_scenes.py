"""The meshes at the scene level and through the command line, on the CPU
(a mesh of the port may repeat a device, so ``[cpu] * n`` runs n bands or
groups): ``run_exact_scene`` in 2 row bands equals its one-band run,
``run_tiled_scene`` with its tiles split over 2 devices equals the unsplit
run for both samplers (as ``tests/test_figures_viewer.py:127`` holds the
JAX package's tile mesh), ``run_exact_scenes_batched`` with B = 4 scenes
over 2 devices equals one device, and ``-p infereval`` on a copy of
``mpp_r2`` (``scene_mesh: true``, which the port refused until the meshes
were ported) writes the pickles of the same copy without the mesh, and two
overlay PNGs per scene."""

import json
import pickle

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.mpp import scene as tsc
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
    NoCalibrationEnergySetup,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
from mpp_cnn_rs_object_detection_torch.ops.mappings import default_mappings
from mpp_cnn_rs_object_detection_torch.utils.png import read_png
from tests import _torch_workspace as tw
from tests._torch_util import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
DATASET, SHAPE, N_IMAGES, N_RECT, SEED = "mesh_synth", (128, 128), 2, 10, 5
# the CLI's depth cut: one segment of 20 supersteps per scene
SEGMENT_SUPER = 20


def _scene(h, w, centers, seed=0, c=8):
    """A blob scene with its maps and labels (numpy), as the port reads
    one."""
    gy, gx = np.mgrid[:h, :w]
    det = np.zeros((h, w))
    for ctr in centers:
        det += np.exp(-((gy - ctr[0]) ** 2 + (gx - ctr[1]) ** 2)
                      / (2 * 2.0 ** 2))
    det = np.clip(det, 0, 1).astype(np.float32)
    dist = np.full((h, w, c), 1.0 / c, np.float32)
    dist[..., 3] = 3.0 / c
    dist /= dist.sum(-1, keepdims=True)
    centers = np.asarray(centers, np.float32)
    n = len(centers)
    # the marks at the classes the distributions favour (bin centers)
    marks = np.tile(np.asarray([[7.0, 0.4375, 1.3744467]], np.float32),
                    (n, 1))
    return ImageWMaps(
        image=np.stack([det] * 3, -1), name=f"s{seed}", shape=(h, w),
        detection_map=det, param_dist_maps=[dist] * 3,
        mappings=default_mappings(n_classes=c, size_min=0, size_max=16),
        labels={"centers": centers,
                "parameters": np.tile(np.asarray([[3.0, 7.0, 0.3]],
                                                 np.float32), (n, 1)),
                "categories": np.zeros((n,), np.int32),
                "difficult": np.zeros((n,), bool)},
        gt_centers=centers, gt_marks=marks)


def _setup(data):
    setup = NoCalibrationEnergySetup()
    setup.calibrate([data], np.random.default_rng(0), save_path="")
    return setup, tcomb.sum_combiner(setup.spec.names)


def _same(a, b):
    np.testing.assert_array_equal(a.centers, b.centers)
    np.testing.assert_array_equal(a.marks, b.marks)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.supersteps == b.supersteps


# rows 126-131 straddle the 2-band border of the 192 bucket (row 96)
EXACT_CENTERS = [(20, 30), (94, 60), (99, 63), (150, 120), (60, 140)]


@pytest.mark.parametrize("moves", [{}, {"split_merge": True}])
def test_exact_scene_in_row_bands(moves):
    """``run_exact_scene`` (160 x 160, bucket 192 either way) over
    ``[cpu] * 2``: the same detections, scores and supersteps as without a
    mesh, over two segments."""
    params = RJMCMCParams(n_steps=12 * 40, alpha_t=0.99, n_samples=0,
                          samples_interval=1)
    out = []
    for mesh in (None, [CPU] * 2):
        data = _scene(160, 160, EXACT_CENTERS)
        setup, comb = _setup(data)
        out.append(tsc.run_exact_scene(
            data, setup, comb, params, seed=3, capacity=64,
            segment_size=12 * 20, device="cpu", mesh=mesh, **moves))
    assert out[0].supersteps == 40 and len(out[0].centers) > 0
    assert out[0].chain.maps.position.shape[-2:] == (192, 192)
    _same(*out)


@pytest.mark.parametrize("sampler", ["sequential", "parallel"])
def test_tile_mesh_equals_unsplit(sampler):
    """A 64 x 64 scene in 9 tiles of 32 px: the tiles in 2 groups on
    ``[cpu] * 2`` (5 and 4) give the unsplit run's detections and scores,
    the sequential chain's post-burn-in samples included."""
    params = RJMCMCParams(n_steps=120, alpha_t=0.98, n_samples=1,
                          samples_interval=8)
    out = []
    for mesh in (None, [CPU] * 2):
        data = _scene(64, 64, [(16, 16), (44, 40), (16, 48)])
        setup, comb = _setup(data)
        out.append(tsc.run_tiled_scene(
            data, setup, comb, params, seed=9, patch_size=32,
            min_overlap=8, capacity=8, sampler=sampler, segment_size=64,
            device="cpu", mesh=mesh))
    assert out[0].n_tiles == 9 and len(out[0].centers) > 0
    if sampler == "sequential":
        assert out[0].samples == out[1].samples > 0
    _same(*out)


def test_batch_mesh_equals_one_device():
    """B = 4 scenes of 128 x 128 over ``[cpu] * 2`` (2 groups of 2 lanes;
    a mesh of 3 uses 2, the largest divisor of 4) equal one device: each
    scene's detections, scores and accepts by kind."""
    params = RJMCMCParams(n_steps=12 * 30, alpha_t=0.99, n_samples=0,
                          samples_interval=1)
    out = []
    for mesh in (None, [CPU] * 2, [CPU] * 3):
        datas = [_scene(128, 128, [(20 + 10 * i, 30), (90, 70 + 5 * i)],
                        seed=i) for i in range(4)]
        setup, comb = _setup(datas[0])
        out.append(tsc.run_exact_scenes_batched(
            datas, setup, comb, params, seeds=[1, 2, 3, 4], capacity=64,
            segment_size=12 * 15, device="cpu", mesh=mesh))
    for got in out[1:]:
        for a, b in zip(out[0], got):
            _same(a, b)
            assert a.accepted_by_kind == b.accepted_by_kind
    assert sum(len(r.centers) for r in out[0]) > 0


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tw.workspace(tmp_path_factory.mktemp("torch_mesh") / "ws")
    make_synth_dataset(name=DATASET, n_items=N_IMAGES, shape=SHAPE,
                       n_rect=N_RECT, seed=SEED, base_dir=str(ws / "data"))
    for subset in ("train", "val"):
        tw.oracle_pickles(ws, DATASET, subset, N_IMAGES, SHAPE)
    return ws


def mpp_r2_copy(ws, name, **inference):
    """``mpp_r2`` on the oracle maps, cut to one segment of
    ``SEGMENT_SUPER`` supersteps per scene; returns the config's path."""
    cfg = tw.mpp_config("mpp_r2", name, DATASET)
    cfg["inference"].update(segment_size=12 * SEGMENT_SUPER, **inference)
    # a 128 px scene: 3 x 3 cells, 4 proposals per superstep
    cfg["inference"]["rjmcmc_params"]["stopping"] = {
        "kind": "max_iter", "max_iter": SEGMENT_SUPER * 4}
    path = ws / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def results_dir(ws, name):
    return ws / "data" / "inference" / DATASET / "val" / name


def test_mpp_r2_cli_runs_with_one_device(workspace):
    """``-p infereval -m mpp`` on a copy of ``mpp_r2`` with ``device="cpu"``
    (one device: the scene mesh is a no-op there, as in the JAX package):
    one segment per scene, finite APs, and the result pickles of the same
    copy with ``scene_mesh: false``; each scene's two overlays have the
    scene's shape."""
    models = {}
    for name, mesh in (("r2_mesh", True), ("r2_plain", False)):
        path = mpp_r2_copy(workspace, name, scene_mesh=mesh)
        with tw.inside(workspace):
            models[name] = t_main(["-p", "infereval", "-m", "mpp", "-c",
                                   str(path)], device="cpu")
    assert tmm.mesh_for_scene(models["r2_mesh"].config, CPU, 128) is None
    for r in models["r2_mesh"].results.values():
        assert (r.supersteps, r.stopped) == (SEGMENT_SUPER, True)
    for i in range(N_IMAGES):
        pk = [pickle.load(open(results_dir(workspace, n)
                               / f"{i:04}_results.pkl", "rb"))
              for n in models]
        for key in ("detection", "detection_center", "detection_score",
                    "detection_params", "detection_marks"):
            np.testing.assert_array_equal(pk[0][key], pk[1][key])
        for kind in ("detection", "gt"):
            img = read_png(str(results_dir(workspace, "r2_mesh")
                               / f"{i:04}_{kind}.png"))
            assert img.shape == SHAPE + (3,) and img.dtype == np.uint8
    m = json.loads((results_dir(workspace, "r2_mesh") / "dota"
                    / "metrics0.50.json").read_text())
    assert np.isfinite(m["vehicle"]["ap"])


def test_mesh_for_scene_follows_jax():
    """The JAX package's choice with 4 visible devices: exact mode takes
    ``min(4, rows // CELL)`` row bands (also for ``tile_mesh``), tiled mode
    every device, and one device is no mesh."""
    cfg = {"inference": {"scene_mode": "exact", "scene_mesh": True}}
    four = (CPU,) * 4
    pick = tmm.mesh_for_scene
    orig = tmm.visible_mesh
    try:
        tmm.visible_mesh = lambda device: four
        assert pick(cfg, CPU, 958) == four
        assert pick(cfg, CPU, 64) == (CPU,) * 2
        assert pick(cfg, CPU, 40) is None
        cfg["inference"].update(scene_mesh=False, tile_mesh=True)
        assert pick(cfg, CPU, 958) == four
        cfg["inference"]["scene_mode"] = "tiled"
        assert pick(cfg, CPU, 40) == four
        cfg["inference"]["tile_mesh"] = False
        assert pick(cfg, CPU, 958) is None
    finally:
        tmm.visible_mesh = orig
    assert tmm.visible_mesh(CPU) == (CPU,)
