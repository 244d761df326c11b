"""The port's tiled scene mode (``mpp/scene.py:run_tiled_scene``,
``mpp/image_data.py:split_image`` and ``merge_patch_results``) against the
JAX package's ``run_mpp_on_scene``.

Tiling and merging are held exactly. The pipeline around the chains --
per-tile papangelou, merge, global rescore, polish and export -- is held
by giving both packages' ``MPPModel.infer`` one deterministic chain
function (the chains' draws differ between the packages). The port's own
chain runs through the command line on oracle maps, resumes a killed scene
exactly, and ignores the JAX package's checkpoint."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import image_data as tid
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.mpp import rjmcmc as trj
from mpp_cnn_rs_object_detection_torch.mpp import scene as tsc
from mpp_cnn_rs_object_detection_torch.mpp.state import PointsState
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energy_setups as jes
from mpp_cnn_rs_object_detection_tpu.mpp import image_data as jid
from mpp_cnn_rs_object_detection_tpu.mpp import mpp_model as jmm
from mpp_cnn_rs_object_detection_tpu.mpp import rjmcmc as jrj
from mpp_cnn_rs_object_detection_tpu.mpp import scene as jsc
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests import _torch_workspace as tw
from tests._dota_util import dota_snapshot
from tests._torch_util import one_torch_thread  # noqa: F401

DATASET = "synth_tiled"
# 128 x 112 scenes in 96 px tiles with 32 px overlap: 2 x 2 tiles
N_IMAGES, SHAPE, N_RECT, SEED = 2, (128, 112), 24, 3
PATCH, N_TILES = 96, 4
# the depth cut: 64 burn-in moves + 2 intervals of 16 in segments of 40
BURN_IN, INTERVAL, SEGMENT = 64, 16, 40
TOTAL = BURN_IN + 2 * INTERVAL
# the tiles' final states through both packages' merge, rescore and
# export: float32 papangelou scores in another evaluation order
# (coordinates print at 0.1 px)
DET_ATOL = 1e-4
# the polish (60 Adam steps in mpp_r4p) parts float noise: Adam's first
# steps move a coordinate by a whole learning rate along the SIGN of its
# gradient, and some gradients sit at float-noise size, so a 1-ulp nudge of
# the polish input moves the JAX package's own output by a few 0.01 in a
# mark after one step. The polished output is held to the spread of the
# JAX package's polish of its own input nudged by 1 ulp (NUDGES seeds),
# widened by SPREAD_FACTOR.
NUDGES, SPREAD_FACTOR = 3, 2.0
# the one chain function of both packages: a fixed shift per segment
SHIFT = (0.25, -0.35)
TILED_CONFIGS = ("config_mpp_log", "mpp_log_quick", "mpp_hrcM", "mpp_quick",
                 "mpp_r3", "mpp_r4", "mpp_r4p", "mpp_r6", "mpp_verify_r2")


def _config(base, name, **inference):
    cfg = tw.mpp_config(base, name, DATASET, patch_size=PATCH)
    cfg["capacity"] = 32
    cfg["inference"].update(segment_size=SEGMENT, **inference)
    cfg["inference"]["rjmcmc_params"].update(
        burn_in=BURN_IN, samples_interval=INTERVAL, alpha_t=0.95)
    return cfg


def _results_dir(ws, model):
    return ws / "data" / "inference" / DATASET / "val" / model


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_tiled")
    ws_j = tw.workspace(base / "jax")
    ws_t = tw.workspace(base / "torch")
    make_synth_dataset(name=DATASET, n_items=N_IMAGES, shape=SHAPE,
                       n_rect=N_RECT, seed=SEED, base_dir=str(ws_j / "data"))
    tw.copy_dataset(ws_j, ws_t, DATASET)
    for ws in (ws_j, ws_t):
        for subset in ("train", "val"):
            tw.oracle_pickles(ws, DATASET, subset, N_IMAGES, SHAPE)
    return ws_j, ws_t


def _image(h, w, seed, n_labels=6):
    """One image with maps and labels, as (JAX, port) ImageWMaps."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    det = rng.uniform(size=(h, w)).astype(np.float32)
    dists = [rng.uniform(size=(h, w, 8)).astype(np.float32)
             for _ in range(3)]
    labels = {"centers": rng.uniform(0, [h, w], (n_labels, 2)),
              "parameters": np.tile([[6.0, 3.0, 0.5]], (n_labels, 1)),
              "categories": np.array(["small-vehicle"] * n_labels),
              "difficult": np.zeros(n_labels, bool)}
    out = []
    for mod, maps in ((jid, j_mappings(8, 0, 16)), (tid, t_mappings(8, 0,
                                                                    16))):
        centers, marks = mod.labels_to_marks(labels)
        out.append(mod.ImageWMaps(
            image=img.copy(), name="scene", shape=(h, w),
            detection_map=det.copy(), param_dist_maps=[d.copy()
                                                       for d in dists],
            mappings=maps, labels=labels, gt_centers=centers,
            gt_marks=marks))
    return out


@pytest.mark.parametrize("h,w,patch,overlap", [
    (150, 170, 64, 16), (128, 112, 96, 32), (64, 64, 64, 32),
    (50, 40, 64, 32)])
def test_tiling_matches_jax(h, w, patch, overlap):
    """Padding, tiles (anchors, names, crops, labels) and the merge of the
    tiles' detections equal the JAX package's, exactly."""
    jd, td = _image(h, w, seed=h + w)
    jd = jsc.pad_image_w_maps(jd, patch)
    td = tsc.pad_image_w_maps(td, patch)
    assert tuple(td.shape) == tuple(jd.shape)
    np.testing.assert_array_equal(td.image, jd.image)
    jp = jid.split_image(jd, patch, overlap)
    tp = tid.split_image(td, patch, overlap)
    assert [p.name for p in tp] == [p.name for p in jp]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.crop_data["tl_anchor"],
                                      b.crop_data["tl_anchor"])
        np.testing.assert_array_equal(a.detection_map, b.detection_map)
        for x, y in zip(a.param_dist_maps, b.param_dist_maps):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.gt_centers, b.gt_centers)
        np.testing.assert_array_equal(a.gt_marks, b.gt_marks)
    # per-tile detections with duplicates across the overlaps
    rng = np.random.default_rng(1)
    dets = []
    for p in jp:
        c = rng.uniform(0, patch, (5, 2)).astype(np.float32)
        c[1] = c[0] + 1.0  # within the 3 px dedup of its neighbour
        dets.append((c, rng.uniform(1, 9, (5, 3)).astype(np.float32),
                     rng.uniform(0, 5, 5).astype(np.float32)))
    want = jid.merge_patch_results(jp, *zip(*dets), distance=3.0)
    got = tid.merge_patch_results(tp, *zip(*dets), distance=3.0)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert len(got[0]) < 5 * len(jp)


@pytest.mark.parametrize("name", TILED_CONFIGS)
def test_reference_configs_run_tiled(name):
    """Every tiled reference config is accepted, with its tile size, its
    sampler and its sequential mixture (split/merge in
    ``mpp_verify_r2``); a tile mesh raises with ROADMAP.md item 15."""
    cfg = tmm.load_mpp_config(name)
    tmm.check_inference_config(cfg)
    opts = tmm.tiled_options(cfg)
    assert cfg["inference"].get("scene_mode", "tiled") == "tiled"
    assert opts["patch_size"] == 256 and opts["sampler"] == "sequential"
    assert opts["use_split_merge"] == (name == "mpp_verify_r2")
    assert "stopping" not in opts
    cfg["inference"]["tile_mesh"] = True
    with pytest.raises(NotImplementedError, match="item 15"):
        tmm.check_inference_config(cfg)


def test_tiled_cli_runs(workspaces, monkeypatch):
    """``-p infereval -m mpp`` on a depth-cut copy of ``mpp_hrcM`` (the
    legacy manual mode, tiled): every scene in 4 tiles run as one
    program, samples collected, result pickles, DOTA files and finite
    APs, and the tiled checkpoint ``NNNN_tiles.ck.npz`` removed."""
    ws_t = workspaces[1]
    cfg = _config("mpp_hrcM", "mpp_tiled_cli")
    path = ws_t / "mpp_tiled_cli.json"
    path.write_text(json.dumps(cfg))
    checkpoints = []
    run = tmm.run_tiled_scene

    def spy(*a, **k):
        checkpoints.append(k["checkpoint_path"])
        return run(*a, **k)

    monkeypatch.setattr(tmm, "run_tiled_scene", spy)
    with tw.inside(ws_t):
        model = t_main(["-p", "infereval", "-m", "mpp", "-c", str(path)],
                       device="cpu")
    rd = _results_dir(ws_t, "mpp_tiled_cli")
    assert [os.path.basename(p) for p in checkpoints] == [
        f"{i:04}_tiles.ck.npz" for i in range(N_IMAGES)]
    assert not any(os.path.exists(p) for p in checkpoints)
    assert sorted(model.results) == list(range(N_IMAGES))
    for r in model.results.values():
        assert r.n_tiles == N_TILES and r.supersteps == TOTAL
        assert r.samples == 2  # moves 64 and 80
        assert len(r.centers) > 0 and np.isfinite(r.scores).all()
    for i in range(N_IMAGES):
        assert (rd / f"{i:04}_results.pkl").exists()
    for postfix in ("", "-SV"):
        for iou in (0.05, 0.5):
            m = json.loads((rd / ("dota" + postfix)
                            / f"metrics{iou:.2f}.json").read_text())
            assert np.isfinite(m["vehicle"]["ap"])


def _shifted_j(st, maps):
    """The one chain function of both packages: every point moved by
    ``SHIFT``, clipped to the maps (JAX)."""
    h, w = maps.position.shape
    return st.replace(xy=jnp.clip(st.xy + jnp.asarray(SHIFT), 0.0,
                                  jnp.asarray([h - 1.0, w - 1.0])))


def _shifted_t(st, maps):
    """``_shifted_j`` on the port's laned state."""
    h, w = maps.position.shape[-2:]
    hi = torch.tensor([h - 1.0, w - 1.0])
    return st.replace(xy=torch.minimum(torch.clamp(
        st.xy + torch.tensor(SHIFT), min=0.0), hi))


def _fake_chain_j(key, st, maps, spec, comb, kd, n_steps, t0=1.0,
                  alpha_t=0.999, t_target=0.0, n_samples=0,
                  samples_interval=1, burn_in=0, step_offset=0):
    final = _shifted_j(st, maps)
    stats = jrj.ChainStats(
        accepted=jnp.zeros(8), proposed=jnp.zeros(8),
        final_energy=jnp.float32(0.0), final_n_points=final.n_points,
        final_temperature=jnp.float32(t0))
    samples = jax.tree_util.tree_map(lambda x: jnp.stack([x] * n_samples),
                                     final)
    return final, stats, samples, jnp.asarray(1, jnp.int32)


def _fake_chain_t(gen, st, maps, spec, comb, kd, n_steps, t0=1.0,
                  alpha_t=0.999, t_target=0.0, n_samples=0,
                  samples_interval=1, burn_in=0, step_offset=0):
    final = _shifted_t(st, maps)
    stats = trj.ChainStats(
        accepted=torch.zeros(1, 8), proposed=torch.zeros(1, 8),
        final_energy=torch.zeros(st.xy.shape[0]),
        final_n_points=final.n_points, final_temperature=t0)
    samples = PointsState(**{
        f: getattr(final, f)[:, None].expand(
            (-1, n_samples) + getattr(final, f).shape[1:]).clone()
        for f in ("xy", "marks", "alive")})
    return final, stats, samples, 1


def _det_rows(text):
    """The DOTA detection lines of ``text`` by image: {image: (n, 9)
    float array of score and polygon}."""
    rows = {}
    for ln in text.splitlines():
        f = ln.split()
        rows.setdefault(f[0], []).append([float(v) for v in f[1:]])
    return {k: np.array(v) for k, v in rows.items()}


def _matched(a, b):
    """``b``'s rows in the order of ``a``'s: nearest polygon centers
    (one-to-one)."""
    from scipy.optimize import linear_sum_assignment

    ca = a[:, 1:].reshape(-1, 4, 2).mean(1)
    cb = b[:, 1:].reshape(-1, 4, 2).mean(1)
    cost = ((ca[:, None] - cb[None]) ** 2).sum(-1)
    ia, ib = linear_sum_assignment(cost)
    return b[ib[np.argsort(ia)]]


def _nudged_polish(polish, seed):
    """``polish`` of its input moved by 1 ulp (up or down at random) in
    every live coordinate and mark."""
    def nudged(state, *a, **k):
        rng = np.random.default_rng(seed)
        alive = np.asarray(state.alive)[:, None]

        def nudge(x):
            x = np.asarray(x)
            to = np.where(rng.uniform(size=x.shape) < 0.5, -np.inf, np.inf)
            return jnp.asarray(np.where(alive, np.nextafter(
                x, to.astype(x.dtype)), x))

        return polish(state.replace(xy=nudge(state.xy),
                                    marks=nudge(state.marks)), *a, **k)

    return nudged


def test_one_chain_gives_the_same_dota_files(workspaces, monkeypatch):
    """A depth-cut ``mpp_r4p`` (tiled, its 60 polish steps, refine, score
    blend, backfill) through both packages' ``MPPModel.infer`` with one
    chain function: the same calibration and naive init, the same tiles'
    last samples and merge (the polish inputs to ``DET_ATOL``), and the
    same DOTA ground truth and image sets byte for byte. The polish and
    what follows it (the detection lines, the polished energy) are held
    to the JAX package's own spread under 1-ulp nudges of the polish
    input, which is asserted to exceed ``DET_ATOL``."""
    from mpp_cnn_rs_object_detection_tpu.mpp import polish as jpol

    ws_j, ws_t = workspaces
    cfg = _config("mpp_r4p", "mpp_one_chain")
    assert cfg["inference"]["polish_steps"] == 60
    monkeypatch.setattr(jsc, "run_chain", _fake_chain_j)
    monkeypatch.setattr(tsc, "run_chain", _fake_chain_t)
    calls = {"jax": [], "port": []}

    def spy(polish, into):
        def run(state, *a, **k):
            out = polish(state, *a, **k)
            into.append((state, a, k, out[1][1]))
            return out
        return run

    def infer_jax(polish, into):
        with monkeypatch.context() as m:
            m.setattr(jpol, "polish_state", spy(polish, into))
            with tw.inside(ws_j):
                jmm.MPPModel(json.loads(json.dumps(cfg)),
                             load=True).infer("val")
        return dota_snapshot(str(_results_dir(ws_j, "mpp_one_chain")))

    snaps = [infer_jax(jpol.polish_state, calls["jax"])]
    for k in range(NUDGES):
        snaps.append(infer_jax(_nudged_polish(jpol.polish_state, k), []))
    snap_j = snaps[0]
    monkeypatch.setattr(tsc, "polish_state",
                        spy(tsc.polish_state, calls["port"]))
    with tw.inside(ws_t):
        port = tmm.MPPModel(json.loads(json.dumps(cfg)), load=True,
                            device="cpu")
        port.infer("val")
    snap_t = dota_snapshot(str(_results_dir(ws_t, "mpp_one_chain")))
    assert (json.loads((ws_t / "models" / "mpp" / "mpp_one_chain"
                        / "calibration.json").read_text())
            == json.loads((ws_j / "models" / "mpp" / "mpp_one_chain"
                           / "calibration.json").read_text()))
    for r in port.results.values():
        assert r.n_tiles == N_TILES and r.samples == 3  # one per segment
        assert r.polish_energies[1] <= r.polish_energies[0]
    # the polish inputs: the merged scene, equal as sets of points
    assert len(calls["port"]) == len(calls["jax"]) == N_IMAGES
    for (sj, *_), (st, *_) in zip(calls["jax"], calls["port"]):
        def points(xy, marks, alive):
            p = np.concatenate([np.asarray(xy), np.asarray(marks)],
                               1)[np.asarray(alive)]
            return p[np.lexsort(p.T[::-1])]

        pj, pt = points(sj.xy, sj.marks, sj.alive), points(st.xy, st.marks,
                                                          st.alive)
        assert pj.shape == pt.shape
        np.testing.assert_allclose(pt, pj, atol=DET_ATOL)
    assert snap_t.keys() == snap_j.keys()
    spread = 0.0
    for key in snap_j:
        if not key.endswith(os.path.join("det", "vehicle.txt")):
            assert snap_t[key] == snap_j[key], key
            continue
        rows_j, rows_t = _det_rows(snap_j[key]), _det_rows(snap_t[key])
        assert rows_t.keys() == rows_j.keys() and rows_j
        # the JAX package's own spread under nudges, then the port in it
        for image, a in rows_j.items():
            for snap in snaps[1:]:
                b = _det_rows(snap[key])[image]
                assert b.shape == a.shape
                spread = max(spread, np.abs(_matched(a, b) - a).max())
        for image, a in rows_j.items():
            assert rows_t[image].shape == a.shape
            np.testing.assert_allclose(
                _matched(a, rows_t[image]), a,
                atol=SPREAD_FACTOR * spread + DET_ATOL, rtol=0, err_msg=key)
    assert spread > DET_ATOL  # the witness: the polish parts float noise
    # the polished energy, against the JAX package's spread over the same
    # nudges of the same input
    for (sj, args, kw, uj), (*_, ut) in zip(calls["jax"], calls["port"]):
        width = max(abs(float(_nudged_polish(jpol.polish_state, k)(
            sj, *args, **kw)[1][1]) - float(uj)) for k in range(NUDGES))
        assert width > 0
        assert abs(float(ut) - float(uj)) <= SPREAD_FACTOR * width + 1e-5


def _scene_inputs(ws, pkg):
    """Scene 0 of the workspace with a fixed energy model, in ``pkg``."""
    id_mod, es_mod, comb_mod, rj_mod = pkg
    with tw.inside(ws):
        data = id_mod.load_image_w_maps(0, DATASET, "val", [tw.POS],
                                        tw.SHAPE)
    setup = es_mod.NoCalibrationEnergySetup()
    setup.calibration = {"min_area": 4.0, "max_area": 200.0,
                         "detection_threshold": 0.0}
    comb = comb_mod.manual_hierarchical(
        setup.spec.names, {n: 1.0 for n in setup.spec.names})
    params = rj_mod.RJMCMCParams(n_steps=BURN_IN, samples_interval=INTERVAL,
                                 alpha_t=0.95)
    return data, setup, comb, params


def test_resume_replays_and_ignores_the_jax_checkpoint(workspaces,
                                                       monkeypatch,
                                                       tmp_path):
    """A scene killed after its first segment (``max_segments``) resumes
    from its checkpoint to the uninterrupted run's detections, exactly,
    and the checkpoint is gone; the JAX package's tiled checkpoint at the
    same path is not resumed (the run restarts and gives the same
    detections)."""
    ws_j, ws_t = workspaces
    t_pkg = (tid, tes, tcomb, trj)
    kw = dict(seed=0, patch_size=PATCH, capacity=32, segment_size=SEGMENT,
              device="cpu")

    def run(**extra):
        return tsc.run_tiled_scene(*_scene_inputs(ws_t, t_pkg), **kw,
                                   **extra)

    whole = run()
    ck = str(tmp_path / "0000_tiles.ck.npz")
    assert run(checkpoint_path=ck, max_segments=1) is None
    assert os.path.exists(ck)
    resumed = run(checkpoint_path=ck)
    assert not os.path.exists(ck)
    assert resumed.supersteps == whole.supersteps == TOTAL
    for f in ("centers", "marks", "scores"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(whole, f), err_msg=f)
    d_t = tmm.export_detections(resumed, 4.0)
    d_w = tmm.export_detections(whole, 4.0)
    for f in ("polygons", "scores01"):
        np.testing.assert_array_equal(d_t[f], d_w[f])
    # the JAX package's own tiled checkpoint, left by a killed JAX run
    ck_j = str(tmp_path / "0000_chains.ck.npz")
    monkeypatch.setattr(jsc, "run_chain", _fake_chain_j)
    assert jsc.run_mpp_on_scene(
        *_scene_inputs(ws_j, (jid, jes, jcomb, jrj)), seed=0,
        patch_size=PATCH, capacity=32, segment_size=SEGMENT,
        checkpoint_path=ck_j, max_segments=1) is None
    assert os.path.exists(ck_j)
    other = run(checkpoint_path=ck_j)
    assert other.supersteps == TOTAL and not os.path.exists(ck_j)
    for f in ("centers", "marks", "scores"):
        np.testing.assert_array_equal(getattr(other, f), getattr(whole, f),
                                      err_msg=f)


def test_parallel_sampler_schedule_and_resume(workspaces, monkeypatch,
                                              tmp_path):
    """``sampler="parallel"``: with one stand-in for the cell-parallel
    chain in both packages (JAX's ``run_parallel_chain``, the port's
    ``run_exact_scene_chain``), the budget in supersteps, the segments,
    the threaded temperature, the per-superstep cooling and the move flags
    each segment is given equal the JAX package's, and so do the
    detections (no samples: each tile keeps its final state). With the
    port's own chain, a scene killed after its first segment resumes to
    the uninterrupted run's detections, exactly."""
    from mpp_cnn_rs_object_detection_tpu.mpp import parallel_sampler as jps

    ws_j, ws_t = workspaces
    moves = dict(data_moves=False, move_switch=True, split_merge=False)
    calls = {"jax": [], "port": []}

    def fake_j(key, st, maps, spec, comb, kd, n_supersteps, t0=1.0,
               alpha_t=0.999, t_target=0.0, **flags):
        calls["jax"].append((n_supersteps, t0, alpha_t, t_target, flags))
        final = _shifted_j(st, maps)
        return final, jrj.ChainStats(
            accepted=jnp.zeros(8), proposed=jnp.zeros(8),
            final_energy=jnp.float32(0.0), final_n_points=final.n_points,
            final_temperature=jnp.float32(t0))

    def fake_t(gens, st, maps, spec, comb, kd, n_supersteps, t0=1.0,
               alpha_t=0.999, t_target=0.0, **flags):
        assert len(gens) == N_TILES
        calls["port"].append((n_supersteps, t0, alpha_t, t_target, flags))
        return _shifted_t(st, maps), None, None

    monkeypatch.setattr(jps, "run_parallel_chain", fake_j)
    monkeypatch.setattr(tsc, "run_exact_scene_chain", fake_t)
    kw = dict(seed=0, patch_size=PATCH, capacity=32, segment_size=SEGMENT,
              sampler="parallel", **moves)
    want = jsc.run_mpp_on_scene(*_scene_inputs(
        ws_j, (jid, jes, jcomb, jrj)), **kw)
    got = tsc.run_tiled_scene(*_scene_inputs(ws_t, (tid, tes, tcomb, trj)),
                              device="cpu", **kw)
    # 96 px tiles: (96 // 64 + 1) ** 2 // 2 = 2 moves per superstep
    assert [c[0] for c in calls["port"]] == [20, 20, 8]
    assert len(calls["port"]) == len(calls["jax"])
    for p, j in zip(calls["port"], calls["jax"]):
        assert p[0] == j[0] and p[4] == j[4]
        np.testing.assert_allclose(p[1:4], j[1:4], rtol=1e-12)
    assert got.samples == 0 and got.planned_supersteps == 48

    def rows(r):  # in coordinate order: tied scores merge in either order
        x = np.concatenate([r.centers, r.marks, r.scores[:, None]], 1)
        return x[np.lexsort(np.round(x[:, :2], 3).T[::-1])]

    assert len(got.centers) == len(want.centers) > 0
    np.testing.assert_allclose(rows(got), rows(want), atol=DET_ATOL,
                               rtol=DET_ATOL)
    monkeypatch.undo()
    kw = dict(kw, device="cpu", segment_size=2 * 4)

    def run(**extra):
        return tsc.run_tiled_scene(*_scene_inputs(ws_t, (tid, tes, tcomb,
                                                        trj)), **kw, **extra)

    whole = run()
    ck = str(tmp_path / "0000_tiles.ck.npz")
    assert run(checkpoint_path=ck, max_segments=1) is None
    assert os.path.exists(ck)
    resumed = run(checkpoint_path=ck)
    assert not os.path.exists(ck) and resumed.supersteps == 48
    assert len(whole.centers) > 0
    for f in ("centers", "marks", "scores"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(whole, f), err_msg=f)
