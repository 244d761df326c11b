"""The PyTorch port's normal entry point against the JAX package, in two
workspaces (each with its own ``paths_config.json``) over copies of the
same synthetic dataset (3 images of 128 x 128, from a seed).

CNN stage: tiny PosNets and a ShapeNet (hidden_dims [8, 16], weights drawn
by flax and stored as flax checkpoints) run ``infer`` over the dataset in
both packages; maps and DOTA lines must agree to float tolerance.

MPP stage: on oracle maps written from the GT into both workspaces (Gaussian
blobs at the GT centers, one-hot mark distributions at the nearest GT mark;
the mappings pickled by the JAX package), both packages run the flagship's
combiner and calibration in exact scene mode with ``batch_scenes`` and a
``max_iter`` stopping block, the port through its CLI; AP must agree within
the stated tolerance. The chains differ (threefry against Philox)."""

import contextlib
import dataclasses
import json
import os
import pickle
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.mpp import scene as tscene
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    load_image_w_maps as t_load_image_w_maps,
)
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    PosNetModel as TPosNetModel,
)
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel as TShapeNetModel,
)
from mpp_cnn_rs_object_detection_torch.utils.files import load_results
from mpp_cnn_rs_object_detection_tpu.models import unet as junet
from mpp_cnn_rs_object_detection_tpu.models.posnet_model import (
    PosNetModel as JPosNetModel,
)
from mpp_cnn_rs_object_detection_tpu.models.shapenet_model import (
    ShapeNetModel as JShapeNetModel,
)
from mpp_cnn_rs_object_detection_tpu.mpp import mpp_model as jmm
from mpp_cnn_rs_object_detection_tpu.mpp import scene as jscene
from mpp_cnn_rs_object_detection_tpu.mpp.image_data import (
    labels_to_marks,
    load_image_w_maps as j_load_image_w_maps,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import default_mappings
from tests._dota_util import dota_snapshot
from tests._torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "models_storage", "mpp",
                        "mpp_log_r12ttapar")
DATASET = "synth_p"
N_IMAGES, SHAPE, N_RECT, SEED = 3, (128, 128), 56, 7
NARROW, N_CLS = [8, 16], 8
# CNN maps: fp32 U-Nets summed in another order (test_torch_models.py)
MAP_ATOL = 1e-4
# AP on oracle maps: over three seed sets of this run (chain seeds = image
# ids + 0, 100, 200), the JAX package's AP spans at most 0.091 (max - min,
# at IoU 0.05; 0.052 to 0.091 across the thresholds) and the port's 0.098;
# their means differ by at most 0.04. The tolerance is the JAX spread
# rounded up to 0.1.
AP_TOL = 0.1
# the anneal: 1800 moves at 0.99 per move -> 150 supersteps in 3 segments
# of 50; the stopping block ends it after 2 segments (100 supersteps of 4
# moves: the 128 px bucket has 3 x 3 cells)
BURN_IN, SEGMENT, ALPHA, MAX_ITER = 1800, 600, 0.99, 400

POS_CFG = {
    "data_loader": {"dataset": DATASET, "dataset_update_interval": 8},
    "trainer": {"n_epochs": 2, "batch_size": 4},
    "div_clf_model": True,
    "model": {"hidden_dims": NARROW, "dtype": "float32"},
    "loss": {"learning_rate": 2e-3, "target_mode": "uvec", "max_distance": 8,
             "learn_mask": True},
}
SHAPE_CFG = {
    "model_name": "shape_t",
    "data_loader": {"dataset": DATASET, "dataset_update_interval": 8},
    "trainer": {"n_epochs": 2, "n_classes": N_CLS, "batch_size": 4},
    "model": {"hidden_dims": NARROW, "dtype": "float32"},
    "loss": {"learning_rate": 2e-3, "mask_mode": "shapes"},
    "mappings": {"size_mapping_min": 0, "size_mapping_max": 16},
    "inference": {"pos_model": "pos_one_t", "tta": True},
}


@contextlib.contextmanager
def inside(ws):
    old = os.getcwd()
    os.chdir(ws)
    try:
        yield
    finally:
        os.chdir(old)


def _checkpoint(params, stats):
    return flax.serialization.to_bytes(
        {"params": params, "batch_stats": stats, "epoch": 2})


def _store_models(ws):
    """The tiny CNNs: flax-initialised weights in flax checkpoints."""
    models = []
    # div-classifier heads (w, b): the map is sigmoid(w * div * mask + b);
    # random narrow U-Nets give divergences of ~3e-3, so the steeper head
    # puts the ShapeNet's centers (map > 0.5) at the strongest sinks
    for name, tta, seed, w, b in (("pos_tta_t", True, 0, -40.0, -2.0),
                                  ("pos_one_t", False, 1, -1000.0, -5.0)):
        net = junet.PosNet(hidden_dims=NARROW, out_channels=3,
                           dtype=jnp.float32)
        var = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                       train=False)
        div = {"Conv_0": {"kernel": jnp.full((1, 1, 1, 1), w),
                          "bias": jnp.full((1,), b)}}
        cfg = dict(POS_CFG, model_name=name, inference={"tta": tta})
        models.append(("posnet", cfg, _checkpoint(
            {"net": var["params"], "div": div}, var["batch_stats"])))
    net = junet.ShapeNet(hidden_dims=NARROW, n_classes=N_CLS,
                         dtype=jnp.float32)
    var = net.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)),
                   train=False)
    models.append(("shapenet", SHAPE_CFG,
                   _checkpoint(var["params"], var["batch_stats"])))
    for kind, cfg, blob in models:
        d = ws / "models" / kind / cfg["model_name"]
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(cfg))
        (d / "model.msgpack").write_bytes(blob)


def _oracle_pickles(ws, name_pos, name_shape):
    """Result pickles of oracle CNNs, from the GT of every val image."""
    mappings = default_mappings(n_classes=32, size_min=0.0, size_max=32.0)
    base = ws / "data" / DATASET / "val"
    for kind, name in (("pos", name_pos), ("shape", name_shape)):
        (ws / "data" / "inference" / DATASET / "val" / name).mkdir(
            parents=True)
    for i in range(N_IMAGES):
        with open(base / "annotations" / f"{i:04}.pkl", "rb") as f:
            centers, marks = labels_to_marks(pickle.load(f))
        gy, gx = np.mgrid[:SHAPE[0], :SHAPE[1]]
        d2 = ((gy[..., None] - centers[:, 0]) ** 2
              + (gx[..., None] - centers[:, 1]) ** 2)
        det = np.exp(-d2.min(-1) / (2 * 1.5 ** 2)).astype(np.float32)
        nearest = d2.argmin(-1)
        output = []
        for k, m in enumerate(mappings):
            cls = m.value_to_class(marks[nearest, k])
            output.append(np.moveaxis(np.eye(32, dtype=np.float32)[cls], -1,
                                      0)[None])
        inf = ws / "data" / "inference" / DATASET / "val"
        with open(inf / name_pos / f"{i:04}_results.pkl", "wb") as f:
            pickle.dump({"detection_map": det}, f)
        with open(inf / name_shape / f"{i:04}_results.pkl", "wb") as f:
            pickle.dump({"output": output, "mappings": mappings}, f)


def _mpp_config(name, position_model, shape_model):
    with open(os.path.join(ROOT, "model_configs", "mpp",
                           "mpp_log_r12ttapar.json")) as f:
        cfg = json.load(f)
    cfg["model_name"] = name
    cfg["dataset"].update(dataset=DATASET, position_model=position_model,
                          shape_model=shape_model)
    cfg["inference"]["segment_size"] = SEGMENT
    cfg["inference"]["rjmcmc_params"].update(
        burn_in=BURN_IN, alpha_t=ALPHA,
        stopping={"kind": "max_iter", "max_iter": MAX_ITER})
    return cfg


def _mpp_store(ws, cfg):
    d = ws / "models" / "mpp" / cfg["model_name"]
    d.mkdir(parents=True)
    for f in ("calibration.json", "energy_combination_model.json"):
        shutil.copy(os.path.join(FLAGSHIP, f), d / f)
    path = ws / f"{cfg['model_name']}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _results_dir(ws, model):
    return str(ws / "data" / "inference" / DATASET / "val" / model)


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_pipeline")
    spaces = []
    for name in ("jax", "torch"):
        ws = base / name
        (ws / "data").mkdir(parents=True)
        (ws / "models").mkdir()
        (ws / "paths_config.json").write_text(json.dumps(
            {"dataset_path": [str(ws / "data")],
             "model_path": [str(ws / "models")]}))
        spaces.append(ws)
    ws_j, ws_t = spaces
    # the port's writer (the JAX package's writes the same images and GT,
    # test_torch_io.py, but takes minutes at this size)
    make_synth_dataset(name=DATASET, n_items=N_IMAGES, shape=SHAPE,
                       n_rect=N_RECT, seed=SEED, base_dir=str(ws_j / "data"))
    shutil.copytree(ws_j / "data" / DATASET, ws_t / "data" / DATASET)
    for ws in spaces:
        _store_models(ws)
        _oracle_pickles(ws, "pos_oracle", "shape_oracle")
    return ws_j, ws_t


@pytest.fixture(scope="module")
def cnn_stage(workspaces):
    ws_j, ws_t = workspaces
    with inside(ws_j):
        for cls, cfg in ((JPosNetModel, dict(POS_CFG, model_name="pos_tta_t",
                                              inference={"tta": True})),
                         (JShapeNetModel, SHAPE_CFG)):
            cls(cfg, load=True, train=False).infer("val")
    with inside(ws_t):
        for cls, cfg in ((TPosNetModel, dict(POS_CFG, model_name="pos_tta_t",
                                              inference={"tta": True})),
                         (TShapeNetModel, SHAPE_CFG)):
            cls(cfg, "cpu", load=True).infer("val")
    return ws_j, ws_t


@pytest.fixture(scope="module")
def mpp_stage(workspaces):
    """Both packages' MPPModel.infer + eval on the oracle maps; records the
    checkpoint files each wrote (``np.savez``)."""
    ws_j, ws_t = workspaces
    cfg = _mpp_config("mpp_oracle", ["pos_oracle"], "shape_oracle")
    saved = {"jax": [], "torch": []}
    savez = np.savez
    with pytest.MonkeyPatch.context() as mp:
        with inside(ws_j):
            mp.setattr(np, "savez", lambda p, **kw: (
                saved["jax"].append(str(p)), savez(p, **kw)))
            _mpp_store(ws_j, cfg)
            jm = jmm.MPPModel(cfg, load=True)
            jm.infer(subset="val")
            jm.eval()
        with inside(ws_t):
            mp.setattr(np, "savez", lambda p, **kw: (
                saved["torch"].append(str(p)), savez(p, **kw)))
            path = _mpp_store(ws_t, cfg)
            tm = t_main(["-p", "infereval", "-m", "mpp", "-c", path],
                        device="cpu")
    return dict(ws_j=ws_j, ws_t=ws_t, saved=saved, port=tm, cfg=cfg)


def _lines(path):
    with open(path) as f:
        return [ln.split(" ") for ln in f.read().splitlines()]


def _assert_det_lines_close(path_j, path_t, atol=MAP_ATOL):
    lj, lt = _lines(path_j), _lines(path_t)
    assert len(lj) == len(lt) > 0, (len(lj), len(lt))
    for a, b in zip(lj, lt):
        assert a[0] == b[0]
        np.testing.assert_allclose(np.array(b[1:], float),
                                   np.array(a[1:], float), atol=atol)


def test_cnn_detection_maps_agree(cnn_stage):
    ws_j, ws_t = cnn_stage
    for i in range(N_IMAGES):
        pj = load_results(os.path.join(_results_dir(ws_j, "pos_tta_t"),
                                       f"{i:04}_results.pkl"))
        pt = load_results(os.path.join(_results_dir(ws_t, "pos_tta_t"),
                                       f"{i:04}_results.pkl"))
        assert pt["detection_map"].shape == SHAPE
        np.testing.assert_allclose(pt["detection_map"], pj["detection_map"],
                                   atol=MAP_ATOL)
        np.testing.assert_array_equal(pt["detection"], pj["detection"])


def test_cnn_dist_maps_agree(cnn_stage):
    """The ShapeNet pickles: (1, C, H, W) maps, decoded marks, and the
    mappings (the JAX package's read through the remapping unpickler)."""
    ws_j, ws_t = cnn_stage
    for i in range(N_IMAGES):
        sj = load_results(os.path.join(_results_dir(ws_j, "shape_t"),
                                       f"{i:04}_results.pkl"))
        st = load_results(os.path.join(_results_dir(ws_t, "shape_t"),
                                       f"{i:04}_results.pkl"))
        for a, b in zip(sj["output"], st["output"]):
            assert b.shape == (1, N_CLS) + SHAPE
            np.testing.assert_allclose(b, a, atol=MAP_ATOL)
        for mj, mt in zip(sj["mappings"], st["mappings"]):
            # the JAX package's mapping, read as the port's class
            assert type(mj) is type(mt)
            assert (mj.n_classes, mj.v_min, mj.v_max, mj.is_cyclic) == (
                mt.n_classes, mt.v_min, mt.v_max, mt.is_cyclic)
            np.testing.assert_array_equal(mj.feature_mapping,
                                          mt.feature_mapping)
        np.testing.assert_allclose(st["detection_params"],
                                   sj["detection_params"], atol=MAP_ATOL)


def test_cnn_dota_files_agree(cnn_stage):
    ws_j, ws_t = cnn_stage
    for model in ("pos_tta_t", "shape_t"):
        rj, rt = _results_dir(ws_j, model), _results_dir(ws_t, model)
        _assert_det_lines_close(os.path.join(rj, "dota", "det", "vehicle.txt"),
                                os.path.join(rt, "dota", "det", "vehicle.txt"))
        for f in ["imageSet.txt"] + [f"gt/{i:04}.txt"
                                     for i in range(N_IMAGES)]:
            with open(os.path.join(rj, "dota", f)) as a, \
                    open(os.path.join(rt, "dota", f)) as b:
                assert a.read() == b.read(), (model, f)


def test_load_image_w_maps_agrees(mpp_stage):
    ws_j, ws_t = mpp_stage["ws_j"], mpp_stage["ws_t"]
    for i in range(N_IMAGES):
        with inside(ws_j):
            dj = j_load_image_w_maps(i, DATASET, "val", ["pos_oracle"],
                                     "shape_oracle")
        with inside(ws_t):
            dt = t_load_image_w_maps(i, DATASET, "val", ["pos_oracle"],
                                     "shape_oracle")
        np.testing.assert_array_equal(dt.image, dj.image)
        np.testing.assert_array_equal(dt.detection_map, dj.detection_map)
        for a, b in zip(dj.param_dist_maps, dt.param_dist_maps):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(dt.gt_centers, dj.gt_centers)
        np.testing.assert_array_equal(dt.gt_marks, dj.gt_marks)
        assert dt.name == dj.name and dt.shape == dj.shape


def test_batched_checkpoint_written_and_removed(mpp_stage):
    for pkg, ws in (("jax", mpp_stage["ws_j"]), ("torch", mpp_stage["ws_t"])):
        ck = os.path.join(_results_dir(ws, "mpp_oracle"),
                          "batched_chains.ck.npz")
        assert ck in mpp_stage["saved"][pkg], (pkg, mpp_stage["saved"][pkg])
        assert not os.path.exists(ck), pkg


def test_stopping_block_ends_the_port_chain(mpp_stage):
    """The CLI ran MPPModel.infer + eval; max_iter stopped every scene
    after 2 of its 3 segments."""
    port = mpp_stage["port"]
    assert isinstance(port, tmm.MPPModel)
    assert set(port.seconds) >= {"cnn", "host", "load", "chain", "export",
                                 "eval"}
    assert sorted(port.results) == list(range(N_IMAGES))
    for r in port.results.values():
        assert r.stopped and r.supersteps == 100 < r.planned_supersteps


def test_ap_agrees_on_oracle_maps(mpp_stage):
    for postfix in ("", "-SV"):
        for iou in (0.05, 0.1, 0.25, 0.5, 0.75):
            aps = []
            for ws in (mpp_stage["ws_j"], mpp_stage["ws_t"]):
                with open(os.path.join(_results_dir(ws, "mpp_oracle"),
                                       "dota" + postfix,
                                       f"metrics{iou:.2f}.json")) as f:
                    aps.append(json.load(f)["vehicle"]["ap"])
            assert np.isfinite(aps).all()
            assert abs(aps[0] - aps[1]) <= AP_TOL, (postfix, iou, aps)
            if iou == 0.05:  # both chains find most oracle objects
                assert min(aps) > 0.3, aps


def test_resume_replays_identical_dota_files(mpp_stage):
    ws_t = mpp_stage["ws_t"]
    results_dir = _results_dir(ws_t, "mpp_oracle")
    first = dota_snapshot(results_dir)
    assert any(v.strip() for v in first.values())
    with inside(ws_t):
        tmm.MPPModel(mpp_stage["cfg"], load=True, device="cpu").infer(
            subset="val", overwrite=False)
    assert dota_snapshot(results_dir) == first


def test_export_applies_no_nms(workspaces, monkeypatch):
    """The same chain result -- two points 2 px apart per scene -- through
    both packages' MPPModel.infer export: the same detections in the
    result pickles and byte-identical DOTA files; both points stay."""
    ws_j, ws_t = workspaces
    cfg = _mpp_config("mpp_export", ["pos_oracle"], "shape_oracle")
    centers = np.array([[20.0, 20.0], [20.0, 22.0]], np.float32)
    marks = np.array([[8.0, 0.5, 0.3], [7.5, 0.45, 0.35]], np.float32)
    scores = np.array([2.5, 1.25], np.float32)

    def fake(cls):
        return lambda datas, *a, **k: [
            cls(centers=centers + i, marks=marks, scores=scores / (i + 1))
            for i in range(len(datas))]

    monkeypatch.setattr(jscene, "run_exact_scenes_batched",
                        fake(jscene.SceneResult))
    monkeypatch.setattr(tmm, "run_exact_scenes_batched",
                        fake(tscene.SceneResult))
    with inside(ws_j):
        _mpp_store(ws_j, cfg)
        jmm.MPPModel(cfg, load=True).infer(subset="val")
    with inside(ws_t):
        _mpp_store(ws_t, cfg)
        tmm.MPPModel(cfg, load=True, device="cpu").infer(subset="val")
    rj, rt = _results_dir(ws_j, "mpp_export"), _results_dir(ws_t, "mpp_export")
    assert dota_snapshot(rt) == dota_snapshot(rj)
    for i in range(N_IMAGES):
        pj = load_results(os.path.join(rj, f"{i:04}_results.pkl"))
        pt = load_results(os.path.join(rt, f"{i:04}_results.pkl"))
        assert len(pt["detection_center"]) == 2
        for key in ("detection", "detection_center", "detection_score",
                    "detection_params", "detection_marks"):
            np.testing.assert_array_equal(pt[key], pj[key], err_msg=key)


EXTENSIONS = {"refine_centers": True, "score_map_blend": 4.0,
              "backfill_threshold": 0.25}
# DOTA lines of the extensions: the same float32 and float64 host math in
# both packages
EXPORT_ATOL = 1e-5


def _fixed_detections(data, i):
    """A chain's output to export: the first GT objects 1.2 px off their
    centers (refine snaps them back), one point between objects, and the
    GT marks; the other objects are left to the backfill."""
    gt = np.asarray(data.gt_centers, np.float32)[:4]
    centers = np.concatenate([gt + np.float32(1.2), [[5.0, 120.0]]]
                             ).astype(np.float32)
    marks = np.concatenate([np.asarray(data.gt_marks, np.float32)[:4],
                            [[6.0, 0.5, 0.3]]]).astype(np.float32)
    scores = np.linspace(3.0, 0.5, len(centers)).astype(np.float32) / (i + 1)
    return centers, marks, scores


@pytest.mark.parametrize("path", ["batched", "per_image"])
def test_extensions_export_matches_jax(workspaces, monkeypatch, path):
    """Refine, score blend and backfill at export: both packages'
    MPPModel.infer, their chains replaced by the same fixed detections,
    write the same DOTA files (detection lines to 1e-5) on the batched
    path and on the per-image path (restarts: 2)."""
    ws_j, ws_t = workspaces
    name = f"mpp_ext_{path}"
    cfg = _mpp_config(name, ["pos_oracle"], "shape_oracle")
    cfg["inference"].update(EXTENSIONS)
    if path == "per_image":
        cfg["inference"]["restarts"] = 2

    def fake_batch(cls):
        def run(datas, *a, **k):
            return [cls(*_fixed_detections(d, i)) for i, d in
                    enumerate(datas)]
        return run

    def fake_one(cls):
        def run(data, *a, **k):
            return cls(*_fixed_detections(data, 0))
        return run

    monkeypatch.setattr(jscene, "run_exact_scenes_batched",
                        fake_batch(jscene.SceneResult))
    monkeypatch.setattr(jmm, "run_mpp_on_scene",
                        fake_one(jscene.SceneResult))
    monkeypatch.setattr(tmm, "run_exact_scenes_batched",
                        fake_batch(tscene.SceneResult))
    monkeypatch.setattr(tmm, "run_exact_scene", fake_one(tscene.SceneResult))
    with inside(ws_j):
        _mpp_store(ws_j, cfg)
        jmm.MPPModel(cfg, load=True).infer(subset="val")
    with inside(ws_t):
        _mpp_store(ws_t, cfg)
        port = tmm.MPPModel(cfg, load=True, device="cpu")
        port.infer(subset="val")
    rj, rt = _results_dir(ws_j, name), _results_dir(ws_t, name)
    snap_j, snap_t = dota_snapshot(rj), dota_snapshot(rt)
    assert snap_t.keys() == snap_j.keys()
    for key in snap_j:
        if key.endswith(os.path.join("det", "vehicle.txt")):
            _assert_det_lines_close(os.path.join(rj, key),
                                    os.path.join(rt, key), atol=EXPORT_ATOL)
        else:
            assert snap_t[key] == snap_j[key], key
    for i in range(N_IMAGES):
        pt = load_results(os.path.join(rt, f"{i:04}_results.pkl"))
        pj = load_results(os.path.join(rj, f"{i:04}_results.pkl"))
        for key in ("detection_center", "detection_score",
                    "detection_marks"):
            np.testing.assert_allclose(pt[key], pj[key], atol=EXPORT_ATOL,
                                       err_msg=key)
        # backfill appended map peaks; refine moved the chain's centers
        assert len(pt["detection_center"]) > 5
        assert np.abs(pt["detection_center"][:4]
                      - _fixed_detections_of(ws_t, i)[:4]).max() > 0.5
        np.testing.assert_array_equal(port.results[i].centers,
                                      pt["detection_center"])


def _fixed_detections_of(ws, i):
    with inside(ws):
        data = t_load_image_w_maps(i, DATASET, "val", ["pos_oracle"],
                                   "shape_oracle")
    return _fixed_detections(data, 0)[0]


def test_per_image_path_holds_one_scene(workspaces, monkeypatch):
    """Without ``batch_scenes`` each scene is loaded, run, exported and
    freed in its turn: when the next scene loads, the previous one's
    ImageWMaps and its maps on the device are gone (weak references), and
    ``MPPModel.results`` holds host arrays, no tensor."""
    import gc
    import weakref

    import torch

    ws_t = workspaces[1]
    cfg = _mpp_config("mpp_one_scene", ["pos_oracle"], "shape_oracle")
    cfg["inference"]["batch_scenes"] = False
    cfg["inference"]["rjmcmc_params"]["stopping"]["max_iter"] = 200
    alive_refs = []
    loads = []
    prepare = tscene._prepare

    def recording_prepare(data, *a, **k):
        out = prepare(data, *a, **k)
        alive_refs.extend(weakref.ref(t) for t in (
            out[0].detection_map, out[0].param_dist_maps))
        return out

    monkeypatch.setattr(tscene, "_prepare", recording_prepare)
    with inside(ws_t):
        _mpp_store(ws_t, cfg)
        model = tmm.MPPModel(cfg, load=True, device="cpu")
        load = model._load_image

        def recording_load(patch_id, subset):
            gc.collect()
            loads.append([r() is not None for r in alive_refs])
            data = load(patch_id, subset)
            alive_refs.append(weakref.ref(data))
            return data

        model._load_image = recording_load
        model.infer(subset="val")
    assert len(loads) == N_IMAGES and len(alive_refs) == 3 * N_IMAGES
    assert all(not any(flags) for flags in loads), loads
    gc.collect()
    assert not any(r() is not None for r in alive_refs)
    assert sorted(model.results) == list(range(N_IMAGES))
    for r in model.results.values():
        assert r.chain is None and r.supersteps == 50
        for f in dataclasses.fields(r):
            v = getattr(r, f.name)
            assert not isinstance(v, torch.Tensor), f.name
            if isinstance(v, np.ndarray):
                assert v.dtype != object


def test_entry_points_default_to_cuda(workspaces, monkeypatch):
    """Without a device argument every new entry point asks
    ``device.resolve_device`` for the CUDA device, which raises on a host
    without one instead of falling back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ws_t = workspaces[1]
    cfg = _mpp_config("mpp_cuda", ["pos_oracle"], "shape_oracle")
    with inside(ws_t):
        path = _mpp_store(ws_t, cfg)
        calls = [
            lambda: t_main(["-p", "infereval", "-m", "mpp", "-c", path]),
            lambda: t_main(["-p", "infer", "-m", "shapenet", "-c",
                            "shape_t"]),
            lambda: tmm.MPPModel(cfg, load=True),
            lambda: TPosNetModel(dict(POS_CFG, model_name="pos_tta_t"),
                                 load=True),
            lambda: tscene.run_exact_scenes_batched(
                [t_load_image_w_maps(0, DATASET, "val", ["pos_oracle"],
                                     "shape_oracle")], None, None, None,
                seeds=[0]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_stale_cnn_results_are_regenerated(cnn_stage):
    """A CNN result pickle older than its model's newest ``*.msgpack`` is
    deleted and inferred again; a fresh one is left alone (as
    ``tests/test_mpp_pipeline.py`` checks for the JAX package)."""
    import time

    ws_t = cnn_stage[1]
    pkl = os.path.join(_results_dir(ws_t, "pos_tta_t"), "0000_results.pkl")
    with inside(ws_t):
        seconds = tmm.ensure_cnn_inference(DATASET, "val", ["pos_tta_t"],
                                           "shape_t", device="cpu")
        assert seconds["cnn"] == 0.0
        mt0 = os.path.getmtime(pkl)
        past = time.time() - 3600
        os.utime(pkl, (past, past))
        seconds = tmm.ensure_cnn_inference(DATASET, "val", ["pos_tta_t"],
                                           "shape_t", device="cpu")
    assert seconds["cnn"] > 0.0
    assert os.path.getmtime(pkl) > past + 1
    assert os.path.getmtime(pkl) >= mt0
