"""The port's MPP calibration against the JAX package: crops, the pixelwise
PR sweep and detection threshold, the 1-D logistic fits, the mark-remap
calibration with its wrong-class draws, the area quantiles, both energy
setups' calibration and maps, and ``MPPModel``'s object-biased crops and
calibration on a synthetic workspace. The host parts are numpy in both
packages: fed the same numpy generator they give the same numbers."""

import json

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.metrics import detection as tdet
from mpp_cnn_rs_object_detection_torch.mpp import calibration as tcal
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import image_data as tid
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.metrics import detection as jdet
from mpp_cnn_rs_object_detection_tpu.mpp import calibration as jcal
from mpp_cnn_rs_object_detection_tpu.mpp import energy_setups as jes
from mpp_cnn_rs_object_detection_tpu.mpp import image_data as jid
from mpp_cnn_rs_object_detection_tpu.mpp import mpp_model as jmm
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests import _torch_workspace as tw
from tests._torch_util import one_torch_thread  # noqa: F401

H, W, C, N_OBJ = 60, 52, 8, 14
# float32 rectangle areas (jnp against numpy) and energy maps (the same
# sigmoid in another library)
AREA_RTOL, MAP_ATOL = 1e-6, 1e-6
DATASET = "synth_c"
N_IMAGES, SHAPE = 2, (96, 80)


def _image(pkg, seed=0):
    """One image's ImageWMaps, made from a seed, in package ``pkg``."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, [H, W], (N_OBJ, 2))
    params = np.stack([rng.uniform(3, 7, N_OBJ), rng.uniform(8, 14, N_OBJ),
                       rng.uniform(0, np.pi, N_OBJ)], -1)
    labels = {"centers": centers, "parameters": params,
              "categories": np.array(["vehicle", "large-vehicle"] * (
                  N_OBJ // 2)),
              "difficult": rng.uniform(size=N_OBJ) < 0.2}
    det = rng.uniform(size=(H, W)).astype(np.float32)
    det[centers[:, 0], centers[:, 1]] = 1.0
    dists = [rng.dirichlet(np.ones(C), size=(H, W)).astype(np.float32)
             for _ in range(3)]
    mod = tid if pkg == "torch" else jid
    mappings = (t_mappings if pkg == "torch" else j_mappings)(C, 0, 16)
    c, m = mod.labels_to_marks(labels)
    return mod.ImageWMaps(
        image=rng.uniform(size=(H, W, 3)).astype(np.float32), name="0007",
        shape=(H, W), detection_map=det, param_dist_maps=dists,
        mappings=mappings, labels=labels, gt_centers=c, gt_marks=m)


def _crops(pkg, anchors=((0, 0), (10, 7), (31, 29), (45, 40))):
    mod = tid if pkg == "torch" else jid
    data = _image(pkg)
    return [mod.crop_image_w_maps(data, np.array(a), 24) for a in anchors]


def _assert_same_crop(a, b):
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.detection_map, b.detection_map)
    for x, y in zip(a.param_dist_maps, b.param_dist_maps):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k in ("centers", "parameters", "categories", "difficult"):
        np.testing.assert_array_equal(a.labels[k], b.labels[k])
    np.testing.assert_array_equal(a.gt_centers, b.gt_centers)
    np.testing.assert_array_equal(a.gt_marks, b.gt_marks)
    np.testing.assert_array_equal(a.crop_data["tl_anchor"],
                                  b.crop_data["tl_anchor"])
    assert (a.name, tuple(a.shape)) == (b.name, tuple(b.shape))


def test_crop_image_w_maps_matches_jax():
    """Crops inside the image and at its bottom-right edge (cut short),
    with the labels reassigned, exactly."""
    for a, b in zip(_crops("torch"), _crops("jax")):
        _assert_same_crop(a, b)
    assert tuple(_crops("torch")[-1].shape) == (H - 45, W - 40)


def test_pr_curve_and_detection_threshold_match_jax():
    maps = [c.detection_map for c in _crops("jax")]
    labels = [c.labels for c in _crops("jax")]
    tj, mj = jdet.precision_recall_curve_on_detection_map(
        maps, labels, num_thresholds=100, dilation=2)
    tt, mt = tdet.precision_recall_curve_on_detection_map(
        maps, labels, num_thresholds=100, dilation=2)
    np.testing.assert_array_equal(tt, tj)
    for k in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(mt[k], mj[k])
    for target in ("f1", "f2", "f0.5"):
        assert tcal.calibrate_detection_threshold(maps, labels, target) == \
            jcal.calibrate_detection_threshold(maps, labels, target)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logistic_fit_matches_jax(seed):
    """Overlapping and separable 1-D data, balanced class weights."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=200) < 0.3
    x = rng.normal(size=200) + (2.0 if seed == 2 else 0.7) * y
    assert tcal._logistic_fit_1d(x, y) == jcal._logistic_fit_1d(x, y)


def test_param_dist_calibration_matches_jax():
    """The remap fits and their wrong-class draws from the same generator:
    the same coefficients, and the generators end in the same state."""
    out = []
    for pkg, cal, mappings in (("jax", jcal, j_mappings),
                               ("torch", tcal, t_mappings)):
        crops = _crops(pkg)
        rng = np.random.default_rng(11)
        fits = cal.calibrate_param_dists(
            [c.param_dist_maps for c in crops],
            [c.gt_centers for c in crops], [c.gt_marks for c in crops],
            mappings(C, 0, 16), rng)
        wrong = [cal.generate_wrong_value(3, m, 3, rng)
                 for m in mappings(C, 0, 16)]
        out.append((fits, wrong, rng.integers(2 ** 31)))
    assert out[0] == out[1]


def test_min_area_matches_jax():
    marks = [c.gt_marks for c in _crops("jax")]
    np.testing.assert_allclose(tcal.calibrate_min_area(marks),
                               jcal.calibrate_min_area(marks),
                               rtol=AREA_RTOL)
    assert tcal.calibrate_min_area([np.zeros((0, 3))]) == (1.0, 1.0)


@pytest.mark.parametrize("kind", ["legacy", "no-calibration-marks"])
def test_energy_setup_calibration_matches_jax(kind, tmp_path):
    """Both setups calibrate the same crops from the same generator and
    write the same ``calibration.json``; their energy maps agree."""
    cfg = ({"energy_setup": "legacy"} if kind == "legacy" else
           {"energy_setup": "no-calibration",
            "energy_setup_params": {"calib_marks": True,
                                    "ratio_prior": True}})
    out = {}
    for pkg, es in (("jax", jes), ("torch", tes)):
        setup = es.make_energy_setup(cfg)
        d = tmp_path / pkg
        d.mkdir()
        setup.calibrate(_crops(pkg), np.random.default_rng(5), str(d))
        out[pkg] = (setup, json.loads((d / "calibration.json").read_text()))
    (js, jc), (ts, tc) = out["jax"], out["torch"]
    assert tc.keys() == jc.keys()
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=AREA_RTOL, err_msg=k)
    assert ts.detection_threshold == js.detection_threshold
    assert ts.spec.names == js.spec.names
    jm = js.make_maps(_crops("jax")[1])
    tm = ts.make_maps(_crops("torch")[1])
    for f in ("position", "mark_maps", "min_area", "max_area"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), atol=MAP_ATOL,
                                   err_msg=f)


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_calibration")
    ws_j = tw.workspace(base / "jax")
    ws_t = tw.workspace(base / "torch")
    make_synth_dataset(name=DATASET, n_items=N_IMAGES, shape=SHAPE,
                       n_rect=30, seed=3, base_dir=str(ws_j / "data"))
    tw.copy_dataset(ws_j, ws_t, DATASET)
    for ws in (ws_j, ws_t):
        tw.oracle_pickles(ws, DATASET, "train", N_IMAGES, SHAPE)
    return ws_j, ws_t


@pytest.mark.parametrize("base", ["mpp_log_r12ttapar", "mpp_exact_smoke"])
def test_model_crops_and_calibration_match_jax(workspaces, base):
    """``MPPModel(load=False)`` calibrates on object-biased crops of the
    train subset (the flagship's no-calibration setup; the legacy one of
    the manual configs): the same ``calibration.json``; then the next
    ``_sample_crops`` draws the same crops, exactly."""
    ws_j, ws_t = workspaces
    cfg = tw.mpp_config(base, f"cal_{base}", DATASET, patch_size=48)
    with tw.inside(ws_j):
        jm = jmm.MPPModel(json.loads(json.dumps(cfg)), phase="train")
        jcrops = jm._sample_crops("train", 12)
    with tw.inside(ws_t):
        tm = tmm.MPPModel(json.loads(json.dumps(cfg)), phase="train",
                          device="cpu")
        tcrops = tm._sample_crops("train", 12)
    cal = [json.loads((ws / "models" / "mpp" / cfg["model_name"]
                       / "calibration.json").read_text())
           for ws in (ws_j, ws_t)]
    assert cal[1].keys() == cal[0].keys()
    for k in cal[0]:
        np.testing.assert_allclose(cal[1][k], cal[0][k], rtol=AREA_RTOL)
    assert len(tcrops) == len(jcrops) == 12
    for a, b in zip(tcrops, jcrops):
        _assert_same_crop(a, b)
    assert sum(len(c.gt_centers) for c in tcrops) > 0
    assert tm.rng.integers(2 ** 31) == jm.rng.integers(2 ** 31)
    assert set(tm.train_seconds) >= {"crops", "calibrate"}


def test_make_maps_on_device_of_the_maps():
    """The legacy setup remaps stacked maps where they lie (the chain's
    device)."""
    setup = tes.make_energy_setup({})
    assert isinstance(setup, tes.LegacyEnergySetup)
    crops = _crops("torch")
    setup.calibrate(crops, np.random.default_rng(0), None)
    c = crops[0]
    c.param_dist_maps = torch.from_numpy(np.stack(c.param_dist_maps))
    maps = setup.make_maps(c)
    assert maps.mark_maps.shape == (3, 24, 24, C)
