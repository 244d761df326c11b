"""The MPP's train side through the port's command line, against the JAX
package, in two workspaces over copies of one synthetic dataset (3 train
and 3 val images of 128 x 128, from a seed) with oracle CNN maps.

``-p train -m mpp`` on a copy of the flagship config (the no-calibration
setup, the ordering criterion, a logistic combiner; depth cut: 4 epochs of
16 crops of 64 px, 4 samples per crop, capacity 64) in the port, and
``MPPModel(phase="train").train()`` in the JAX package; then both run
``infereval`` with what they trained. The calibration files agree, each
package loads the other's combiner, and the two trained combiners give
AP within the stated band through one chain. With the same perturbed
configurations given to both trainers (the draws are threefry in one
package and Philox in the other), the trained weights agree.
The legacy manual mode (a copy of ``mpp_exact_smoke`` on the same maps)
calibrates, builds ``hierarchical_fixed`` and runs infereval. Last, what
still raises ``NotImplementedError``, with its ``ROADMAP.md`` item."""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_torch.mpp import train_weights as ttw
from mpp_cnn_rs_object_detection_tpu.mpp import mpp_model as jmm
from mpp_cnn_rs_object_detection_tpu.mpp import train_weights as jtw
from tests import _torch_workspace as tw
from tests._torch_util import one_torch_thread  # noqa: F401
from tests.test_torch_train_weights import _fake_pert_j, _fake_pert_t

DATASET = "synth_tr"
N_IMAGES, SHAPE, N_RECT, SEED = 3, (128, 128), 56, 7
# AP of the two packages' trained combiners through one chain (the port's,
# at the same chain seeds), so the training draws alone differ. Over three
# training seeds (the generator of the perturbations and the batch order;
# crops and chain seeds fixed), the JAX package's own AP spans 0.020,
# 0.046 and 0.054 at IoU 0.05, 0.5 and 0.75 (0.8426-0.8626, 0.6203-0.6665,
# 0.2466-0.3003); through one chain the two packages' trained combiners
# differ by at most 0.054 (AP@0.5). The band is that spread rounded up to
# tests/test_torch_pipeline.py's AP_TOL. Two chains are not compared here:
# one combiner over 5 sets of chain seeds spans 0.145 (JAX) and 0.154
# (port) at AP@0.5, wider than the band (PERF.md, open questions).
AP_TOL = 0.1
# calibration areas: float32 in another library
AREA_RTOL = 1e-6
# trained weights from the same perturbed configurations: real energy
# vectors, float32 in each package, through 16 Adam steps (4.4e-6 apart at
# this test's seed), held to the 20-step test's PARAM_ATOL
REPLAY_ATOL = 1e-4


def _config(base, name, **ordering):
    cfg = tw.mpp_config(base, name, DATASET, patch_size=64)
    cfg["capacity"] = 64
    if "ordering_criterion" in cfg:
        cfg["data_loader"]["batch_size"] = 4
        cfg["ordering_criterion"].update(n_epochs=4, n_crops=16,
                                         samples_per_image=4, **ordering)
    cfg["inference"]["segment_size"] = 600
    cfg["inference"]["rjmcmc_params"].update(
        burn_in=1800, alpha_t=0.99,
        stopping={"kind": "max_iter", "max_iter": 400})
    return cfg


def _aps(ws, name):
    out = {}
    for postfix in ("", "-SV"):
        for iou in (0.05, 0.1, 0.25, 0.5, 0.75):
            path = (ws / "data" / "inference" / DATASET / "val" / name
                    / ("dota" + postfix) / f"metrics{iou:.2f}.json")
            out[postfix, iou] = json.loads(path.read_text())["vehicle"]["ap"]
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_mpp_train")
    ws_j = tw.workspace(base / "jax")
    ws_t = tw.workspace(base / "torch")
    make_synth_dataset(name=DATASET, n_items=N_IMAGES, shape=SHAPE,
                       n_rect=N_RECT, seed=SEED, base_dir=str(ws_j / "data"))
    tw.copy_dataset(ws_j, ws_t, DATASET)
    for ws in (ws_j, ws_t):
        for subset in ("train", "val"):
            tw.oracle_pickles(ws, DATASET, subset, N_IMAGES, SHAPE)
    cfg = _config("mpp_log_r12ttapar", "mpp_trained")
    with tw.inside(ws_j):
        jmm.MPPModel(json.loads(json.dumps(cfg)), phase="train").train()
        jm = jmm.MPPModel(json.loads(json.dumps(cfg)), load=True)
        jm.infer(subset="val")
        jm.eval()
    path = ws_t / "mpp_trained.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws_t):
        tm_train = t_main(["-p", "train", "-m", "mpp", "-c", str(path)],
                          device="cpu")
        tm = t_main(["-p", "infereval", "-m", "mpp", "-c", str(path)],
                    device="cpu")
    # the same perturbations in both trainers: functions of the GT
    # configuration and the sample index
    replay = dict(cfg, model_name="mpp_replay")
    path = ws_t / "mpp_replay.json"
    path.write_text(json.dumps(replay))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtw, "sample_kernel_perturbed_batch",
                   lambda key, gt, kd, n_moves, n: _fake_pert_j(gt, n))
        mp.setattr(ttw, "sample_kernel_perturbed_batch",
                   lambda gen, gt, kd, n_moves, n: _fake_pert_t(gt, n))
        with tw.inside(ws_j):
            jmm.MPPModel(json.loads(json.dumps(replay)),
                         phase="train").train()
        with tw.inside(ws_t):
            t_main(["-p", "train", "-m", "mpp", "-c", str(path)],
                   device="cpu")
    return dict(ws_j=ws_j, ws_t=ws_t, cfg=cfg, train=tm_train, port=tm)


def _store(ws, name):
    return ws / "models" / "mpp" / name


def test_train_writes_the_jax_format(trained):
    """The port's CLI train: finite losses per epoch in the log, weights
    moved, the JSON of format 2, and the same calibration as JAX's."""
    t_store = _store(trained["ws_t"], "mpp_trained")
    j_store = _store(trained["ws_j"], "mpp_trained")
    d = json.loads((t_store / "energy_combination_model.json").read_text())
    assert d["version"] == tcomb.COMBINER_FORMAT_VERSION == 2
    assert d["kind"] == "logistic"
    assert tuple(d["names"]) == tes.NO_CALIB_NAMES + ("RatioPriorEnergy",)
    assert max(abs(w - 1.0) for w in d["params"]["weights"]) > 1e-2
    log = trained["train"].logger.log
    assert len(log["loss"]) == 4 and np.isfinite(log["loss"]).all()
    cal = [json.loads((s / "calibration.json").read_text())
           for s in (j_store, t_store)]
    assert cal[0].keys() == cal[1].keys()
    for k in cal[0]:
        np.testing.assert_allclose(cal[1][k], cal[0][k], rtol=AREA_RTOL)
    sec = trained["train"].train_seconds
    assert {"crops", "calibrate", "prepare", "perturb", "vectors",
            "steps"} <= set(sec)


def test_each_package_loads_the_others_combiner(trained):
    t_file = str(_store(trained["ws_t"], "mpp_trained")
                 / "energy_combination_model.json")
    j_file = str(_store(trained["ws_j"], "mpp_trained")
                 / "energy_combination_model.json")
    vec = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    for path in (t_file, j_file):
        jc, tc = jcomb.load_combiner(path), tcomb.load_combiner(path)
        np.testing.assert_allclose(
            tc(torch.from_numpy(vec)).numpy(), np.asarray(jc(vec)),
            atol=1e-6)


def test_training_matches_jax_on_the_same_perturbations(trained):
    """The CLI train with JAX's perturbation sampler and the port's both
    replaced by one function of the GT configuration: the crops, the
    calibration, the batch order, the energy vectors and the Adam steps
    are each package's own, and the trained weights agree."""
    got, want = (json.loads((_store(trained[ws], "mpp_replay")
                             / "energy_combination_model.json").read_text())
                 for ws in ("ws_t", "ws_j"))
    assert got["kind"] == want["kind"] == "logistic"
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=REPLAY_ATOL,
                                   err_msg=k)
    assert max(abs(w - 1.0) for w in got["params"]["weights"]) > 1e-2


def test_trained_ap_agrees_with_jax(trained):
    """Each package's pipeline with its own trained combiner runs to
    finite APs; then the JAX-trained combiner through the port's chain
    against the port-trained one (the same chain and chain seeds, so the
    training's difference alone)."""
    ws_j, ws_t = trained["ws_j"], trained["ws_t"]
    aj, at = _aps(ws_j, "mpp_trained"), _aps(ws_t, "mpp_trained")
    assert np.isfinite(list(aj.values()) + list(at.values())).all()
    assert min(aj["", 0.05], at["", 0.05]) > 0.3, (aj, at)
    assert sorted(trained["port"].results) == list(range(N_IMAGES))
    cfg = dict(trained["cfg"], model_name="mpp_trained_jax")
    shutil.copytree(_store(ws_j, "mpp_trained"),
                    _store(ws_t, "mpp_trained_jax"))
    path = ws_t / "mpp_trained_jax.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws_t):
        t_main(["-p", "infereval", "-m", "mpp", "-c", str(path)],
               device="cpu")
    ajt = _aps(ws_t, "mpp_trained_jax")
    for key in at:
        assert abs(ajt[key] - at[key]) <= AP_TOL, (key, ajt[key], at[key])


def test_manual_legacy_mode_runs(trained):
    """``mpp_exact_smoke`` (legacy setup, manual weights) on the oracle
    maps: ``infereval`` calibrates (a finite detection threshold), builds
    ``hierarchical_fixed`` with weights summing to 1 per group, writes both
    files in the JAX format, and runs the exact chain to finite APs; the
    JAX package builds the same combiner from the same calibration."""
    ws_t, ws_j = trained["ws_t"], trained["ws_j"]
    cfg = _config("mpp_exact_smoke", "mpp_manual")
    path = ws_t / "mpp_manual.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws_t):
        model = t_main(["-p", "infereval", "-m", "mpp", "-c", str(path)],
                       device="cpu")
    with tw.inside(ws_j):
        jm = jmm.MPPModel(json.loads(json.dumps(cfg)), load=True)
    comb = model.energy_model
    assert comb.kind == "hierarchical_fixed"
    for k in ("data_weight", "prior_weight", "data_prior_weight"):
        assert abs(float(comb.params[k].sum()) - 1.0) < 1e-6
    store = _store(ws_t, "mpp_manual")
    cal = json.loads((store / "calibration.json").read_text())
    assert np.isfinite(cal["detection_threshold"])
    want = jcomb.combiner_to_dict(jm.energy_model)
    got = json.loads((store / "energy_combination_model.json").read_text())
    assert got.keys() == want.keys() and got["kind"] == want["kind"]
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-6)
    j_cal = jm.energy_setup.calibration
    assert cal["detection_threshold"] == j_cal["detection_threshold"]
    assert cal["param_dist_remap_coefs"] == j_cal["param_dist_remap_coefs"]
    aps = _aps(ws_t, "mpp_manual")
    assert np.isfinite(list(aps.values())).all()


@pytest.mark.parametrize("case,item", [
    ("train posnet", 12), ("train shapenet", 12), ("tile_mesh mpp_r3", 15),
    ("contrast setup", 13)])
def test_what_still_raises(case, item):
    """CNN training, the tile mesh of a tiled manual config, and the
    contrast energy setup raise with the ROADMAP.md item that ports them
    (the tiled mode itself is ported)."""
    if case.startswith("tile_mesh"):
        cfg = tmm.load_mpp_config("mpp_r3")
        assert "manual" in cfg and cfg["inference"]["scene_mode"] == "tiled"
        tmm.check_inference_config(cfg)
        cfg["inference"]["tile_mesh"] = True
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        if case.startswith("train"):
            t_main(["-p", "train", "-m", case.split()[1], "-c",
                    "pos_r2cp_tta"], device="cpu")
        elif case.startswith("tile_mesh"):
            tmm.check_inference_config(cfg)
        else:
            tes.make_energy_setup({"energy_setup": "contrast"})


# every MPP config: its train mode, and what its inference still lacks
_INFER_ITEM = {"mpp_r2": 15}


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-5] for p in glob.glob(os.path.join(
        tw.ROOT, "model_configs", "mpp", "*.json"))))
def test_every_mpp_config_trains_or_builds(name):
    """The 26 logistic configs train with the ordering criterion on the
    no-calibration setup; the manual ones build on the legacy setup; at
    infer, every config runs (tiled or exact, with or without the
    split/merge pair) except the meshed one (item 15)."""
    cfg = tmm.load_mpp_config(name)
    setup = tes.make_energy_setup(cfg)
    if "manual" in cfg:
        assert isinstance(setup, tes.LegacyEnergySetup)
    else:
        oc = cfg["ordering_criterion"]
        assert isinstance(setup, tes.NoCalibrationEnergySetup)
        assert oc["weight_model_type"] == "logistic"
        assert "integral_criterion" not in cfg
    item = _INFER_ITEM.get(name)
    if item is None:
        tmm.check_inference_config(cfg)
        assert cfg["inference"].get("scene_mode", "tiled") in ("tiled",
                                                               "exact")
    else:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tmm.check_inference_config(cfg)
