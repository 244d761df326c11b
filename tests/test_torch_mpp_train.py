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
calibrates, builds ``hierarchical_fixed`` and runs infereval. Last, the
options that raised ``NotImplementedError`` with their ``ROADMAP.md``
item, accepted since their item was ported. Both packages' training ends
with the energy attribution figure: on the replayed trainings the port's
attributions equal JAX's; and ``-p data_preview`` writes JAX's files."""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.mpp import train_weights as ttw
from mpp_cnn_rs_object_detection_torch.utils.png import png_header, read_png
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import figures as jfig
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
    # configuration and the sample index; each trainer's attribution
    # figure records what it draws
    replay = dict(cfg, model_name="mpp_replay")
    path = ws_t / "mpp_replay.json"
    path.write_text(json.dumps(replay))
    drawn = {}

    def capture(pkg, plot):
        def wrapped(attr, vectors, names, out):
            drawn[pkg] = (np.asarray(attr), np.asarray(vectors), list(names))
            return plot(attr, vectors, names, out)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtw, "sample_kernel_perturbed_batch",
                   lambda key, gt, kd, n_moves, n: _fake_pert_j(gt, n))
        mp.setattr(ttw, "sample_kernel_perturbed_batch",
                   lambda gen, gt, kd, n_moves, n: _fake_pert_t(gt, n))
        mp.setattr(jfig, "attribution_summary_plot",
                   capture("jax", jfig.attribution_summary_plot))
        mp.setattr(tmm, "attribution_summary_plot",
                   capture("torch", tmm.attribution_summary_plot))
        with tw.inside(ws_j):
            jmm.MPPModel(json.loads(json.dumps(replay)),
                         phase="train").train()
        with tw.inside(ws_t):
            t_main(["-p", "train", "-m", "mpp", "-c", str(path)],
                   device="cpu")
    return dict(ws_j=ws_j, ws_t=ws_t, cfg=cfg, train=tm_train, port=tm,
                attribution=drawn)


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


def test_attribution_figure_matches_jax(trained):
    """``-p train``'s last step on the replayed trainings (whose weights
    agree to ``REPLAY_ATOL``): the same 8 crops' GT energy vectors and
    term names, and the integrated-gradient attributions, within
    ``REPLAY_ATOL``; ``figures/energy_attribution.png`` in both stores,
    the port's at JAX's canvas."""
    got, want = (trained["attribution"][k] for k in ("torch", "jax"))
    assert got[2] == want[2] and len(got[2]) == 8
    assert got[1].shape == want[1].shape and len(got[1]) > 0
    np.testing.assert_allclose(got[1], want[1], atol=REPLAY_ATOL)
    np.testing.assert_allclose(got[0], want[0], atol=REPLAY_ATOL)
    t_png, j_png = (_store(trained[ws], "mpp_replay") / "figures"
                    / "energy_attribution.png" for ws in ("ws_t", "ws_j"))
    assert png_header(str(t_png))[:2] == np.asarray(
        Image.open(j_png)).shape[:2]


def test_data_preview_matches_jax(trained):
    """``-p data_preview -m mpp``: the first train scenes written as the
    JAX package writes them (``data_preview/preview_{name}_gt.png``),
    pixel for pixel."""
    cfg = trained["cfg"]
    with tw.inside(trained["ws_j"]):
        jmm.MPPModel(json.loads(json.dumps(cfg)), load=True).data_preview()
    with tw.inside(trained["ws_t"]):
        t_main(["-p", "data_preview", "-m", "mpp", "-c",
                str(trained["ws_t"] / "mpp_trained.json")], device="cpu")
    j_dir, t_dir = (_store(trained[ws], "mpp_trained") / "data_preview"
                    for ws in ("ws_j", "ws_t"))
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) == [
        f"preview_{i:04}_gt.png" for i in range(N_IMAGES)]
    for name in names:
        np.testing.assert_array_equal(read_png(str(t_dir / name)),
                                      np.asarray(Image.open(j_dir / name)))


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
def test_what_still_raises(case, item, tmp_path):
    """The tile mesh of a tiled manual config raised naming item 15 until
    that item was ported: it is now accepted, and no error of the port
    names item 15. CNN training on
    the host patch pipeline raised naming item 12 until that item was
    ported: ``pos_quick`` / ``shape_quick`` (no
    ``data_loader.device_pipeline``) now train, cut to one epoch of 32
    patches of 32^2 and a U-Net [8, 16], and no error of the port names
    item 12. The contrast energy setup raised naming item 13 until that
    item was ported: it now builds, with the contrast names and data
    term, and no error of the port names item 13."""
    if case.startswith("train"):
        kind = case.split()[1]
        name = "pos_quick" if kind == "posnet" else "shape_quick"
        with open(os.path.join(tw.ROOT, "model_configs", kind,
                               name + ".json")) as f:
            cfg = json.load(f)
        assert not cfg["data_loader"].get("device_pipeline")
        cfg["data_loader"]["dataset"] = "tiny"
        cfg["data_loader"]["patch_maker_params"].update(patch_size=32,
                                                        n_patches=32)
        cfg["trainer"].update(n_epochs=1, batch_size=16)
        cfg["model"] = {"hidden_dims": [8, 16], "dtype": "float32"}
        (tmp_path / "paths_config.json").write_text(json.dumps(
            {"dataset_path": [str(tmp_path)],
             "model_path": [str(tmp_path / "models")]}))
        make_synth_dataset(name="tiny", n_items=2, shape=(64, 64),
                           n_rect=12, seed=1, base_dir=str(tmp_path))
        (tmp_path / "cfg.json").write_text(json.dumps(cfg))
        with tw.inside(tmp_path):
            model = t_main(["-p", "train", "-m", kind, "-c", "cfg.json"],
                           device="cpu")
        assert model.logger.log["epoch"] == [0]
        assert np.isfinite(model.logger.log["train_loss"]).all()
        assert (tmp_path / "models" / kind / name / "model.msgpack").exists()
        assert not (tmp_path / f"temp_{name}").exists()
        port = os.path.join(tw.ROOT, "mpp_cnn_rs_object_detection_torch")
        for path in glob.glob(os.path.join(port, "**", "*.py"),
                              recursive=True):
            with open(path) as f:
                assert f"item {item})" not in f.read(), path
        return
    if case.startswith("contrast"):
        setup = tes.make_energy_setup({"energy_setup": "contrast"})
        assert isinstance(setup, tes.ContrastMeasureEnergySetup)
        assert setup.spec.names == tes.CONTRAST_NAMES
        assert setup.spec.data_term == "contrast"
        port = os.path.join(tw.ROOT, "mpp_cnn_rs_object_detection_torch")
        for path in glob.glob(os.path.join(port, "**", "*.py"),
                              recursive=True):
            with open(path) as f:
                assert f"item {item})" not in f.read(), path
        return
    assert case.startswith("tile_mesh")
    cfg = tmm.load_mpp_config("mpp_r3")
    assert "manual" in cfg and cfg["inference"]["scene_mode"] == "tiled"
    tmm.check_inference_config(cfg)
    cfg["inference"]["tile_mesh"] = True
    tmm.check_inference_config(cfg)
    port = os.path.join(tw.ROOT, "mpp_cnn_rs_object_detection_torch")
    for path in glob.glob(os.path.join(port, "**", "*.py"), recursive=True):
        with open(path) as f:
            assert f"item {item})" not in f.read(), path


# every MPP config: its train mode, and what its inference still lacks
# (mpp_r2's scene mesh, item 15, is ported)
_INFER_ITEM: dict = {}


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-5] for p in glob.glob(os.path.join(
        tw.ROOT, "model_configs", "mpp", "*.json"))))
def test_every_mpp_config_trains_or_builds(name):
    """The 26 logistic configs train with the ordering criterion on the
    no-calibration setup; the manual ones build on the legacy setup; at
    infer, every config runs (tiled or exact, with or without the
    split/merge pair, the meshed ``mpp_r2`` too)."""
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
