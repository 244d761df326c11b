"""The PyTorch port's flagship slice as a whole against the JAX package on
a 128x128 synthetic scene: two TTA PosNets (max-combined) and a TTA
ShapeNet with the same random narrow weights, the flagship's energy setup,
calibration and learned combiner, then the exact whole-scene chain and
papangelou scores. Maps and energy maps must agree to float tolerance and
the superstep budget exactly; the chains (threefry vs Philox) are compared
statistically over a few fixed seeds."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpp_cnn_rs_object_detection_torch.data.synth import synthetic_scene
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    PosNetModel as TPosNetModel,
)
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel as TShapeNetModel,
)
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    RJMCMCParams as TParams,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    state_from_arrays as t_state,
)
from mpp_cnn_rs_object_detection_tpu.models import unet as junet
from mpp_cnn_rs_object_detection_tpu.models.posnet_model import (
    PosNetModel as JPosNetModel,
)
from mpp_cnn_rs_object_detection_tpu.models.shapenet_model import (
    ShapeNetModel as JShapeNetModel,
)
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp.energy_setups import (
    NoCalibrationEnergySetup as JSetup,
)
from mpp_cnn_rs_object_detection_tpu.mpp.image_data import (
    ImageWMaps as JImageWMaps,
)
from mpp_cnn_rs_object_detection_tpu.mpp.rjmcmc import (
    RJMCMCParams as JParams,
)
from mpp_cnn_rs_object_detection_tpu.mpp.scene import (
    run_exact_scene as j_run_exact_scene,
)
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import default_mappings
from tests._torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "models_storage", "mpp",
                        "mpp_log_r12ttapar")
NARROW = [8, 16]
N_CLS = 32
SIZE = 128
SEEDS = (0, 1, 2, 3)
# a short anneal: 1202 moves -> 100 supersteps in 2 segments, cooling by
# 0.99 per move (0.99**12 per superstep) so the chain settles
N_STEPS, SEGMENT, ALPHA = 1200, 600, 0.99
# maps: fp32 U-Nets summed in another order (see test_torch_models.py)
RTOL, ATOL = 1e-4, 1e-4


def _posnet(seed):
    net = junet.PosNet(hidden_dims=NARROW, out_channels=3, dtype=jnp.float32)
    var = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                   train=False)
    # a steep div-classifier head: random narrow U-Nets give divergences
    # of ~3e-3, so the map peaks at the field's strongest sinks
    head = {"Conv_0": {"kernel": jnp.full((1, 1, 1, 1), -1000.0 - 100 * seed),
                       "bias": jnp.full((1,), -5.0)}}
    params = {"net": var["params"], "div": head}
    jm = JPosNetModel.__new__(JPosNetModel)
    jm.net, jm.div_clf = net, junet.DivClassifier()
    jm.state = types.SimpleNamespace(params=params,
                                     batch_stats=var["batch_stats"])
    jm.config = {"inference": {"tta": True}}
    jm._infer_fn_cache = {}
    tm = TPosNetModel({"div_clf_model": True, "loss": {"learn_mask": True},
                       "model": {"hidden_dims": NARROW, "dtype": "float32"},
                       "inference": {"tta": True}}, device="cpu")
    tm.load_variables(jax.device_get(params),
                      jax.device_get(var["batch_stats"]))
    return jm, tm


def _shapenet():
    net = junet.ShapeNet(hidden_dims=NARROW, n_classes=N_CLS,
                         dtype=jnp.float32)
    var = net.init(jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3)),
                   train=False)
    # peaked mark distributions (size ~6.5 px, ratio ~0.5: vehicle areas)
    params = jax.tree_util.tree_map(lambda a: a, var["params"])
    for head, favoured in (("Conv_0", 6), ("Conv_1", 16)):
        params[head] = dict(params[head], bias=params[head]["bias"]
                            .at[favoured].add(6.0))
    var = {"params": params, "batch_stats": var["batch_stats"]}
    jm = JShapeNetModel.__new__(JShapeNetModel)
    jm.net, jm.n_classes = net, N_CLS
    jm.mappings = default_mappings(n_classes=N_CLS)
    jm.state = types.SimpleNamespace(params=var["params"],
                                     batch_stats=var["batch_stats"])
    jm.config = {"inference": {"tta": True}}
    jm._infer_fn_cache = {}
    tm = TShapeNetModel({"trainer": {"n_classes": N_CLS},
                         "model": {"hidden_dims": NARROW, "dtype": "float32"},
                         "inference": {"tta": True}}, device="cpu")
    tm.load_variables(jax.device_get(var["params"]),
                      jax.device_get(var["batch_stats"]))
    return jm, tm


@pytest.fixture(scope="module")
def slice_run():
    image, _, _ = synthetic_scene(SIZE, SIZE, 12, seed=0)
    pos = [_posnet(0), _posnet(1)]
    shp = _shapenet()
    # --- JAX: the MPPModel.infer path on the same in-memory maps
    det_j = None
    for jm, _ in pos:
        d = jm.detection_map_on_image(image)
        det_j = d if det_j is None else np.maximum(det_j, d)
    dists_j = shp[0].dist_maps_on_image(image)
    setup_j = JSetup(ratio_prior=True)
    setup_j.load_calibration(FLAGSHIP)
    with open(os.path.join(FLAGSHIP, "energy_combination_model.json")) as f:
        comb_j = jcomb.combiner_from_dict(json.load(f))

    def jdata():
        return JImageWMaps(
            image=image, name="s", shape=(SIZE, SIZE),
            detection_map=det_j.copy(),
            param_dist_maps=[d.copy() for d in dists_j],
            mappings=shp[0].mappings, labels={},
            gt_centers=np.zeros((0, 2)), gt_marks=np.zeros((0, 3)))

    params_j = JParams(n_steps=N_STEPS, samples_interval=1, alpha_t=ALPHA)
    res_j = [j_run_exact_scene(jdata(), setup_j, comb_j, params_j, seed=s,
                               segment_size=SEGMENT) for s in SEEDS]
    maps_j = setup_j.make_maps(jdata())

    # --- the port: the same models behind its facade
    config = tmm.load_mpp_config("mpp_log_r12ttapar")
    config["inference"]["segment_size"] = SEGMENT
    config["inference"]["rjmcmc_params"].update(burn_in=N_STEPS,
                                                 alpha_t=ALPHA)
    setup_t, comb_t = tmm.load_energy_model(config, FLAGSHIP, "cpu")
    inf = tmm.SceneInference(config, [tm for _, tm in pos], shp[1], setup_t,
                             comb_t, device="cpu")
    data_t = inf.cnn_maps(image)
    maps_t = setup_t.make_maps(data_t)
    res_t = inf.run_scenes([inf.cnn_maps(image) for _ in SEEDS], SEEDS)
    return dict(det_j=det_j, dists_j=dists_j, data_t=data_t, maps_j=maps_j,
                maps_t=maps_t, res_j=res_j, res_t=res_t, setup_j=setup_j,
                comb_j=comb_j, params_t=inf.params)


def test_detection_and_mark_maps(slice_run):
    r = slice_run
    np.testing.assert_allclose(r["data_t"].detection_map.numpy(), r["det_j"],
                               rtol=RTOL, atol=ATOL)
    for got, want in zip(r["data_t"].param_dist_maps, r["dists_j"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_energy_maps(slice_run):
    mj, mt = slice_run["maps_j"], slice_run["maps_t"]
    for f in ("position", "mark_maps", "map_vmin", "map_vmax", "min_area",
              "max_area", "target_ratio"):
        np.testing.assert_allclose(getattr(mt, f).numpy(),
                                   np.asarray(getattr(mj, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def test_superstep_budget(slice_run):
    assert slice_run["params_t"] == TParams(n_steps=N_STEPS,
                                            samples_interval=1,
                                            alpha_t=ALPHA)
    for rj, rt in zip(slice_run["res_j"], slice_run["res_t"]):
        assert rt.supersteps == rt.planned_supersteps == 100
        assert rt.total_moves == rj.total_moves


def test_chain_statistics(slice_run):
    """Final n_points and energy (both scored by the JAX energy on the JAX
    maps) agree in the mean over the seeds: within 25 % of the JAX mean (at
    least 2 points) and within 25 % of the JAX mean energy."""
    r = slice_run
    spec = r["setup_j"].spec

    def stats(res):
        st = j_state(res.centers, res.marks, 256)
        return len(res.centers), float(jen.total_energy(
            st, r["maps_j"], spec, r["comb_j"]))

    nj, ej = np.array([stats(x) for x in r["res_j"]]).T
    nt, et = np.array([stats(x) for x in r["res_t"]]).T
    assert nj.mean() > 1 and ej.mean() < 0, (nj, ej)
    assert abs(nt.mean() - nj.mean()) <= max(2.0, 0.25 * nj.mean()), (nj, nt)
    assert abs(et.mean() - ej.mean()) <= 0.25 * abs(ej.mean()), (ej, et)
    # the port's papangelou scores are finite and positive
    for x in r["res_t"]:
        assert np.isfinite(x.scores).all() and (x.scores > 0).all()


def test_port_energy_scores_the_same_configuration(slice_run):
    """The port's energy of each final configuration on its own maps equals
    the JAX energy of it on the JAX maps."""
    r = slice_run
    comb_t = tmm.load_energy_model(
        {"energy_setup": "no-calibration",
         "energy_setup_params": {"ratio_prior": True}}, FLAGSHIP, "cpu")[1]
    for x in r["res_t"]:
        ut = ten.total_energy(t_state(x.centers, x.marks, 256), r["maps_t"],
                              ten.NO_CALIBRATION_SPEC, comb_t)
        uj = jen.total_energy(j_state(x.centers, x.marks, 256), r["maps_j"],
                              r["setup_j"].spec, r["comb_j"])
        np.testing.assert_allclose(float(ut), float(uj), rtol=1e-3, atol=1e-3)


def test_single_scene_entry_matches_batched(slice_run):
    """``run_exact_scene`` on one scene equals scene 0 of the batched run
    (same bucket, capacity and seed): the same chain, draw for draw."""
    from mpp_cnn_rs_object_detection_torch.mpp.scene import run_exact_scene

    r = slice_run
    config = tmm.load_mpp_config("mpp_log_r12ttapar")
    setup_t, comb_t = tmm.load_energy_model(config, FLAGSHIP, "cpu")
    one = run_exact_scene(r["data_t"], setup_t, comb_t, r["params_t"],
                          seed=SEEDS[0], segment_size=SEGMENT, device="cpu")
    ref = r["res_t"][0]
    assert one.capacity == ref.capacity and one.supersteps == ref.supersteps
    np.testing.assert_array_equal(one.centers, ref.centers)
    np.testing.assert_array_equal(one.marks, ref.marks)
    np.testing.assert_array_equal(one.scores, ref.scores)


def test_infer_scenes_reads_stored_models(tmp_path, monkeypatch):
    """The dataset entry point end to end on a stored workspace: model
    directories written by flax (narrow widths) are read by the port's
    msgpack reader when ``MPPModel.infer`` runs the CNN inference over a
    one-scene dataset; the detection map it stores matches the JAX models'
    map of the same image, and the export holds every point of the chain's
    final configuration (no NMS, which the JAX exact path does not have)."""
    import pickle

    import flax.serialization

    from mpp_cnn_rs_object_detection_torch.data.synth import (
        make_synth_dataset,
    )
    from mpp_cnn_rs_object_detection_torch.utils.files import load_results
    from mpp_cnn_rs_object_detection_torch.utils.png import read_unit_image

    def store(kind, name, config, params, stats):
        d = tmp_path / "models" / kind / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(dict(config,
                                                       model_name=name)))
        (d / "model.msgpack").write_bytes(flax.serialization.to_bytes(
            {"params": params, "batch_stats": stats, "opt_state": {},
             "epoch": 1}))

    pos_names = ("pos_slice_a", "pos_slice_b")
    pos_j = []
    for i, name in enumerate(pos_names):
        jm, _ = _posnet(i)
        pos_j.append(jm)
        store("posnet", name, {
            "div_clf_model": True,
            "model": {"hidden_dims": NARROW, "dtype": "float32"},
            "loss": {"learn_mask": True}, "inference": {"tta": True}},
            jm.state.params, jm.state.batch_stats)
    jm, _ = _shapenet()
    store("shapenet", "shape_slice", {
        "trainer": {"n_classes": N_CLS},
        "model": {"hidden_dims": NARROW, "dtype": "float32"},
        "inference": {"tta": True, "pos_model": pos_names[0]}},
        jm.state.params, jm.state.batch_stats)
    config = tmm.load_mpp_config("mpp_log_r12ttapar")
    mpp_dir = tmp_path / "models" / "mpp" / config["model_name"]
    mpp_dir.mkdir(parents=True)
    for f in ("calibration.json", "energy_combination_model.json"):
        (mpp_dir / f).write_text(open(os.path.join(FLAGSHIP, f)).read())
    config["dataset"].update(dataset="synth_slice",
                             position_model=list(pos_names),
                             shape_model="shape_slice")
    config["inference"]["segment_size"] = SEGMENT
    config["inference"]["rjmcmc_params"].update(burn_in=N_STEPS,
                                                 alpha_t=ALPHA)
    make_synth_dataset(name="synth_slice", n_items=1, shape=(SIZE, SIZE),
                       n_rect=12, seed=0, base_dir=str(tmp_path / "data"))
    (tmp_path / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(tmp_path / "data")],
         "model_path": [str(tmp_path / "models")]}))
    monkeypatch.chdir(tmp_path)

    model = tmm.MPPModel(config, load=True, device="cpu")
    model.infer("val")
    inference = tmp_path / "data" / "inference" / "synth_slice" / "val"
    # the stored PosNets against the JAX models on the image as stored
    image = read_unit_image(str(tmp_path / "data" / "synth_slice" / "val"
                                / "images" / "0000.png"))
    for name, jm in zip(pos_names, pos_j):
        got = load_results(str(inference / name / "0000_results.pkl"))
        np.testing.assert_allclose(got["detection_map"],
                                   jm.detection_map_on_image(image),
                                   rtol=RTOL, atol=ATOL)
    # the export: every point of the chain's configuration
    res = model.results[0]
    with open(inference / config["model_name"] / "0000_results.pkl",
              "rb") as f:
        det = pickle.load(f)
    n = len(res.scores)
    assert n > 0 and det["detection_center"].shape == (n, 2)
    np.testing.assert_array_equal(det["detection_center"], res.centers)
    np.testing.assert_array_equal(det["detection_marks"], res.marks)
    np.testing.assert_array_equal(det["detection_score"], res.scores)
    assert np.isfinite(res.scores).all() and (res.scores > 0).all()
    assert det["detection"].shape == (n, 4, 2)
    with open(inference / config["model_name"] / "dota" / "det"
              / "vehicle.txt") as f:
        assert len(f.read().splitlines()) == n
