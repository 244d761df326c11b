"""Deterministic MPP pieces of the PyTorch port against the JAX package on
the same inputs: geometry, mappings, dihedral TTA, energy vectors, the
energy cache (build / update / energy), papangelou scores, combiners,
kernel data, the naive initialisation and the scene budget math."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import kernels as tker
from mpp_cnn_rs_object_detection_torch.mpp import rjmcmc as trj
from mpp_cnn_rs_object_detection_torch.mpp import scene as tsc
from mpp_cnn_rs_object_detection_torch.mpp.calibration import (
    apply_remap_param_dist as t_remap,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    ImageWMaps as TImageWMaps,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    expand_lanes,
    lane,
    state_from_arrays as t_state,
)
from mpp_cnn_rs_object_detection_torch.ops import dihedral as tdi
from mpp_cnn_rs_object_detection_torch.ops import geometry as tgeo
from mpp_cnn_rs_object_detection_torch.ops import mappings as tmap
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp import kernels as jker
from mpp_cnn_rs_object_detection_tpu.mpp import rjmcmc as jrj
from mpp_cnn_rs_object_detection_tpu.mpp import scene as jsc
from mpp_cnn_rs_object_detection_tpu.mpp.calibration import (
    apply_remap_param_dist as j_remap,
)
from mpp_cnn_rs_object_detection_tpu.mpp.image_data import (
    ImageWMaps as JImageWMaps,
)
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops import dihedral as jdi
from mpp_cnn_rs_object_detection_tpu.ops import geometry as jgeo
from mpp_cnn_rs_object_detection_tpu.ops import mappings as jmap
from tests._torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "models_storage", "mpp",
                        "mpp_log_r12ttapar")
H = W = 96
C = 8
# float32 arithmetic in another order (XLA vs torch CPU kernels)
RTOL, ATOL = 1e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene_arrays(seed=0):
    rng = np.random.default_rng(seed)
    det = rng.uniform(0, 1, (H, W)).astype(np.float32)
    dist = rng.uniform(0.05, 1, (3, H, W, C)).astype(np.float32)
    dist /= dist.sum(-1, keepdims=True)
    return det, dist


def _config(seed=1, n=18, cap=24):
    rng = np.random.default_rng(seed)
    # clustered points: overlapping and aligned pairs, plus dead slots
    xy = rng.uniform(20, 70, (n, 2)).astype(np.float32)
    xy[1] = xy[0] + 3.0
    marks = np.stack([rng.uniform(3, 12, n), rng.uniform(0.2, 1, n),
                      rng.uniform(0, np.pi, n)], -1).astype(np.float32)
    return xy, marks, cap


def _maps(spec_name="no_calib", seed=0):
    det, dist = _scene_arrays(seed)
    jm = jmap.default_mappings(n_classes=C, size_max=16)
    tm = tmap.default_mappings(n_classes=C, size_max=16)
    jmaps = jen.make_energy_maps(det, [-d for d in dist], 0.3, 20.0, 90.0,
                                 jm, target_ratio=0.5)
    tmaps = ten.make_energy_maps(det, [-_t(d) for d in dist], 0.3, 20.0, 90.0,
                                 tm, target_ratio=0.5)
    return jmaps, tmaps, jm, tm, det, dist


def _specs(name):
    return {"legacy": (jen.LEGACY_SPEC, ten.LEGACY_SPEC),
            "no_calib": (jen.NO_CALIBRATION_SPEC,
                         ten.NO_CALIBRATION_SPEC)}[name]


def _flagship_combiners():
    with open(os.path.join(FLAGSHIP, "energy_combination_model.json")) as f:
        d = json.load(f)
    return jcomb.combiner_from_dict(d), tcomb.combiner_from_dict(d)


def _combiners(name):
    if name == "no_calib":
        return _flagship_combiners()
    w = {"PositionEnergy": 1.0, "ShapeEnergy": 0.25,
         "RectangleOverlapEnergy": 0.75, "ShapeAlignmentEnergy": 0.1,
         "AreaPriorEnergy": 0.25}
    return (jcomb.manual_hierarchical(jen.LEGACY_SPEC.names, w),
            tcomb.manual_hierarchical(ten.LEGACY_SPEC.names, w))


def close(got, want, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **{
        "rtol": RTOL, "atol": ATOL, **kw})


# ------------------------------------------------------------------ ops


def test_geometry_functions():
    xy, marks, _ = _config(n=30)
    pj = jgeo.marks_to_poly(xy, marks[:, 0], marks[:, 1], marks[:, 2])
    pt = tgeo.marks_to_poly(_t(xy), _t(marks[:, 0]), _t(marks[:, 1]),
                            _t(marks[:, 2]))
    close(pt, pj, rtol=1e-6, atol=1e-5)
    close(tgeo.quad_intersection_area_matrix(pt, pt),
          jgeo.quad_intersection_area_matrix(pj, pj))
    close(tgeo.convex_quad_intersection_area(pt[:, None], pt[None]),
          jgeo._quad_intersection_area_matrix_impl(pj, pj))
    close(tgeo.quad_overlap_ratio(pt[:5], pt[5:10]),
          jgeo.quad_overlap_ratio(pj[:5], pj[5:10]))
    close(tgeo.rect_area(_t(marks[:, 0]), _t(marks[:, 1])),
          jgeo.rect_area(marks[:, 0], marks[:, 1]))
    s, r, a = marks[:, 0], marks[:, 1], marks[:, 2]
    for got, want in zip(tgeo.sra_to_wla(s, r, a), jgeo.sra_to_wla(s, r, a)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tgeo.wla_to_sra(s, s + 1, a),
                         jgeo.wla_to_sra(s, s + 1, a)):
        np.testing.assert_array_equal(got, want)
    polys_np = tgeo.rect_to_poly_np(xy, s, s + 2, a)
    np.testing.assert_array_equal(polys_np,
                                  jgeo.rect_to_poly_np(xy, s, s + 2, a))
    assert tgeo.polygon_to_abw(polys_np[3]) == jgeo.polygon_to_abw(
        polys_np[3])


def test_mappings():
    jm, tm = jmap.default_mappings(), tmap.default_mappings()
    vals = np.linspace(-1, 40, 57)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.feature_mapping, a.feature_mapping)
        np.testing.assert_array_equal(b.value_to_class(vals),
                                      a.value_to_class(vals))
        np.testing.assert_array_equal(
            b.value_to_class(_t(vals.astype(np.float32))).numpy(),
            np.asarray(a.value_to_class(jnp.asarray(vals, jnp.float32))))
        cls = np.arange(a.n_classes)
        np.testing.assert_array_equal(b.class_to_center_value(cls),
                                      a.class_to_center_value(cls))


@pytest.mark.parametrize("k,flip", jdi.D4_ELEMENTS)
def test_dihedral(k, flip):
    rng = np.random.default_rng(k + 4 * flip)
    arr = rng.normal(size=(6, 9, 4)).astype(np.float32)
    t = tdi.transform_image(_t(arr), k, flip)
    np.testing.assert_array_equal(t.numpy(), jdi.transform_image(arr, k, flip))
    np.testing.assert_array_equal(
        tdi.inverse_transform_map(t, k, flip).numpy(), arr)
    np.testing.assert_array_equal(tdi.angle_gather_indices(8, k, flip),
                                  jdi.angle_gather_indices(8, k, flip))
    pts = rng.integers(0, 6, (5, 2))
    np.testing.assert_array_equal(tdi.transform_points(pts, 6, 9, k, flip),
                                  jdi.transform_points(pts, 6, 9, k, flip))


def test_tta_averages():
    rng = np.random.default_rng(9)
    img = rng.normal(size=(10, 14, 3)).astype(np.float32)
    w = rng.normal(size=(3, 8)).astype(np.float32)
    cyc = (False, True)
    got = tdi.tta_dist_maps(lambda x: [x @ _t(w), (x @ _t(w)) ** 2],
                            _t(img), cyclic=cyc)
    want = jdi.tta_dist_maps(lambda x: [x @ w, (x @ w) ** 2], img, cyclic=cyc)
    for g, wnt in zip(got, want):
        close(g, wnt)


# ------------------------------------------------------------- energies


@pytest.mark.parametrize("name", ["legacy", "no_calib"])
def test_energy_vectors_and_total(name):
    jmaps, tmaps, *_ = _maps()
    jspec, tspec = _specs(name)
    jc, tc = _combiners(name)
    xy, marks, cap = _config()
    js, ts = j_state(xy, marks, cap), t_state(xy, marks, cap)
    close(ten.energy_vectors(ts, tmaps, tspec),
          jen.energy_vectors(js, jmaps, jspec))
    close(ten.total_energy(ts, tmaps, tspec, tc),
          jen.total_energy(js, jmaps, jspec, jc))
    close(tmaps.position, jmaps.position, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["legacy", "no_calib"])
def test_cache_build_update_energy(name):
    jmaps, tmaps, *_ = _maps()
    jspec, tspec = _specs(name)
    jc, tc = _combiners(name)
    xy, marks, cap = _config()
    js, ts = j_state(xy, marks, cap), t_state(xy, marks, cap)
    # the port's cache functions take lanes: this configuration is one
    def t_energy(cache):
        return trj.energy_from_cache(expand_lanes(ts, 1),
                                     expand_lanes(tmaps, 1), tspec, tc,
                                     expand_lanes(cache, 1))[0]

    jca = jrj.build_cache(js, jmaps, jspec)
    tca = lane(trj.build_cache(expand_lanes(ts, 1), expand_lanes(tmaps, 1),
                               tspec), 0)
    for f in ("dist", "overlap", "align", "pos_e", "mark_e", "polys",
              "areas"):
        close(getattr(tca, f), getattr(jca, f), err_msg=f)
    close(t_energy(tca), jrj.energy_from_cache(js, jmaps, jspec, jc, jca))
    # move slot 4 next to slot 0, birth into dead slot 20
    for slot, new_xy, new_m in [(4, xy[0] + 1.5, [6.0, 0.5, 1.0]),
                                (20, xy[1] - 2.0, [4.0, 0.8, 0.2])]:
        js = js.replace(xy=js.xy.at[slot].set(new_xy),
                        marks=js.marks.at[slot].set(jnp.asarray(new_m)),
                        alive=js.alive.at[slot].set(True))
        ts.xy[slot] = _t(new_xy)
        ts.marks[slot] = torch.tensor(new_m)
        ts.alive[slot] = True
        jca = jrj.update_cache(js, jmaps, jspec, jca, slot)
        tca = trj.update_cache(ts, tmaps, tspec, tca, slot)
        for f in ("dist", "overlap", "align", "pos_e", "mark_e", "polys"):
            close(getattr(tca, f), getattr(jca, f), err_msg=f)
        close(t_energy(tca), jrj.energy_from_cache(js, jmaps, jspec, jc, jca))
        close(t_energy(tca), ten.total_energy(ts, tmaps, tspec, tc))


@pytest.mark.parametrize("name", ["legacy", "no_calib"])
def test_papangelou(name):
    jmaps, tmaps, *_ = _maps()
    jspec, tspec = _specs(name)
    jc, tc = _combiners(name)
    xy, marks, cap = _config(seed=3)
    got = trj.papangelou(t_state(xy, marks, cap), tmaps, tspec, tc)
    want = jrj.papangelou(j_state(xy, marks, cap), jmaps, jspec, jc)
    close(got, want)
    # brute force: exp(-(U(x) - U(x minus u))) for one point
    ts = t_state(xy, marks, cap)
    u_all = ten.total_energy(ts, tmaps, tspec, tc)
    ts.alive[2] = False
    u_wo = ten.total_energy(ts, tmaps, tspec, tc)
    close(got[2], torch.exp(-(u_all - u_wo)))


def test_combiners_and_v1_migration():
    jc, tc = _flagship_combiners()
    vec = np.random.default_rng(2).normal(size=(7, 8)).astype(np.float32)
    close(tc(_t(vec)), jc(jnp.asarray(vec)), rtol=1e-6, atol=1e-6)
    d = {"kind": "logistic", "names": list(ten.NO_CALIBRATION_SPEC.names),
         "params": {"weights": [0.3] * 8, "bias": 0.1}}
    close(tcomb.combiner_from_dict(d)(_t(vec)),
          jcomb.combiner_from_dict(d)(jnp.asarray(vec)), rtol=1e-6,
          atol=1e-6)
    assert float(tcomb.combiner_from_dict(d).params["bias"]) == \
        pytest.approx(0.8)
    tl = tcomb.load_combiner(os.path.join(
        FLAGSHIP, "energy_combination_model.json"))
    close(tl(_t(vec)), jc(jnp.asarray(vec)), rtol=1e-6, atol=1e-6)


def test_kernel_data_and_remap():
    _, _, jm, tm, det, dist = _maps()
    jkd = jker.make_kernel_data(det, list(dist), jm, intensity=7.0)
    tkd = tker.make_kernel_data(_t(det), [_t(d) for d in dist], tm,
                                intensity=7.0)
    for f in ("birth_cdf", "log_birth_density", "mark_dists",
              "padded_density", "map_vmin", "map_vmax", "p_kernels",
              "log_norm_const", "intensity", "sigma_trl", "sigma_trf"):
        close(getattr(tkd, f), getattr(jkd, f), err_msg=f)
    np.testing.assert_array_equal(tkd.map_cyclic.numpy(),
                                  np.asarray(jkd.map_cyclic))
    coefs, icpts = [1.5, -0.5, 2.0], [0.1, 0.2, -0.3]
    close(t_remap(_t(dist), coefs, icpts), j_remap(jnp.asarray(dist), coefs,
                                                   icpts))
    for g, w in zip(t_remap([_t(d) for d in dist], coefs, icpts),
                    j_remap(list(dist), coefs, icpts)):
        close(g, w)


def test_naive_detection_and_budget():
    _, _, jm, tm, det, dist = _maps(seed=5)
    common = dict(image=np.zeros((H, W, 3)), name="s", shape=(H, W),
                  labels={}, gt_centers=np.zeros((0, 2)),
                  gt_marks=np.zeros((0, 3)))
    jd = JImageWMaps(detection_map=det, param_dist_maps=list(dist),
                     mappings=jm, **common)
    td = TImageWMaps(detection_map=_t(det),
                     param_dist_maps=[_t(d) for d in dist], mappings=tm,
                     **common)
    for got, want in zip(tsc.naive_detection(td, 0.9),
                         jsc.naive_detection(jd, 0.9)):
        np.testing.assert_array_equal(got, want)
    for hw in [(64, 64), (128, 96), (469, 753), (958, 926), (2000, 300)]:
        assert tsc.scene_shape_bucket(*hw) == jsc.scene_shape_bucket(*hw)
    params = trj.RJMCMCParams(n_steps=30000, samples_interval=1)
    b = tsc.superstep_budget(1024, 1024, params)
    # flagship: 30002 moves / 12 per tile-superstep, rounded up to 8
    # segments of 341
    assert (b.mps, b.ms_tile, b.seg_super, b.total_super) == (144, 12, 341,
                                                              2728)
    assert b.alpha_super == pytest.approx(0.999 ** 12)


def test_calibrate_min_area():
    from mpp_cnn_rs_object_detection_torch.mpp.calibration import (
        calibrate_min_area as t_cal,
    )
    from mpp_cnn_rs_object_detection_tpu.mpp.calibration import (
        calibrate_min_area as j_cal,
    )

    rng = np.random.default_rng(11)
    marks = [np.stack([rng.uniform(3, 12, n), rng.uniform(0.2, 1, n),
                       rng.uniform(0, 3, n)], -1).astype(np.float32)
             for n in (40, 0, 25)]
    np.testing.assert_allclose(t_cal(marks), j_cal(marks), rtol=1e-5)
