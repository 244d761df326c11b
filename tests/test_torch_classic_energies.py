"""The CNN-free data term of the PyTorch port against the JAX package, on
the same numpy inputs: the five contrast measures and the gradient
alignment over a lane axis of points, the contrast setup's energy
vectors, the energy cache against a rebuild on the sequential and the
cell-parallel chains, and one superstep with the contrast column (the same
proposals give the same deltas and accept set).

Tolerance: rtol 1e-4 + atol 1e-5 (float32 window sums in another order),
at points and marks off two kinds of ties, found in float64 here:
  - a window pixel within 1e-4 of a rectangle's edge (an interior or rim
    mask), or a gradient sample within 1e-4 of a rounding boundary: float32
    cosines of the two libraries can put it on either side;
  - an interior or a rim whose variance ``E[x^2] - mean^2`` cancels in a
    channel, E[x^2] > 100 var (one pixel, or near-equal pixels): float32
    leaves noise of either sign there, which craciun's log and t-test's
    division amplify (JAX's own eager and jitted runs part by up to 95 %
    at one-pixel interiors);
  - for ``lafarge`` only, a point whose interior and rim means differ by
    less than 0.02 in a channel: that measure divides by the squared
    difference, which amplifies the sums' last-bit differences (its values
    reach ~600 there)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import classic_energies as tce
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import parallel_sampler as tps
from mpp_cnn_rs_object_detection_torch.mpp import rjmcmc as trj
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    ImageWMaps as TImageWMaps,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    expand_lanes,
    lane,
    state_from_arrays as t_state,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.data.label_processing import rect_mask
from mpp_cnn_rs_object_detection_tpu.mpp import classic_energies as jce
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp import energy_setups as jes
from mpp_cnn_rs_object_detection_tpu.mpp import parallel_sampler as jps
from mpp_cnn_rs_object_detection_tpu.mpp import rjmcmc as jrj
from mpp_cnn_rs_object_detection_tpu.mpp.image_data import (
    ImageWMaps as JImageWMaps,
)
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401

H = W = 96
RTOL, ATOL = 1e-4, 1e-5
TIE = 1e-4
LAFARGE_MIN_DMEAN = 0.02
VAR_COND = 100.0
MEASURES = ["craciun2", "craciun", "mean", "t-test", "lafarge"]
WEIGHTS = {"ContrastEnergy": 1.0, "OverlapPriorEnergy": 0.75,
           "AlignmentPriorEnergy": 0.1, "AreaPriorEnergy": 0.25,
           "RatioPriorEnergy": 0.2}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, *static):
    """JAX's ``fn`` jitted with its trailing ``static`` arguments closed
    over: one compile, where an eager first call compiles every
    primitive."""
    return jax.jit(lambda *a: fn(*a, *static))


def _scene(seed=0):
    """A textured (H, W, 3) float32 scene with 12 brighter rectangles, and
    their (centers, marks (size, ratio, angle))."""
    rng = np.random.default_rng(seed)
    img = (rng.random((H, W, 3)) * 0.6).astype(np.float32)
    centers, marks = [], []
    for _ in range(12):
        c = rng.uniform(12, H - 12, 2)
        a, b, ang = rng.uniform(3, 6), rng.uniform(7, 14), rng.uniform(0, 3)
        m = rect_mask((H, W), tuple(c), a, b, ang)
        img[m] += (0.4 * rng.random((int(m.sum()), 3))).astype(np.float32)
        centers.append(c)
        marks.append(((a + b) / 2, a / b, ang))
    return img, np.array(centers, np.float32), np.array(marks, np.float32)


def _points(seed, n, scene=None):
    """n random rectangles; with a scene's (centers, marks), the first
    half jittered around its objects, as a chain proposes them."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, H, (n, 2)).astype(np.float32)
    marks = np.stack([rng.uniform(3, 14, n), rng.uniform(0.2, 1.0, n),
                      rng.uniform(0, np.pi, n)], -1).astype(np.float32)
    if scene is not None:
        c, m = scene
        pick = rng.integers(len(c), size=n // 2)
        xy[:n // 2] = c[pick] + rng.uniform(-2, 2, (n // 2, 2))
        marks[:n // 2] = m[pick] * rng.uniform(0.8, 1.2, (n // 2, 3))
    return xy, marks


def _frame64(marks):
    size, ratio, angle = (marks[:, i].astype(np.float64) for i in range(3))
    length = 2 * size / (1 + ratio)
    a = angle + np.pi / 2
    return length, ratio * length, np.cos(a), np.sin(a)


def _contrast_off_ties(img, xy, marks, cfg):
    """Float64: the points whose window has no pixel within TIE of a mask
    edge, whose interior and rim variances are well conditioned
    (E[x^2] < VAR_COND var), and, for lafarge, whose means differ by
    LAFARGE_MIN_DMEAN."""
    win, r = cfg.window, cfg.window // 2
    length, width, cos, sin = _frame64(marks)
    keep = []
    for i, (cy, cx) in enumerate(xy.astype(np.float64)):
        yi = int(np.clip(np.round(np.float32(cy)) - r, 0, H - win))
        xi = int(np.clip(np.round(np.float32(cx)) - r, 0, W - win))
        py = (yi + np.arange(win) - cy)[:, None]
        px = (xi + np.arange(win) - cx)[None, :]
        u = cos[i] * py + sin[i] * px
        v = -sin[i] * py + cos[i] * px
        near = min(min(np.abs(np.abs(u) - (length[i] / 2 + p)).min(),
                       np.abs(np.abs(v) - (width[i] / 2 + p)).min())
                   for p in (-cfg.erode, cfg.gap, cfg.gap + cfg.dilation))
        def inside(p):
            return ((np.abs(u) <= length[i] / 2 + p)
                    & (np.abs(v) <= width[i] / 2 + p))

        inner = inside(-cfg.erode)
        rim = inside(cfg.gap + cfg.dilation) & ~inside(cfg.gap)
        patch = img[yi:yi + win, xi:xi + win].astype(np.float64)
        if not cfg.rgb:
            patch = patch.mean(-1, keepdims=True)
        ok = near > TIE
        for m in (inner, rim):
            if m.any():
                x = patch[m]
                ok &= bool(((x * x).mean(0) < VAR_COND * x.var(0)).all())
        if ok and cfg.measure == "lafarge" and inner.any():
            d = patch[inner].mean(0) - patch[rim].mean(0)
            ok = np.abs(d).min() > LAFARGE_MIN_DMEAN
        keep.append(ok)
    return np.array(keep)


def _gradient_off_ties(xy, marks, n=16):
    """Float64: the points none of whose edge samples lies within TIE of
    a rounding boundary."""
    length, width, cos, sin = _frame64(marks)
    t = (np.arange(n) + 0.5) / n - 0.5
    keep = []
    for i, (cy, cx) in enumerate(xy.astype(np.float64)):
        hu, hv = length[i] / 2, width[i] / 2
        u = np.concatenate([np.full(n, hu), np.full(n, -hu), t * length[i],
                            t * length[i]])
        v = np.concatenate([t * width[i], t * width[i], np.full(n, hv),
                            np.full(n, -hv)])
        py = u * cos[i] - v * sin[i] + cy
        px = u * sin[i] + v * cos[i] + cx
        frac = np.abs(np.concatenate([py, px]) % 1.0 - 0.5)
        keep.append(frac.min() > TIE)
    return np.array(keep)


def _close(got, want, keep):
    assert keep.sum() >= 0.5 * len(keep), keep.sum()
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
def test_contrast_measure_matches_jax(measure):
    """Two lanes of 160 points, each lane in its own scene, against the
    JAX package's per-point energies in that scene."""
    jcfg = jce.ContrastConfig(measure=measure, rgb=measure != "t-test")
    tcfg = tce.ContrastConfig(measure=measure, rgb=measure != "t-test")
    scenes = [_scene(s) for s in (0, 1)]
    imgs = [sc[0] for sc in scenes]
    pts = [_points(s, 160, sc[1:]) for s, sc in zip((2, 3), scenes)]
    got = tce.contrast_energies(
        _t(np.stack(imgs)), _t(np.stack([p[0] for p in pts])),
        _t(np.stack([p[1] for p in pts])), tcfg).numpy()
    assert got.shape == (2, 160)
    for b, (img, (xy, marks)) in enumerate(zip(imgs, pts)):
        want = np.asarray(_jit(jce.contrast_energy_points, jcfg)(
            jnp.asarray(img), jnp.asarray(xy), jnp.asarray(marks)))
        _close(got[b], want, _contrast_off_ties(img, xy, marks, tcfg))


@pytest.mark.parametrize("measure", MEASURES)
def test_contrast_energy_discriminates(measure):
    """JAX's own check, on the port: the rectangle on the object scores
    lower than the same rectangle on the background. The scene carries a
    little noise: on JAX's flat one both lafarge values are 0 up to the
    float noise of ``E[x^2] - mean^2``, which decides JAX's own check."""
    img = 0.2 + 0.05 * np.random.default_rng(0).random((64, 64, 3))
    img[rect_mask((64, 64), (32, 32), 5, 10, 0.5)] += 0.7
    img = img.astype(np.float32)
    cfg = tce.ContrastConfig(measure=measure, rgb=measure != "t-test")
    e = tce.contrast_energies(
        _t(img)[None], _t([[[32.0, 32.0], [10.0, 10.0]]]).float(),
        _t([[[7.5, 0.5, 0.5], [7.5, 0.5, 0.5]]]).float(), cfg)[0]
    assert e[0] < e[1], (measure, e)


def test_gradient_energy_matches_jax():
    """The port's (d/dy, d/dx, 0) field against JAX's (d/dy, d/dx)."""
    img = _scene(0)[0]
    grad = np.stack(np.gradient(img.mean(-1)), axis=-1)
    field = np.concatenate([grad, np.zeros_like(grad[..., :1])], -1)
    xy, marks = _points(4, 200)
    got = tce.gradient_energies(_t(field)[None], _t(xy)[None],
                                _t(marks)[None])[0].numpy()
    want = np.asarray(_jit(jce.gradient_energy_points)(
        jnp.asarray(grad), jnp.asarray(xy), jnp.asarray(marks)))
    _close(got, want, _gradient_off_ties(xy, marks))
    # JAX's own check: the rectangle on the object scores lower
    obj = np.zeros((64, 64, 3), np.float32) + 0.2
    obj[rect_mask((64, 64), (32, 32), 5, 10, 0.5)] = 0.9
    g = np.stack(np.gradient(obj.mean(-1)), axis=-1)
    e = tce.gradient_energies(_t(g)[None], _t([[[32.0, 32.0], [10.0, 10.0]]]
                                              ).float(),
                              _t([[[7.5, 0.5, 0.5]] * 2]).float())[0]
    assert e[0] < e[1], e


def _data(pkg, img, detection=0.0):
    cls, mappings, asarray = (
        (JImageWMaps, j_mappings(8, 0, 16), np.asarray) if pkg == "jax"
        else (TImageWMaps, t_mappings(8, 0, 16), _t))
    return cls(image=img, name="t", shape=img.shape[:2],
               detection_map=asarray(np.full(img.shape[:2], detection,
                                             np.float32)),
               param_dist_maps=[asarray(np.full(img.shape[:2] + (8,), 1 / 8,
                                                np.float32))] * 3,
               mappings=mappings, labels={},
               gt_centers=np.array([[32.0, 32.0]]),
               gt_marks=np.array([[7.5, 0.5, 0.5]]))


def _setups(contrast_type, img, detection=0.0):
    out = []
    for pkg, mod in (("jax", jes), ("torch", tes)):
        setup = mod.ContrastMeasureEnergySetup(contrast_type=contrast_type)
        data = _data(pkg, img, detection)
        setup.calibrate([data], np.random.default_rng(0), save_path=None)
        out += [setup, setup.make_maps(data)]
    return out


@pytest.mark.parametrize("contrast_type", ["craciun2", "t-test", "gradient"])
def test_contrast_setup_energy_vectors(contrast_type):
    """The setup's (K, 5) vectors against JAX's at a crowded configuration,
    through the one-configuration entry and the laned one with several
    configurations per lane. JAX's own setup cannot build the 'gradient'
    term: its 3-channel field meets the 2-vector normals
    (``tpu/mpp/classic_energies.py:183-188``, a broadcast error); there the
    port's data column is held to JAX's term on the 2-channel field and
    its prior columns to JAX's craciun2 vectors."""
    img, centers, marks = _scene(0)
    js, jmaps, ts, tmaps = _setups(contrast_type, img)
    assert ts.spec.names == tes.CONTRAST_NAMES == jes.CONTRAST_NAMES
    assert ts.spec.n_data == 1 and ts.calibration == js.calibration
    xy, mk = centers[:10], marks[:10]
    got = ten.energy_vectors(t_state(xy, mk, 12), tmaps, ts.spec).numpy()
    assert got.shape == (12, 5) and not got[10:].any()
    # the ratio prior: |0.5 - ratio|
    np.testing.assert_allclose(got[:10, 4], np.abs(0.5 - mk[:, 1]),
                               rtol=1e-6)
    keep = np.ones(12, bool)
    if contrast_type == "gradient":
        with pytest.raises(TypeError, match="broadcast"):
            _jit(jen.energy_vectors, js.spec)(j_state(xy, mk, 12), jmaps)
        grad = np.stack(np.gradient(img.mean(-1)), -1)
        col = np.asarray(_jit(jce.gradient_energy_points)(
            jnp.asarray(grad), jnp.asarray(xy), jnp.asarray(mk)))
        keep[:10] = _gradient_off_ties(xy, mk)
        np.testing.assert_allclose(got[:10, 0][keep[:10]], col[keep[:10]],
                                   rtol=RTOL, atol=ATOL)
        js2, jmaps2 = _setups("craciun2", img)[:2]
        want = np.asarray(_jit(jen.energy_vectors, js2.spec)(
            j_state(xy, mk, 12), jmaps2))
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=RTOL,
                                   atol=ATOL)
    else:
        want = np.asarray(_jit(jen.energy_vectors, js.spec)(
            j_state(xy, mk, 12), jmaps))
        keep[:10] = _contrast_off_ties(img, xy, mk, ts.spec.contrast)
        assert keep.sum() >= 9
        np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL,
                                   atol=ATOL)
    # laned: 2 configurations of one lane (the GT and a shifted copy)
    st = t_state(xy, mk, 12)
    shifted = st.replace(xy=st.xy + 0.5)
    two = ten.lane_energy_vectors(
        type(st)(xy=torch.stack([st.xy, shifted.xy])[None],
                 marks=torch.stack([st.marks, st.marks])[None],
                 alive=torch.stack([st.alive, st.alive])[None]),
        expand_lanes(tmaps, 1), ts.spec)[0]
    np.testing.assert_array_equal(two[0].numpy(), got)
    np.testing.assert_array_equal(
        two[1].numpy(), ten.energy_vectors(shifted, tmaps, ts.spec).numpy())


def _chain_inputs(contrast_type):
    img = _scene(5)[0]
    js, jmaps, ts, tmaps = _setups(contrast_type, img, detection=0.1)
    jc = jcomb.manual_hierarchical(jes.CONTRAST_NAMES, WEIGHTS,
                                   indicator_energy="ContrastEnergy")
    tc = tcomb.manual_hierarchical(tes.CONTRAST_NAMES, WEIGHTS,
                                   indicator_energy="ContrastEnergy")
    return img, js, jmaps, ts, tmaps, jc, tc


def test_cache_matches_rebuild_on_both_chains():
    """The sequential chain's ``update_cache`` after each of 12 proposals
    (births, moves, deaths) equals a rebuild, and the final cache and
    energy equal JAX's; then the cell-parallel chain's batched apply of
    non-interacting proposals gives JAX's cache and a rebuild's."""
    img, js, jmaps, ts, tmaps, jc, tc = _chain_inputs("craciun2")
    rng = np.random.default_rng(3)
    tst = t_state([[32, 32], [20, 20], [70, 60]],
                  [[7.5, 0.5, 0.5], [6.0, 0.5, 0.0], [8.0, 0.4, 1.0]], 8)
    tca = lane(trj.build_cache(*(expand_lanes(x, 1) for x in (tst, tmaps)),
                               ts.spec), 0)
    for i in range(12):
        kind = (1, 3, 3, 2)[i % 4]
        free, alive = (np.flatnonzero(~tst.alive.numpy()),
                       np.flatnonzero(tst.alive.numpy()))
        slot = int(rng.choice(free if kind == 1 else alive))
        xy = _t(rng.uniform(4, H - 4, 2).astype(np.float32))
        mk = _t(np.array([rng.uniform(4, 12), rng.uniform(0.3, 1.0),
                          rng.uniform(0, np.pi)], np.float32))
        tst = tps._apply_one(tst, kind, slot, xy, mk)
        tca = trj.update_cache(tst, tmaps, ts.spec, tca, slot)
        one = [expand_lanes(x, 1) for x in (tst, tmaps)]
        e_cache = float(trj.energy_from_cache(*one, ts.spec, tc,
                                              expand_lanes(tca, 1))[0])
        e_full = float(ten.total_energy(tst, tmaps, ts.spec, tc))
        np.testing.assert_allclose(e_cache, e_full, rtol=1e-5, atol=1e-5)
    xy, mk = (x.numpy() for x in (tst.xy, tst.marks))
    jst = j_state(xy, mk, 8)
    jst = jst.replace(alive=jnp.asarray(tst.alive.numpy()))
    jca = _jit(jrj.build_cache, js.spec)(jst, jmaps)
    alive = tst.alive.numpy()
    np.testing.assert_allclose(tca.pos_e.numpy()[alive],
                               np.asarray(jca.pos_e)[alive], rtol=RTOL,
                               atol=ATOL)
    assert not tca.mark_e.any()
    np.testing.assert_allclose(
        float(jax.jit(lambda s, m, c: jrj.energy_from_cache(
            s, m, js.spec, jc, c))(jst, jmaps, jca)), e_cache,
        rtol=1e-4, atol=1e-4)
    # the batched apply: birth, death, move, no-op on distinct slots
    xy, mk = _crowded()
    jst, tst = j_state(xy, mk, 10), t_state(xy, mk, 10)
    jca = _jit(jrj.build_cache, js.spec)(jst, jmaps)
    tca = lane(trj.build_cache(*(expand_lanes(x, 1) for x in (tst, tmaps)),
                               ts.spec), 0)
    kinds, slots, xys, ms = _proposals()
    accept = np.array([True, True, True, True, False])
    jpos, jmark = jax.jit(jax.vmap(
        lambda a, b: jps._unary_at(jmaps, js.spec, a, b)))(
        jnp.asarray(xys), jnp.asarray(ms))
    tpos, tmark = tps._unary_at(expand_lanes(tmaps, 1), ts.spec,
                                _t(xys)[None], _t(ms)[None])
    np.testing.assert_allclose(tpos[0].numpy(), np.asarray(jpos), rtol=RTOL,
                               atol=ATOL)
    assert not tmark.any() and not np.asarray(jmark).any()
    jst2, jca2 = jax.jit(lambda s, c, *a: jps._apply_batch(s, c, js.spec,
                                                          *a))(
        jst, jca, jnp.asarray(kinds), jnp.asarray(slots), jnp.asarray(xys),
        jnp.asarray(ms), jpos, jmark, jnp.asarray(accept))
    tst2, tca2 = (lane(x, 0) for x in tps._apply_batch(
        *(expand_lanes(x, 1) for x in (tst, tca)), ts.spec,
        *(_t(a)[None] for a in (kinds.astype(np.int64),
                                slots.astype(np.int64), xys, ms)),
        tpos, tmark, _t(accept)[None]))
    for f in ("pos_e", "dist", "overlap", "align"):
        np.testing.assert_allclose(getattr(tca2, f).numpy(),
                                   np.asarray(getattr(jca2, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    one = [expand_lanes(x, 1) for x in (tst2, tmaps)]
    fresh = trj.build_cache(*one, ts.spec)
    np.testing.assert_allclose(
        float(trj.energy_from_cache(*one, ts.spec, tc,
                                    expand_lanes(tca2, 1))[0]),
        float(trj.energy_from_cache(*one, ts.spec, tc, fresh)[0]),
        rtol=1e-5, atol=1e-5)


def _crowded():
    xy = np.array([[30, 30], [33, 34], [30, 70], [60, 60], [61, 63],
                   [80, 20], [70, 80]], np.float32)
    marks = np.tile(np.array([[6.0, 0.6, 0.4]], np.float32), (7, 1))
    marks[1, 2], marks[4, 2], marks[5, 0] = 1.2, 2.0, 9.0
    return xy, marks


def _proposals():
    """Birth into a free slot, death, translation, mark transform, no-op."""
    kinds = np.array([1, 2, 3, 3, 0], np.int32)
    slots = np.array([8, 1, 4, 6, 2], np.int32)
    xys = np.array([[45.0, 15.0], [33, 34], [59, 61], [70, 80], [0, 0]],
                   np.float32)
    ms = np.array([[5.0, 0.5, 0.3], [6, 0.6, 1.2], [6, 0.6, 1.1],
                   [7, 0.7, 0.4], [1, 0.1, 0.1]], np.float32)
    return kinds, slots, xys, ms


@pytest.mark.parametrize("contrast_type", ["craciun2", "lafarge"])
def test_superstep_contrast_deltas_and_accept_set(contrast_type):
    """One superstep's proposals through the contrast column: the port's
    deltas equal JAX's and a brute-force recompute, and with the same
    uniforms both accept the same set."""
    img, js, jmaps, ts, tmaps, jc, tc = _chain_inputs(contrast_type)
    xy, mk = _crowded()
    jst, tst = j_state(xy, mk, 10), t_state(xy, mk, 10)
    jca = _jit(jrj.build_cache, js.spec)(jst, jmaps)
    one = [expand_lanes(x, 1) for x in (tst, tmaps)]
    tca = trj.build_cache(*one, ts.spec)
    kinds, slots, xys, ms = _proposals()
    want = np.asarray(jax.jit(lambda s, c, m, *a: jps.superstep_deltas(
        s, c, m, js.spec, jc, *a))(
        jst, jca, jmaps, jnp.asarray(kinds), jnp.asarray(slots),
        jnp.asarray(xys), jnp.asarray(ms)))
    got, _ = tps.superstep_deltas(
        one[0], tca, one[1], ts.spec, tc,
        *(_t(a)[None] for a in (kinds.astype(np.int64),
                                slots.astype(np.int64), xys, ms)))
    got = got[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    u0 = float(trj.energy_from_cache(*one, ts.spec, tc, tca)[0])
    for i in range(4):
        st_i = tps._apply_one(tst, int(kinds[i]), int(slots[i]),
                              _t(xys[i]), _t(ms[i]))
        u_i = float(ten.total_energy(st_i, tmaps, ts.spec, tc))
        np.testing.assert_allclose(got[i], u_i - u0, rtol=RTOL, atol=1e-4,
                                   err_msg=f"proposal {i}")
    log_u = np.log(np.random.default_rng(9).random(len(kinds)))
    for temp in (1.0, 0.1):
        acc_j = (log_u < -want / temp) & (kinds != 0)
        acc_t = (log_u < -got / temp) & (kinds != 0)
        np.testing.assert_array_equal(acc_t, acc_j)


@pytest.mark.parametrize("mode", ["exact", "tiled"])
@pytest.mark.parametrize("contrast_type", ["craciun2", "gradient"])
def test_cli_runs_contrast_setups(tmp_path, mode, contrast_type):
    """``-p infereval -m mpp`` with ``energy_setup: "contrast"`` on oracle
    CNN maps (they give the chain its birth proposals), manual weights over
    the contrast names: the exact mode (a copy of ``mpp_exact_smoke``, one
    short segment) and the tiled mode (a copy of ``mpp_hrcM``, 150
    sequential steps) calibrate as the JAX package does and end with
    finite APs. (The JAX package's own CLI runs craciun2 in both modes and
    fails on 'gradient', as ``test_contrast_setup_energy_vectors``
    shows.)"""
    from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
    from mpp_cnn_rs_object_detection_torch.data.synth import (
        make_synth_dataset,
    )
    from mpp_cnn_rs_object_detection_tpu.mpp.mpp_model import (
        MPPModel as JMPPModel,
    )
    from tests import _torch_workspace as tw

    ws = tw.workspace(tmp_path)
    make_synth_dataset(name="synth_c", n_items=1, shape=(128, 128),
                       n_rect=30, seed=3, base_dir=str(ws / "data"))
    for subset in ("train", "val"):
        tw.oracle_pickles(ws, "synth_c", subset, 1, (128, 128))
    base = "mpp_exact_smoke" if mode == "exact" else "mpp_hrcM"
    cfg = tw.mpp_config(base, f"contrast_{mode}", "synth_c", patch_size=64)
    cfg.update(capacity=64, energy_setup="contrast",
               energy_setup_params={"contrast_type": contrast_type},
               manual={"threshold": 0.0, "indicator_energy": "ContrastEnergy",
                       "weights": WEIGHTS})
    rj = cfg["inference"]["rjmcmc_params"]
    rj.update(burn_in=86, samples_interval=32, alpha_t=0.99)
    if mode == "exact":
        cfg["inference"]["segment_size"] = 300
        rj["stopping"] = {"kind": "max_iter", "max_iter": 100}
    path = ws / "cfg.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws):
        model = t_main(["-p", "infereval", "-m", "mpp", "-c", str(path)],
                       device="cpu")
        if contrast_type == "craciun2":
            want = JMPPModel(dict(json.loads(json.dumps(cfg)),
                                  model_name="jax"), phase="train")
            assert want.energy_setup.calibration == \
                model.energy_setup.calibration
    assert isinstance(model.energy_setup, tes.ContrastMeasureEnergySetup)
    assert model.energy_model.kind == "manual_hierarchical"
    assert model.energy_model.indicator == 0
    r = model.results[0]
    if mode == "tiled":
        assert (r.supersteps, r.n_tiles) == (150, 16)
    assert np.isfinite(r.scores).all() and len(r.scores) > 0
    metrics = (ws / "data" / "inference" / "synth_c" / "val"
               / f"contrast_{mode}" / "dota" / "metrics0.50.json")
    assert np.isfinite(json.loads(metrics.read_text())["vehicle"]["ap"])


def test_two_slot_contrast_deltas_match_jax_and_bruteforce():
    """The split/merge pair through the contrast column: the two-slot dU
    of a split (slot moved, slot2 born) and a merge (slot moved, slot2
    killed), beside a one-slot move, against JAX's and against applying
    both slots and recomputing U."""
    img, js, jmaps, ts, tmaps, jc, tc = _chain_inputs("craciun2")
    xy, mk = _crowded()
    jst, tst = j_state(xy, mk, 10), t_state(xy, mk, 10)
    jca = _jit(jrj.build_cache, js.spec)(jst, jmaps)
    one = [expand_lanes(x, 1) for x in (tst, tmaps)]
    tca = trj.build_cache(*one, ts.spec)
    kinds = np.array([4, 5, 3])
    slots, slots2 = np.array([0, 3, 6]), np.array([8, 4, -1])
    xys = np.array([[28, 29], [61, 61], [71, 79]], np.float32)
    ms = np.array([[5.0, 0.5, 0.4], [7.0, 0.6, 2.0], [6.5, 0.6, 0.5]],
                  np.float32)
    xys2 = np.array([[36, 33], [0, 0], [0, 0]], np.float32)
    ms2 = np.array([[5.0, 0.5, 0.4], [1, 1, 1], [1, 1, 1]], np.float32)
    want = np.asarray(jax.jit(
        lambda s, c, m, k, sl, x, mm, sl2, x2, mm2: jps.superstep_deltas(
            s, c, m, js.spec, jc, k, sl, x, mm, slots2=sl2, xys2=x2,
            markss2=mm2))(
        jst, jca, jmaps, *(jnp.asarray(a) for a in (
            kinds.astype(np.int32), slots.astype(np.int32), xys, ms,
            slots2.astype(np.int32), xys2, ms2))))
    got, unary = tps.superstep_deltas(
        one[0], tca, one[1], ts.spec, tc,
        *(_t(a)[None] for a in (kinds, slots, xys, ms, slots2, xys2, ms2)))
    got = got[0].numpy()
    assert not unary[1].any() and not unary[3].any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    u0 = float(trj.energy_from_cache(*one, ts.spec, tc, tca)[0])
    for i in range(2):
        st = tst.replace(xy=tst.xy.clone(), marks=tst.marks.clone(),
                         alive=tst.alive.clone())
        st.xy[slots[i]], st.marks[slots[i]] = _t(xys[i]), _t(ms[i])
        if kinds[i] == 4:
            st.xy[slots2[i]], st.marks[slots2[i]] = _t(xys2[i]), _t(ms2[i])
        st.alive[slots2[i]] = bool(kinds[i] == 4)
        np.testing.assert_allclose(
            got[i], float(ten.total_energy(st, tmaps, ts.spec, tc)) - u0,
            rtol=RTOL, atol=1e-4, err_msg=f"two-slot proposal {i}")
