"""Cell-parallel superstep of the PyTorch port against the JAX package,
fed the SAME proposals (the two packages draw different random numbers):
exact per-proposal dU, the batched apply with its scratch-row scatter, and
the port's own chain keeping its carried cache and energy exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import kernels as tker
from mpp_cnn_rs_object_detection_torch.mpp import parallel_sampler as tps
from mpp_cnn_rs_object_detection_torch.mpp import rjmcmc as trj
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    empty_state,
    state_from_arrays as t_state,
    state_to_arrays,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp import parallel_sampler as jps
from mpp_cnn_rs_object_detection_tpu.mpp import rjmcmc as jrj
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401

H = W = 160
C = 8
# float32 sums of combined energies over K rows, in another order
RTOL, ATOL = 1e-4, 1e-4
WEIGHTS = {"PositionEnergy": 1.0, "ShapeEnergy": 0.25,
           "RectangleOverlapEnergy": 0.75, "ShapeAlignmentEnergy": 0.1,
           "AreaPriorEnergy": 0.25}
CENTERS = [(30, 30), (30, 120), (100, 60), (130, 130), (70, 100)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup():
    """The blob scene of tests/test_parallel_sampler.py, in both packages."""
    gy, gx = np.mgrid[:H, :W]
    det = np.zeros((H, W))
    for c in CENTERS:
        det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / (2 * 2.0 ** 2))
    det = np.clip(det, 0, 1).astype(np.float32)
    dist = np.full((H, W, C), 1.0 / C, np.float32)
    dist[..., 3] = 3.0 / C
    dist /= dist.sum(-1, keepdims=True)
    jm, tm = j_mappings(C, 0, 16), t_mappings(C, 0, 16)
    jmaps = jen.make_energy_maps(det, [-dist] * 3, 0.5, 4.0, 200.0, jm)
    tmaps = ten.make_energy_maps(det, [-_t(dist)] * 3, 0.5, 4.0, 200.0, tm)
    tkd = tker.make_kernel_data(_t(det), [_t(dist)] * 3, tm, intensity=5.0)
    jc = jcomb.manual_hierarchical(jen.LEGACY_SPEC.names, WEIGHTS)
    tc = tcomb.manual_hierarchical(ten.LEGACY_SPEC.names, WEIGHTS)
    return jmaps, tmaps, tkd, jc, tc, det


def _crowded_state():
    xy = np.array([[30, 30], [33, 34], [30, 120], [100, 60], [101, 63],
                   [130, 130], [70, 100], [20, 20]], np.float32)
    marks = np.tile(np.array([[6.0, 0.6, 0.4]], np.float32), (8, 1))
    marks[1, 2] = 1.2
    marks[4, 2] = 2.0
    return xy, marks


def test_superstep_deltas_match_jax_and_bruteforce():
    jmaps, tmaps, _, jc, tc, _ = _setup()
    xy, marks = _crowded_state()
    js, ts = j_state(xy, marks, 12), t_state(xy, marks, 12)
    spec_j, spec_t = jen.LEGACY_SPEC, ten.LEGACY_SPEC
    jca, tca = jrj.build_cache(js, jmaps, spec_j), trj.build_cache(
        ts, tmaps, spec_t)
    # birth into a free slot, death, move (translate), transform, no-op
    kinds = np.array([1, 2, 3, 3, 0], np.int32)
    slots = np.array([9, 1, 4, 6, 2], np.int32)
    xys = np.array([[31.0, 125.0], [33, 34], [99, 60], [70, 100], [0, 0]],
                   np.float32)
    ms = np.array([[5.0, 0.5, 0.3], [6, 0.6, 0.4], [6, 0.6, 1.1],
                   [7, 0.7, 0.4], [1, 0.1, 0.1]], np.float32)
    want = np.asarray(jps.superstep_deltas(
        js, jca, jmaps, spec_j, jc, jnp.asarray(kinds), jnp.asarray(slots),
        jnp.asarray(xys), jnp.asarray(ms)))
    got = tps.superstep_deltas(ts, tca, tmaps, spec_t, tc, _t(kinds).long(),
                               _t(slots).long(), _t(xys), _t(ms)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[4] == 0.0
    u0 = trj.energy_from_cache(ts, tmaps, spec_t, tc, tca)
    for i in range(4):
        st_i = tps._apply_one(ts, int(kinds[i]), int(slots[i]), _t(xys[i]),
                              _t(ms[i]))
        ca_i = trj.update_cache(st_i, tmaps, spec_t, tca, int(slots[i]))
        u_i = trj.energy_from_cache(st_i, tmaps, spec_t, tc, ca_i)
        np.testing.assert_allclose(got[i], float(u_i - u0), rtol=RTOL,
                                   atol=ATOL, err_msg=f"proposal {i}")


def _batch():
    """Non-interacting proposals on distinct slots (as one superstep makes
    them): two births, a death, a translation, a mark transform, a no-op."""
    kinds = np.array([1, 1, 2, 3, 3, 0], np.int32)
    slots = np.array([8, 9, 7, 5, 2, 0], np.int32)
    xys = np.array([[100.0, 15.0], [150.0, 40.0], [20, 20], [128.5, 131.0],
                    [30, 120], [1, 1]], np.float32)
    ms = np.array([[5.0, 0.5, 0.3], [7.0, 0.4, 2.0], [6, 0.6, 0.4],
                   [6, 0.6, 0.4], [6, 0.3, 0.9], [1, 1, 1]], np.float32)
    accept = np.array([True, True, True, True, False, True])
    return kinds, slots, xys, ms, accept


def test_apply_batch_matches_jax_and_sequential():
    jmaps, tmaps, _, _, _, _ = _setup()
    xy, marks = _crowded_state()
    js, ts = j_state(xy, marks, 12), t_state(xy, marks, 12)
    spec_j, spec_t = jen.LEGACY_SPEC, ten.LEGACY_SPEC
    jca, tca = jrj.build_cache(js, jmaps, spec_j), trj.build_cache(
        ts, tmaps, spec_t)
    kinds, slots, xys, ms, accept = _batch()
    jpos, jmark = jax.vmap(lambda a, b: jps._unary_at(jmaps, spec_j, a, b))(
        jnp.asarray(xys), jnp.asarray(ms))
    tpos, tmark = tps._unary_at(tmaps, spec_t, _t(xys), _t(ms))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tmark.numpy(), np.asarray(jmark), rtol=RTOL,
                               atol=ATOL)
    js2, jca2 = jps._apply_batch(
        js, jca, spec_j, jnp.asarray(kinds), jnp.asarray(slots),
        jnp.asarray(xys), jnp.asarray(ms), jpos, jmark, jnp.asarray(accept))
    ts2, tca2 = tps._apply_batch(
        ts, tca, spec_t, _t(kinds).long(), _t(slots).long(), _t(xys),
        _t(ms), tpos, tmark, _t(accept))
    for f in ("xy", "marks", "alive"):
        np.testing.assert_allclose(getattr(ts2, f).numpy(),
                                   np.asarray(getattr(js2, f)), err_msg=f)
    for f in ("dist", "overlap", "align", "pos_e", "mark_e", "polys",
              "areas"):
        np.testing.assert_allclose(getattr(tca2, f).numpy(),
                                   np.asarray(getattr(jca2, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    # sequential application of the accepted proposals gives the same cache
    st, ca = ts, tca
    for i in np.flatnonzero(accept & (kinds != 0)):
        st = tps._apply_one(st, int(kinds[i]), int(slots[i]), _t(xys[i]),
                            _t(ms[i]))
        if kinds[i] != 2:
            ca = trj.update_cache(st, tmaps, spec_t, ca, int(slots[i]))
    pair = (st.alive[:, None] & st.alive[None, :]).numpy()
    for f in ("dist", "overlap", "align"):
        np.testing.assert_allclose(getattr(tca2, f).numpy()[pair],
                                   getattr(ca, f).numpy()[pair], rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def test_chain_keeps_cache_and_energy_exact():
    """Many multi-accept supersteps: the scattered cache equals a rebuild
    on the final state and the carried energy equals a fresh one."""
    _, tmaps, tkd, _, tc, _ = _setup()
    spec = ten.LEGACY_SPEC
    n_cells = H // (2 * tps.CELL) + 1
    step = tps.make_parallel_step(tmaps, spec, tc, tkd, 0.994, 0.0, n_cells)
    state = empty_state(32)
    cache = trj.build_cache(state, tmaps, spec)
    gen = torch.Generator().manual_seed(0)
    (state, cache, energy, _), acc, prop = tps.run_steps(
        step, state, cache, torch.zeros(()), 1.0, 600, gen)
    assert int(state.n_points) >= 2 and int(acc) > 0
    fresh = trj.build_cache(state, tmaps, spec)
    pair = (state.alive[:, None] & state.alive[None, :]).numpy()
    for f in ("dist", "overlap", "align"):
        np.testing.assert_allclose(getattr(cache, f).numpy()[pair],
                                   getattr(fresh, f).numpy()[pair],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    alive = state.alive.numpy()
    np.testing.assert_allclose(cache.pos_e.numpy()[alive],
                               fresh.pos_e.numpy()[alive], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(energy),
                               float(ten.total_energy(state, tmaps, spec, tc)),
                               rtol=1e-3, atol=1e-3)


def test_parallel_chain_finds_objects():
    _, tmaps, tkd, _, tc, det = _setup()
    final, stats = tps.run_parallel_chain(
        torch.Generator().manual_seed(0), empty_state(32), tmaps,
        ten.LEGACY_SPEC, tc, tkd, n_supersteps=800, alpha_t=0.994)
    n = int(final.n_points)
    assert n >= 3, f"parallel sampler found only {n} points"
    assert float(stats.final_energy) < -1.0
    xy, _ = state_to_arrays(final)
    on_blob = sum(det[int(p[0]), int(p[1])] > 0.3 for p in xy)
    assert on_blob >= n - 1, f"{on_blob}/{n} points on detections"


def test_categorical_draw_follows_its_law():
    probs = torch.tensor([[0.0, 0.2, 0.0, 0.5, 0.3]]).expand(20000, 5)
    u = 1.0 - torch.rand(20000, generator=torch.Generator().manual_seed(1))
    counts = torch.bincount(tps._categorical(probs, u), minlength=5).float()
    np.testing.assert_allclose((counts / 20000).numpy(),
                               [0.0, 0.2, 0.0, 0.5, 0.3], atol=0.015)


def test_cell_assert():
    _, tmaps, tkd, _, tc, _ = _setup()
    wide = ten.EnergySpec(names=ten.LEGACY_SPEC.names, overlap_max_dist=48.0)
    with pytest.raises(AssertionError):
        tps.make_parallel_step(tmaps, wide, tc, tkd, 0.99, 0.0, 3)
