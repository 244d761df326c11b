"""Cell-parallel superstep of the PyTorch port against the JAX package,
fed the SAME proposals (the two packages draw different random numbers):
exact per-proposal dU (one-slot, and two-slot for the split/merge pair),
the batched apply with its scratch-row scatter, and the port's own chain
keeping its carried cache and energy exact; the split/merge and switched
supersteps' equilibria against JAX's. The port's superstep runs lanes
(scenes or restarts) on a leading axis: one lane, and two lanes with their
own states, maps and proposals, each against the JAX functions on that
lane's inputs."""

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
    expand_lanes,
    lane,
    stack_lanes,
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
    empty_state as j_empty,
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401
from tests.test_parallel_sampler import _setup as j_setup

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


def _one_lane(*items):
    return [expand_lanes(x, 1) for x in items]


def _lanes(*tensors):
    """Proposal arrays of one lane with the lane axis added."""
    return [_t(a)[None] for a in tensors]


def _cache(state, maps, spec):
    """The cache of one configuration (the port builds lanes)."""
    return lane(trj.build_cache(*_one_lane(state, maps), spec), 0)


def _energy(state, maps, spec, comb, cache):
    """U of one configuration from its cache."""
    return trj.energy_from_cache(*_one_lane(state, maps), spec, comb,
                                 *_one_lane(cache))[0]


def _setup(centers=CENTERS):
    """The blob scene of tests/test_parallel_sampler.py, in both packages."""
    gy, gx = np.mgrid[:H, :W]
    det = np.zeros((H, W))
    for c in centers:
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
    jca, tca = jrj.build_cache(js, jmaps, spec_j), _cache(ts, tmaps, spec_t)
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
    got, _ = tps.superstep_deltas(
        *_one_lane(ts, tca, tmaps), spec_t, tc,
        *_lanes(kinds.astype(np.int64), slots.astype(np.int64), xys, ms))
    got = got[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[4] == 0.0
    u0 = _energy(ts, tmaps, spec_t, tc, tca)
    for i in range(4):
        st_i = tps._apply_one(ts, int(kinds[i]), int(slots[i]), _t(xys[i]),
                              _t(ms[i]))
        ca_i = trj.update_cache(st_i, tmaps, spec_t, tca, int(slots[i]))
        u_i = _energy(st_i, tmaps, spec_t, tc, ca_i)
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
    jca, tca = jrj.build_cache(js, jmaps, spec_j), _cache(ts, tmaps, spec_t)
    kinds, slots, xys, ms, accept = _batch()
    jpos, jmark = jax.vmap(lambda a, b: jps._unary_at(jmaps, spec_j, a, b))(
        jnp.asarray(xys), jnp.asarray(ms))
    tpos, tmark = (x[0] for x in tps._unary_at(
        *_one_lane(tmaps), spec_t, *_lanes(xys, ms)))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tmark.numpy(), np.asarray(jmark), rtol=RTOL,
                               atol=ATOL)
    js2, jca2 = jps._apply_batch(
        js, jca, spec_j, jnp.asarray(kinds), jnp.asarray(slots),
        jnp.asarray(xys), jnp.asarray(ms), jpos, jmark, jnp.asarray(accept))
    ts2, tca2 = (lane(x, 0) for x in tps._apply_batch(
        *_one_lane(ts, tca), spec_t,
        *_lanes(kinds.astype(np.int64), slots.astype(np.int64), xys, ms),
        tpos[None], tmark[None], _t(accept)[None]))
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


OTHER_CENTERS = [(40, 40), (60, 130), (120, 30), (140, 100)]


def _second_lane():
    """Another scene, configuration and set of proposals for lane 1."""
    jmaps, tmaps, _, _, _, _ = _setup(OTHER_CENTERS)
    xy = np.array([[40, 40], [42, 44], [60, 130], [120, 30], [140, 100],
                   [139, 96]], np.float32)
    marks = np.tile(np.array([[5.5, 0.5, 0.9]], np.float32), (6, 1))
    marks[1, 2] = 0.2
    marks[5, 0] = 7.0
    kinds = np.array([3, 1, 2, 0, 3, 1], np.int32)
    slots = np.array([0, 7, 5, 1, 3, 9], np.int32)
    xys = np.array([[41.0, 41.5], [100, 100], [139, 96], [2, 2],
                    [121, 31], [60, 133]], np.float32)
    ms = np.array([[5.5, 0.6, 0.9], [6, 0.5, 1.0], [7, 0.5, 0.9],
                   [1, 1, 1], [5.5, 0.5, 2.5], [6.5, 0.4, 0.1]], np.float32)
    accept = np.array([True, True, True, True, True, False])
    return jmaps, tmaps, xy, marks, kinds, slots, xys, ms, accept


def _two_lanes():
    """Both packages' inputs for two lanes: the crowded state with the
    proposals of ``_batch`` on the blob scene, and ``_second_lane``."""
    jmaps0, tmaps0, _, _, _, _ = _setup()
    xy0, marks0 = _crowded_state()
    lane0 = (jmaps0, tmaps0, xy0, marks0) + _batch()
    lanes = [lane0, _second_lane()]
    js = [j_state(x[2], x[3], 12) for x in lanes]
    ts = [t_state(x[2], x[3], 12) for x in lanes]
    return lanes, js, ts


def _stack(arrays, dtype=None):
    return torch.stack([_t(np.asarray(a, dtype)) for a in arrays])


def test_superstep_deltas_two_lanes_match_jax():
    """One call over two lanes (states, maps and proposals of their own)
    gives each lane the JAX dU of its proposals on its inputs."""
    lanes, js, ts = _two_lanes()
    spec_j, spec_t = jen.LEGACY_SPEC, ten.LEGACY_SPEC
    jc, tc = _setup()[3:5]
    tmaps = stack_lanes(lambda b: lanes[b][1], 2)
    tstate = stack_lanes(lambda b: ts[b], 2)
    tcache = trj.build_cache(tstate, tmaps, spec_t)
    got, _ = tps.superstep_deltas(
        tstate, tcache, tmaps, spec_t, tc,
        _stack([x[4] for x in lanes], np.int64),
        _stack([x[5] for x in lanes], np.int64),
        _stack([x[6] for x in lanes]), _stack([x[7] for x in lanes]))
    got = got.numpy()
    for b, x in enumerate(lanes):
        jca = jrj.build_cache(js[b], x[0], spec_j)
        want = np.asarray(jps.superstep_deltas(
            js[b], jca, x[0], spec_j, jc, jnp.asarray(x[4]),
            jnp.asarray(x[5]), jnp.asarray(x[6]), jnp.asarray(x[7])))
        np.testing.assert_allclose(got[b], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"lane {b}")
    # each lane equals its own one-lane call
    for b, x in enumerate(lanes):
        one, _ = tps.superstep_deltas(
            *_one_lane(ts[b], _cache(ts[b], x[1], spec_t), x[1]),
            spec_t, tc, *_lanes(x[4].astype(np.int64),
                                x[5].astype(np.int64), x[6], x[7]))
        np.testing.assert_array_equal(got[b], one[0].numpy())


def test_apply_batch_two_lanes_match_jax():
    """One batched apply over two lanes scatters each lane's accepted
    proposals into its own rows (and its own scratch row) exactly as the
    JAX apply does on that lane."""
    lanes, js, ts = _two_lanes()
    spec_j, spec_t = jen.LEGACY_SPEC, ten.LEGACY_SPEC
    tmaps = stack_lanes(lambda b: lanes[b][1], 2)
    tstate = stack_lanes(lambda b: ts[b], 2)
    tcache = trj.build_cache(tstate, tmaps, spec_t)
    xys = _stack([x[6] for x in lanes])
    ms = _stack([x[7] for x in lanes])
    tpos, tmark = tps._unary_at(tmaps, spec_t, xys, ms)
    ts2, tca2 = tps._apply_batch(
        tstate, tcache, spec_t, _stack([x[4] for x in lanes], np.int64),
        _stack([x[5] for x in lanes], np.int64), xys, ms, tpos, tmark,
        _stack([x[8] for x in lanes]))
    for b, x in enumerate(lanes):
        jmaps = x[0]
        jca = jrj.build_cache(js[b], jmaps, spec_j)
        jpos, jmark = jax.vmap(
            lambda a, c: jps._unary_at(jmaps, spec_j, a, c))(
                jnp.asarray(x[6]), jnp.asarray(x[7]))
        np.testing.assert_allclose(tpos[b].numpy(), np.asarray(jpos),
                                   rtol=RTOL, atol=ATOL)
        js2, jca2 = jps._apply_batch(
            js[b], jca, spec_j, jnp.asarray(x[4]), jnp.asarray(x[5]),
            jnp.asarray(x[6]), jnp.asarray(x[7]), jpos, jmark,
            jnp.asarray(x[8]))
        for f in ("xy", "marks", "alive"):
            np.testing.assert_allclose(getattr(ts2, f)[b].numpy(),
                                       np.asarray(getattr(js2, f)),
                                       err_msg=f"lane {b} {f}")
        for f in ("dist", "overlap", "align", "pos_e", "mark_e", "polys",
                  "areas"):
            np.testing.assert_allclose(getattr(tca2, f)[b].numpy(),
                                       np.asarray(getattr(jca2, f)),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"lane {b} {f}")


def test_chain_keeps_cache_and_energy_exact():
    """Many multi-accept supersteps: the scattered cache equals a rebuild
    on the final state and the carried energy equals a fresh one."""
    _, tmaps, tkd, _, tc, _ = _setup()
    spec = ten.LEGACY_SPEC
    n_cells = H // (2 * tps.CELL) + 1
    # two lanes of the same maps, each with its own generator
    lmaps, lkd = expand_lanes(tmaps, 2), expand_lanes(tkd, 2)
    step = tps.make_parallel_step(lmaps, spec, tc, lkd, 0.994, 0.0, n_cells)
    state = expand_lanes(empty_state(32), 2)
    cache = trj.build_cache(state, lmaps, spec)
    gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
    (states, caches, energy, _), acc, prop = tps.run_steps(
        step, state, cache, torch.zeros(2), 1.0, 600, gens)
    assert not torch.equal(states.xy[0], states.xy[1])
    for b in range(2):
        state, cache = lane(states, b), lane(caches, b)
        assert int(state.n_points) >= 2 and int(acc[b]) > 0
        fresh = _cache(state, tmaps, spec)
        pair = (state.alive[:, None] & state.alive[None, :]).numpy()
        for f in ("dist", "overlap", "align"):
            np.testing.assert_allclose(getattr(cache, f).numpy()[pair],
                                       getattr(fresh, f).numpy()[pair],
                                       rtol=RTOL, atol=ATOL, err_msg=f)
        alive = state.alive.numpy()
        np.testing.assert_allclose(cache.pos_e.numpy()[alive],
                                   fresh.pos_e.numpy()[alive], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(
            float(energy[b]), float(ten.total_energy(state, tmaps, spec, tc)),
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


def _two_slot_batch():
    """The split/merge inputs of tests/test_parallel_sampler.py: a split
    of slot 0 (its second child overlapping slot 1), a merge of slots 3
    and 4, then a birth, a death and a move with no second slot."""
    kinds = np.array([4, 5, 1, 2, 3], np.int64)
    slots = np.array([0, 3, 9, 1, 6], np.int64)
    slots2 = np.array([10, 4, -1, -1, -1], np.int64)
    xys = np.array([[28.0, 28.0], [100.5, 61.5], [31.0, 125.0], [33, 34],
                    [70, 100]], np.float32)
    xys2 = np.array([[32.0, 33.0], [0, 0], [0, 0], [0, 0], [0, 0]],
                    np.float32)
    ms = np.array([[5.5, 0.55, 0.3], [6.0, 0.6, 1.1], [5.0, 0.5, 0.3],
                   [6, 0.6, 0.4], [7, 0.7, 0.4]], np.float32)
    ms2 = np.array([[6.5, 0.65, 0.5], [1, 0.1, 0.1], [1, 0.1, 0.1],
                    [1, 0.1, 0.1], [1, 0.1, 0.1]], np.float32)
    return kinds, slots, xys, ms, slots2, xys2, ms2


def test_two_slot_deltas_match_jax_and_bruteforce():
    """The top-3 two-slot dU of a split and a merge against JAX's and
    against applying both slots, refreshing the cache and recomputing U;
    the single-slot lanes of the same call keep their one-slot deltas."""
    jmaps, tmaps, _, jc, tc, _ = _setup()
    xy, marks = _crowded_state()
    js, ts = j_state(xy, marks, 12), t_state(xy, marks, 12)
    spec_j, spec_t = jen.LEGACY_SPEC, ten.LEGACY_SPEC
    jca, tca = jrj.build_cache(js, jmaps, spec_j), _cache(ts, tmaps, spec_t)
    kinds, slots, xys, ms, slots2, xys2, ms2 = _two_slot_batch()
    want = np.asarray(jps.superstep_deltas(
        js, jca, jmaps, spec_j, jc, *(jnp.asarray(a) for a in (
            kinds.astype(np.int32), slots.astype(np.int32), xys, ms)),
        slots2=jnp.asarray(slots2.astype(np.int32)), xys2=jnp.asarray(xys2),
        markss2=jnp.asarray(ms2)))
    got, unary = tps.superstep_deltas(
        *_one_lane(ts, tca, tmaps), spec_t, tc,
        *_lanes(kinds, slots, xys, ms, slots2, xys2, ms2))
    assert len(unary) == 4
    got = got[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    one, _ = tps.superstep_deltas(*_one_lane(ts, tca, tmaps), spec_t, tc,
                                  *_lanes(kinds[2:], slots[2:], xys[2:],
                                          ms[2:]))
    np.testing.assert_allclose(got[2:], one[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    u0 = _energy(ts, tmaps, spec_t, tc, tca)
    for i in range(2):
        st = ts.replace(xy=ts.xy.clone(), marks=ts.marks.clone(),
                        alive=ts.alive.clone())
        st.xy[slots[i]], st.marks[slots[i]] = _t(xys[i]), _t(ms[i])
        if kinds[i] == 4:
            st.xy[slots2[i]], st.marks[slots2[i]] = _t(xys2[i]), _t(ms2[i])
        st.alive[slots2[i]] = bool(kinds[i] == 4)
        ca = trj.update_cache(st, tmaps, spec_t, tca, int(slots[i]))
        ca = trj.update_cache(st, tmaps, spec_t, ca, int(slots2[i]))
        np.testing.assert_allclose(
            got[i], float(_energy(st, tmaps, spec_t, tc, ca) - u0),
            rtol=RTOL, atol=ATOL, err_msg=f"two-slot proposal {i}")


def test_apply_batch_second_slot_matches_jax_and_rebuild():
    """An accepted split (its second child born in a free slot) and merge
    (its partner dies) beside single-slot proposals: the batched apply
    against JAX's, and its cache against a rebuild on the final state."""
    jmaps, tmaps, _, _, _, _ = _setup()
    xy, marks = _crowded_state()
    js, ts = j_state(xy, marks, 12), t_state(xy, marks, 12)
    spec_j, spec_t = jen.LEGACY_SPEC, ten.LEGACY_SPEC
    jca, tca = jrj.build_cache(js, jmaps, spec_j), _cache(ts, tmaps, spec_t)
    kinds, slots, xys, ms, slots2, xys2, ms2 = _two_slot_batch()
    accept = np.array([True, True, True, False, True])
    tpos, tmark = tps._unary_at(*_one_lane(tmaps), spec_t, *_lanes(xys, ms))
    tpos2, tmark2 = tps._unary_at(*_one_lane(tmaps), spec_t,
                                  *_lanes(xys2, ms2))
    unary_j = [jax.vmap(lambda a, b: jps._unary_at(jmaps, spec_j, a, b))(
        jnp.asarray(x), jnp.asarray(m)) for x, m in ((xys, ms), (xys2, ms2))]
    js2, jca2 = jps._apply_batch(
        js, jca, spec_j, jnp.asarray(kinds.astype(np.int32)),
        jnp.asarray(slots.astype(np.int32)), jnp.asarray(xys),
        jnp.asarray(ms), *unary_j[0], jnp.asarray(accept),
        slots2=jnp.asarray(slots2.astype(np.int32)), xys2=jnp.asarray(xys2),
        markss2=jnp.asarray(ms2), pos_us2=unary_j[1][0],
        mark_us2=unary_j[1][1])
    ts2, tca2 = (lane(x, 0) for x in tps._apply_batch(
        *_one_lane(ts, tca), spec_t, *_lanes(kinds, slots, xys, ms), tpos,
        tmark, _t(accept)[None], *_lanes(slots2, xys2, ms2), tpos2, tmark2))
    for f in ("xy", "marks", "alive"):
        np.testing.assert_allclose(getattr(ts2, f).numpy(),
                                   np.asarray(getattr(js2, f)), err_msg=f)
    assert bool(ts2.alive[10]) and not bool(ts2.alive[4])  # born, merged
    for f in ("dist", "overlap", "align", "pos_e", "mark_e", "polys",
              "areas"):
        np.testing.assert_allclose(getattr(tca2, f).numpy(),
                                   np.asarray(getattr(jca2, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    fresh = _cache(ts2, tmaps, spec_t)
    pair = (ts2.alive[:, None] & ts2.alive[None, :]).numpy()
    for f in ("dist", "overlap", "align"):
        np.testing.assert_allclose(getattr(tca2, f).numpy()[pair],
                                   getattr(fresh, f).numpy()[pair],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    alive = ts2.alive.numpy()
    for f in ("pos_e", "mark_e"):
        np.testing.assert_allclose(getattr(tca2, f).numpy()[alive],
                                   getattr(fresh, f).numpy()[alive],
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def _chain_pair(seed, n_super, alpha, **moves):
    """The blob scene annealed from an empty state by both packages."""
    jmaps, tmaps, tkd, jc, tc, det = _setup()
    jkd = j_setup()[1]
    jfinal, jstats = jps.run_parallel_chain(
        jax.random.PRNGKey(seed), j_empty(32), jmaps, jen.LEGACY_SPEC, jc,
        jkd, n_supersteps=n_super, alpha_t=alpha, **moves)
    maps, kd = expand_lanes(tmaps, 1), expand_lanes(tkd, 1)
    by_kind = torch.zeros((1, tps.N_KINDS), dtype=torch.long)
    step = tps.make_parallel_step(maps, ten.LEGACY_SPEC, tc, kd, alpha, 0.0,
                                  H // (2 * tps.CELL) + 1, **moves)
    state = expand_lanes(empty_state(32), 1)
    cache = trj.build_cache(state, maps, ten.LEGACY_SPEC)
    (state, _, energy, _), _, _ = tps.run_steps(
        step, state, cache, torch.zeros(1), 1.0, n_super,
        [torch.Generator().manual_seed(seed)], by_kind)
    return (jfinal, float(jstats.final_energy), lane(state, 0),
            float(energy[0]), by_kind[0], tmaps, tc, det)


@pytest.mark.parametrize("moves,n_super,alpha", [
    (dict(split_merge=True), 800, 0.994),
    (dict(move_switch=True), 1500, 0.9968)])
def test_equilibrium_matches_jax(moves, n_super, alpha):
    """The split/merge superstep and the switched one, each annealed from
    an empty state in both packages (as tests/test_parallel_sampler.py
    runs JAX's): the port's final energy is at least half as low as
    JAX's, its carried energy equals a recompute, it finds as many
    distinct objects (within 2), its points sit on the planted blobs, and
    (split/merge) splits and merges were accepted."""
    jfinal, e_j, final, e_t, by_kind, tmaps, tc, det = _chain_pair(
        3, n_super, alpha, **moves)
    assert e_j < 0 and e_t <= 0.5 * e_j, (e_t, e_j)
    np.testing.assert_allclose(
        e_t, float(ten.total_energy(final, tmaps, ten.LEGACY_SPEC, tc)),
        rtol=1e-3, atol=1e-3)
    # distinct objects (points more than 3 px apart): stacking points on
    # a blob lowers this energy, so raw counts measure the kernels'
    # efficiency at finding that, not the posterior's objects
    def n_distinct(st):
        kept = []
        for p in state_to_arrays(st)[0]:
            if all(np.hypot(*(p - q)) > 3 for q in kept):
                kept.append(p)
        return len(kept)

    nd_t = n_distinct(final)
    nd_j = n_distinct(type(final)(**{f: _t(getattr(jfinal, f)) for f in (
        "xy", "marks", "alive")}))
    assert abs(nd_t - nd_j) <= 2 and nd_t >= 4, (nd_t, nd_j)
    n = int(final.n_points)
    xy, _ = state_to_arrays(final)
    on_blob = sum(det[int(p[0]), int(p[1])] > 0.3 for p in xy)
    assert n >= 3 and on_blob >= n - 1, f"{on_blob}/{n} on detections"
    if moves.get("split_merge"):
        assert int(by_kind[4]) > 0 and int(by_kind[5]) > 0, by_kind
    else:
        assert int(by_kind[4]) == int(by_kind[5]) == 0
    assert int(by_kind[1:].sum()) > 0
