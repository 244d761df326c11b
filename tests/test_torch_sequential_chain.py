"""The port's sequential RJMCMC chain (``mpp/rjmcmc.py``,
``mpp/stopping.py``) against the JAX package.

The packages draw different random numbers (threefry against Philox), so
the deterministic parts are held exactly: the laned cache update with
tensor slots, and one step's core -- for the key JAX's step used, the
kernel, the variates (rebuilt from JAX's own key splits, as
``tests/test_torch_proposals.py`` does) and the accept uniform are taken
from JAX, and the port gives JAX's new state, cache, energy and accept.
The sample schedule is held by its counts and buffer layout, the chains
by their statistics over seeds, the segmented runner by its summaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import kernels as tk
from mpp_cnn_rs_object_detection_torch.mpp import rjmcmc as trj
from mpp_cnn_rs_object_detection_torch.mpp import stopping as tst
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    empty_state as t_empty,
    expand_lanes,
    lane,
    stack_lanes,
    state_from_arrays as t_state,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import energies as jen
from mpp_cnn_rs_object_detection_tpu.mpp import kernels as jk
from mpp_cnn_rs_object_detection_tpu.mpp import rjmcmc as jrj
from mpp_cnn_rs_object_detection_tpu.mpp import stopping as jst
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    empty_state as j_empty,
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401
from tests.test_torch_proposals import C, K, _jax_variates, _maps
from tests.test_torch_proposals import _states as _proposal_states

# float32 positions, marks, unary terms and energies through the same
# formulas in another evaluation order
ATOL = RTOL = 1e-5
# the overlap ratios come from float32 quad clipping whose ~20 operations
# per pair run in another order (tests/test_torch_mpp_core.py's tolerance)
PAIR_TOL = 1e-4
WEIGHTS = {"PositionEnergy": 1.0, "ShapeEnergy": 0.25,
           "RectangleOverlapEnergy": 0.75, "ShapeAlignmentEnergy": 0.1,
           "AreaPriorEnergy": 0.25}
SPEC_J, SPEC_T = jen.LEGACY_SPEC, ten.LEGACY_SPEC


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(det, dists, split_merge=False, intensity=9.0):
    """Energy maps, kernel data and combiners of one image, in both."""
    jm, tm = j_mappings(C, 0, 16), t_mappings(C, 0, 16)
    jmaps = jen.make_energy_maps(det, [-d for d in dists], 0.5, 4.0, 200.0,
                                 jm)
    tmaps = ten.make_energy_maps(det, [-_t(d) for d in dists], 0.5, 4.0,
                                 200.0, tm)
    jkd = jk.make_kernel_data(det, dists, jm, intensity,
                              use_split_merge=split_merge)
    tkd = tk.make_kernel_data(det, dists, tm, intensity,
                              use_split_merge=split_merge)
    return (jmaps, tmaps, jkd, tkd,
            jcomb.manual_hierarchical(SPEC_J.names, WEIGHTS),
            tcomb.manual_hierarchical(SPEC_T.names, WEIGHTS))


@pytest.fixture(scope="module")
def image():
    return _maps()


def _close(got, want, err_msg="", tol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=err_msg)


def _tol(field):
    return PAIR_TOL if field == "overlap" else ATOL


def test_update_cache_lanes_match_jax(image):
    """Two lanes, each changing its own slot (a move, a birth into a dead
    slot), refreshed by one laned call with a (B,) slot tensor; a second
    call at the same slots, or one call given each slot twice (a step's
    second slot when the move has none), changes nothing."""
    jmaps, tmaps = _pair(*image)[:2]
    states = _proposal_states()[:2]  # scattered, full
    rng = np.random.default_rng(4)
    changed, slots = [], [10, 3]  # a birth (scattered), a move (full)
    for (_, c, m), slot in zip(states, slots):
        c2 = np.concatenate([c, rng.uniform(1, 30, (K - len(c), 2))]
                            ).astype(np.float32)[:K]
        m2 = np.concatenate([m, np.tile([[6.0, 0.5, 1.0]], (K - len(m), 1))]
                            ).astype(np.float32)[:K]
        alive = np.arange(K) < max(len(c), 1)
        before = (c2.copy(), m2.copy(), alive.copy())
        c2[slot] += 1.5
        m2[slot] = [7.0, 0.6, 2.0]
        alive[slot] = True
        changed.append((before, (c2, m2, alive)))

    def both(arrays):
        c, m, a = arrays
        js = j_state(c, m, capacity=K).replace(alive=jnp.asarray(a))
        ts = t_state(c, m, capacity=K)
        ts.alive = _t(a)
        return js, ts

    tmaps2 = expand_lanes(tmaps, 2)
    t_old = stack_lanes(lambda b: both(changed[b][0])[1], 2)
    t_new = stack_lanes(lambda b: both(changed[b][1])[1], 2)
    cache = trj.build_cache(t_old, tmaps2, SPEC_T)
    at = torch.tensor(slots)
    got = trj.update_cache(t_new, tmaps2, SPEC_T, cache, at)
    for b, (before, after) in enumerate(changed):
        jca = jrj.build_cache(both(before)[0], jmaps, SPEC_J)
        want = jrj.update_cache(both(after)[0], jmaps, SPEC_J, jca, slots[b])
        for f in ("dist", "overlap", "align", "pos_e", "mark_e", "polys",
                  "areas"):
            _close(getattr(got, f)[b], getattr(want, f), f"lane {b} {f}",
                   _tol(f))
    again = trj.update_cache(t_new, tmaps2, SPEC_T, got, at)
    twice = trj.update_cache(t_new, tmaps2, SPEC_T, cache,
                             torch.stack([at, at], dim=1))
    for f in got.__dataclass_fields__:
        assert torch.equal(getattr(again, f), getattr(got, f)), f
        assert torch.equal(getattr(twice, f), getattr(got, f)), f


@pytest.mark.parametrize("split_merge", [False, True])
def test_step_core_matches_jax(image, split_merge):
    """For each of 16 keys of JAX's step: its kernel, variates and accept
    uniform through the port's ``step_from_variates`` give JAX's new
    state, cache, energy and accept (8 kernels, or 10 with split/merge)."""
    jmaps, tmaps, jkd, tkd, jc, tc = _pair(*image, split_merge=split_merge)
    temp = 0.3
    step = jax.jit(jrj.make_step_fn(jmaps, SPEC_J, jc, jkd, 0.999, 0.0))
    tkd1, tmaps1 = expand_lanes(tkd, 1), expand_lanes(tmaps, 1)
    seen = set()
    for name, c, m in _proposal_states():
        js = j_state(c, m, capacity=K)
        jca = jrj.build_cache(js, jmaps, SPEC_J)
        ju = jrj.energy_from_cache(js, jmaps, SPEC_J, jc, jca)
        ts = expand_lanes(t_state(c, m, capacity=K), 1)
        tca = trj.build_cache(ts, tmaps1, SPEC_T)
        tu = trj.energy_from_cache(ts, tmaps1, SPEC_T, tc, tca)
        _close(tu[0], ju, f"{name} U0")
        for i in range(16):
            key = jax.random.PRNGKey(1000 * split_merge + 31 * i + len(c))
            (js2, jca2, ju2, _), (acc, kidx) = step(
                (js, jca, ju, jnp.float32(temp)), key)
            _, k_prop, k_acc = jax.random.split(key, 3)
            v = _jax_variates(k_prop, int(kidx), js, jkd)
            u = torch.tensor([float(jax.random.uniform(k_acc))])
            (ts2, tca2, tu2), tacc = trj.step_from_variates(
                (ts, tca, tu, temp), v, u, tmaps1, SPEC_T, tc, tkd1)
            where = f"{name} key {i} kernel {int(kidx)}"
            assert bool(tacc[0]) == bool(acc), where
            seen.add((bool(acc), int(kidx)))
            np.testing.assert_array_equal(ts2.alive[0].numpy(),
                                          np.asarray(js2.alive), where)
            for f in ("xy", "marks"):
                _close(getattr(ts2, f)[0], getattr(js2, f), f"{where} {f}")
            for f in ("dist", "overlap", "align", "pos_e", "mark_e",
                      "areas"):
                _close(getattr(tca2, f)[0], getattr(jca2, f),
                       f"{where} {f}", _tol(f))
            _close(tu2[0], ju2, f"{where} U")
            if not bool(acc):  # a rejected lane keeps its carry bit for bit
                assert torch.equal(ts2.xy, ts.xy) and torch.equal(
                    tca2.overlap, tca.overlap) and torch.equal(tu2, tu)
    assert {a for a, _ in seen} == {True, False}, seen


@pytest.mark.parametrize("n_steps,burn_in,interval,offset", [
    (40, 10, 8, 0), (40, 10, 8, 24), (40, 100, 8, 0), (30, 0, 1, 5)])
def test_sample_schedule_matches_jax(image, n_steps, burn_in, interval,
                                     offset):
    """The count of sampling steps and the buffer's layout (valid samples
    at the end, oldest first) equal JAX's ``run_chain``; the port's buffer
    holds exactly the states of its sampling steps, and two segments with
    ``step_offset`` collect what one does."""
    jmaps, tmaps, jkd, tkd, jc, tc = _pair(*image)
    n_samp = 3
    _, c, m = _proposal_states()[0]
    js = j_state(c, m, capacity=K)
    _, _, jbuf, jn = jrj.run_chain(
        jax.random.PRNGKey(0), js, jmaps, SPEC_J, jc, jkd, n_steps=n_steps,
        t0=0.5, n_samples=n_samp, samples_interval=interval,
        burn_in=burn_in, step_offset=offset)
    ts = expand_lanes(t_state(c, m, capacity=K), 2)
    lmaps, lkd = expand_lanes(tmaps, 2), expand_lanes(tkd, 2)

    def run(n, off, st, seed=0):
        return trj.run_chain(torch.Generator().manual_seed(seed), st, lmaps,
                             SPEC_T, tc, lkd, n_steps=n, t0=0.5,
                             n_samples=n_samp, samples_interval=interval,
                             burn_in=burn_in, step_offset=off)

    final, _, tbuf, tn = run(n_steps, offset, ts)
    assert tn == int(jn)
    filled = lambda marks: np.abs(np.asarray(marks)).sum((-1, -2)) > 0  # noqa
    np.testing.assert_array_equal(filled(tbuf.marks[0]), filled(jbuf.marks))
    # the buffer against the states of the sampling steps, one by one
    step = trj.make_step_fn(lmaps, SPEC_T, tc, lkd, 0.999, 0.0)
    gen = torch.Generator().manual_seed(0)
    cache0 = trj.build_cache(ts, lmaps, SPEC_T)
    carry = (ts, cache0, trj.energy_from_cache(ts, lmaps, SPEC_T, tc,
                                               cache0), 0.5)
    taken = []
    for i in range(n_steps):
        carry, _ = step(carry, gen)
        g = offset + i
        if g >= burn_in and g % interval == 0:
            taken.append(carry[0])
    assert len(taken) == tn
    for j, st in enumerate(taken[-n_samp:]):
        pos = n_samp - min(tn, n_samp) + j
        for f in ("xy", "marks", "alive"):
            assert torch.equal(getattr(tbuf, f)[:, pos], getattr(st, f)), f
    assert torch.equal(final.xy, carry[0].xy)
    # two segments keep one global schedule
    half = n_steps // 2
    first = run(half, offset, ts)
    second = run(n_steps - half, offset + half, first[0], seed=1)
    assert first[3] + second[3] == tn


def _blobs(centers, h=64, w=64):
    gy, gx = np.mgrid[:h, :w]
    det = np.zeros((h, w))
    for cy, cx in centers:
        det += np.exp(-((gy - cy) ** 2 + (gx - cx) ** 2) / (2 * 2.0 ** 2))
    det = np.clip(det, 0, 1).astype(np.float32)
    dist = np.full((h, w, C), 1.0 / C, np.float32)
    dist[..., 3] = 3.0 / C
    dist /= dist.sum(-1, keepdims=True)
    return det, [dist] * 3


# chains of 6 seeds per package; each mean must lie within 3 of JAX's
# standard deviations of the other's (a floor of 1 point and 0.5 energy for
# chains that all agree)
N_CHAINS, N_STEPS = 6, 500
BAND_SIGMAS, FLOOR_POINTS, FLOOR_ENERGY = 3.0, 1.0, 0.5


@pytest.mark.parametrize("split_merge", [False, True])
def test_chain_statistics_match_jax(split_merge):
    """Annealed chains from an empty state on three blobs: the final point
    counts and energies of 6 chains per package agree within JAX's own
    spread, every chain finds the blobs, and the port's per-kernel counts
    add up to its steps (8 kernels, or 10 with split/merge)."""
    det, dists = _blobs([(16, 16), (20, 44), (46, 30)])
    jmaps, tmaps, jkd, tkd, jc, tc = _pair(det, dists, split_merge,
                                           intensity=3.0)
    jinit = jax.tree_util.tree_map(lambda x: jnp.stack([x] * N_CHAINS),
                                   j_empty(K))
    _, jstats = jrj.run_chains_batch(jax.random.PRNGKey(0), jinit, jmaps,
                                     SPEC_J, jc, jkd, n_steps=N_STEPS,
                                     alpha_t=0.99)
    tinit = expand_lanes(t_empty(K), N_CHAINS)
    tfinal, tstats = trj.run_chains_batch(
        torch.Generator().manual_seed(0), tinit, tmaps, SPEC_T, tc, tkd,
        n_steps=N_STEPS, alpha_t=0.99)
    n_k = 10 if split_merge else 8
    assert tstats.proposed.shape == (N_CHAINS, n_k)
    assert (tstats.proposed.sum(dim=1) == N_STEPS).all()
    assert (tstats.accepted <= tstats.proposed).all()
    for name, j, t, floor in (
            ("points", jstats.final_n_points, tstats.final_n_points,
             FLOOR_POINTS),
            ("energy", jstats.final_energy, tstats.final_energy,
             FLOOR_ENERGY)):
        j = np.asarray(j, np.float64)
        t = t.numpy().astype(np.float64)
        band = max(BAND_SIGMAS * j.std(), floor)
        assert abs(t.mean() - j.mean()) <= band, (name, t, j, band)
    assert (tstats.final_n_points >= 2).all()
    for b in range(N_CHAINS):
        u = ten.total_energy(lane(tfinal, b), tmaps, SPEC_T, tc)
        _close(tstats.final_energy[b], u, f"chain {b}")


def test_segmented_runner_summaries_match_jax(image):
    """``run_chain_segmented`` stops on ``max_iter`` after 3 segments of
    25 steps, threading the temperature as JAX's does; ``ChainTimer``
    reports every segment."""
    jmaps, tmaps, jkd, tkd, jc, tc = _pair(*image)
    _, c, m = _proposal_states()[0]
    kw = dict(segment=25, max_segments=10, t0=1.0, alpha_t=0.98)
    _, jsum = jst.run_chain_segmented(
        jax.random.PRNGKey(0), j_state(c, m, capacity=K), jmaps, SPEC_J, jc,
        jkd, jst.StopOnMaxIter(max_iter=75), **kw)
    state, tsum = tst.run_chain_segmented(
        torch.Generator().manual_seed(0),
        expand_lanes(t_state(c, m, capacity=K), 1), expand_lanes(tmaps, 1),
        SPEC_T, tc, expand_lanes(tkd, 1), tst.StopOnMaxIter(max_iter=75),
        **kw)
    assert [s.iter for s in tsum] == [s.iter for s in jsum] == [25, 50, 75]
    np.testing.assert_allclose([s.temperature for s in tsum],
                               [s.temperature for s in jsum], rtol=1e-5)
    for s in tsum:
        assert np.isfinite(s.energy) and 0.0 <= s.accept_rate <= 1.0
        assert s.n_points >= 0 and s.seconds >= 0.0
    _close(tsum[-1].energy,
           ten.total_energy(lane(state, 0), tmaps, SPEC_T, tc))
    timer = tst.ChainTimer()
    timer.extend(tsum)
    lines = timer.show_results().splitlines()
    assert len(lines) == 4 and lines[0].startswith("chain: 75 moves")
