"""The port's laned 10-kernel proposal mixture against the JAX package.

The two packages draw different random numbers (threefry against Philox),
so the deterministic core is held: for a proposal the JAX package drew,
the variates behind it are recomputed from JAX's key with JAX's own
splits, and the port builds from them the same proposal -- kind, slots,
positions, marks -- with the same forward and backward log-densities. The
port's ``apply_proposal`` gives the JAX state for the JAX proposal, exactly.
Then the laws: kernel frequencies against ``p_kernels`` and data-birth
pixels against the normalised detection map, over many lanes of one
call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.mpp import kernels as tk
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState as TState,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_tpu.mpp import kernels as jk
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401

H, W, C, K = 40, 36, 8, 16
# float32 positions, marks and log-densities through the same formulas in
# another evaluation order
ATOL = 1e-5
KEYS = 5
# chi-square critical values at p = 1e-3 (9 and 29 degrees of freedom)
CHI2_9, CHI2_29 = 27.88, 58.30


def _maps(seed=0):
    rng = np.random.default_rng(seed)
    det = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32) ** 3
    dists = [rng.uniform(0.01, 1.0, (H, W, C)).astype(np.float32)
             for _ in range(3)]
    return det, dists


def _states():
    """(name, centers, marks): a few scattered points (two pairs within
    the merge radius, one point near the border), a full state and an
    empty one."""
    rng = np.random.default_rng(3)
    c = np.array([[5, 6], [9, 12], [20, 18], [33, 30], [31, 27], [0.5, 34],
                  [15.5, 3.2]], np.float32)
    m = np.stack([rng.uniform(2, 14, len(c)), rng.uniform(0.2, 0.9, len(c)),
                  rng.uniform(0, np.pi, len(c))], -1).astype(np.float32)
    cf = rng.uniform(0, [H - 1, W - 1], (K, 2)).astype(np.float32)
    mf = np.stack([rng.uniform(2, 14, K), rng.uniform(0.2, 0.9, K),
                   rng.uniform(0, np.pi, K)], -1).astype(np.float32)
    return [("scattered", c, m), ("full", cf, mf),
            ("empty", np.zeros((0, 2), np.float32),
             np.zeros((0, 3), np.float32))]


@pytest.fixture(scope="module")
def data():
    det, dists = _maps()
    jkd = jk.make_kernel_data(det, dists, j_mappings(C, 0, 16), 9.0,
                              use_split_merge=True)
    tkd = tk.make_kernel_data(det, dists, t_mappings(C, 0, 16), 9.0,
                              use_split_merge=True)
    # the kernel data of one image, the state of one lane: (1, ...) views
    tkd = type(tkd)(**{f: getattr(tkd, f)[None]
                       for f in tkd.__dataclass_fields__})
    sample = jax.jit(jk.sample_proposal)
    return jkd, tkd, sample


def _t_state(js):
    return TState(xy=torch.from_numpy(np.array(js.xy))[None, None],
                  marks=torch.from_numpy(np.array(js.marks))[None, None],
                  alive=torch.from_numpy(np.array(js.alive))[None, None])


def _jax_variates(key, k, js, jkd):
    """The variates of kernel k's branch for ``key``, drawn with the JAX
    package's splits (``mpp_cnn_rs_object_detection_tpu/mpp/kernels.py``)."""
    v = dict(kernel=k, slot=-1, nb_slot=-1, pixel_u=[0, 0],
             marks_u=[1.0] * 3, pixel_d=[0, 0], cls_d=[0] * 3,
             jitter=[0.0] * 5, z_trl=[0.0] * 2, cell=0, sub_trl=[0.0] * 2,
             pid=0, z_trf=0.0, cls_trf=0, sub_trf=0.0, u_rad=0.0, u_ang=0.0,
             z_shape=[0.0] * 3)
    r = jax.random

    def slot_of(kk):
        s = int(jk._random_alive_slot(kk, js.alive))
        v["slot"] = s
        return max(s, 0)

    if k in (jk.K_UNIF_BIRTH, jk.K_DATA_BIRTH):
        k_pos, k_marks, k_sub = r.split(key, 3)
        v["jitter"] = r.uniform(k_sub, (5,))
        keys = r.split(k_marks, 3)
        if k == jk.K_UNIF_BIRTH:
            k_px, k_py = r.split(k_pos)
            v["pixel_u"] = [int(r.randint(k_px, (), 0, H)),
                            int(r.randint(k_py, (), 0, W))]
            v["marks_u"] = [r.uniform(keys[m], minval=jkd.map_vmin[m],
                                      maxval=jkd.map_vmax[m])
                            for m in range(3)]
        else:
            u = r.uniform(k_pos)
            idx = int(jnp.clip(jnp.searchsorted(jkd.birth_cdf, u,
                                                side="left"), 0, H * W - 1))
            xi, yi = idx // W, idx % W
            v["pixel_d"] = [xi, yi]
            rows = jkd.mark_dists[:, xi, yi, :]
            v["cls_d"] = [int(r.categorical(keys[m], jk._log(rows[m])))
                          for m in range(3)]
    elif k in (jk.K_UNIF_DEATH, jk.K_DATA_DEATH):
        slot_of(key)
    elif k == jk.K_GAUSS_TRL:
        k_slot, k_delta = r.split(key)
        slot_of(k_slot)
        v["z_trl"] = r.normal(k_delta, (2,))
    elif k == jk.K_DATA_TRL:
        k_slot, k_cell, k_sub = r.split(key, 3)
        s = slot_of(k_slot)
        xi, yi = jk._pixel_of(js, jkd, s)
        logw = jk._window_logprobs(jkd, xi, yi)
        v["cell"] = int(r.categorical(k_cell, logw.ravel()))
        v["sub_trl"] = r.uniform(k_sub, (2,))
    elif k == jk.K_GAUSS_TRF:
        k_slot, k_param, k_delta = r.split(key, 3)
        slot_of(k_slot)
        v["pid"] = int(r.randint(k_param, (), 0, 3))
        v["z_trf"] = r.normal(k_delta)
    elif k == jk.K_DATA_TRF:
        k_slot, k_param, k_cls, k_sub = r.split(key, 4)
        s = slot_of(k_slot)
        pid = int(r.randint(k_param, (), 0, 3))
        xi, yi = jk._pixel_of(js, jkd, s)
        v["pid"] = pid
        v["cls_trf"] = int(r.categorical(
            k_cls, jk._log(jkd.mark_dists[pid, xi, yi, :])))
        v["sub_trf"] = r.uniform(k_sub)
    elif k == jk.K_SPLIT:
        k_slot, k_rad, k_ang, k_shape = r.split(key, 4)
        slot_of(k_slot)
        v["u_rad"] = r.uniform(k_rad)
        v["u_ang"] = r.uniform(k_ang)
        v["z_shape"] = r.normal(k_shape, (3,))
    else:
        k_slot, k_nb = r.split(key)
        s = slot_of(k_slot)
        d = jnp.linalg.norm(js.xy - js.xy[s][None, :], axis=-1)
        nb = (js.alive & (d <= jk.MERGE_RADIUS)).at[s].set(False)
        if bool(nb.any()):
            v["nb_slot"] = int(r.categorical(
                k_nb, jnp.where(nb, 0.0, -jnp.inf)))
    out = {}
    for name, x in v.items():
        a = np.array(x)
        dtype = torch.float32 if a.dtype.kind == "f" else torch.long
        out[name] = torch.as_tensor(a, dtype=dtype)[None, None]
    return tk.Variates(**out)


def _t_prop(jp):
    """A JAX proposal as the port's, on one lane."""
    return tk.Proposal(**{
        f: torch.as_tensor(np.array(getattr(jp, f)),
                           dtype=torch.long if f in ("kind", "slot", "slot2")
                           else torch.float32)[None, None]
        for f in tk.Proposal.__dataclass_fields__})


@pytest.mark.parametrize("k", range(10))
def test_proposal_matches_jax(data, k):
    """Kernel k: the proposal JAX drew, rebuilt from its variates by the
    port, and the port's apply of JAX's proposal against JAX's apply."""
    jkd, tkd, sample = data
    seen = set()
    for name, c, m in _states():
        js = j_state(c, m, capacity=K)
        ts = _t_state(js)
        for i in range(KEYS):
            key = jax.random.PRNGKey(100 * k + i)
            jp = sample(key, k, js, jkd)
            tp = tk.build_proposal(_jax_variates(key, k, js, jkd), ts, tkd)
            seen.add(int(jp.kind))
            for f in ("kind", "slot", "slot2"):
                assert int(getattr(tp, f)) == int(getattr(jp, f)), (
                    name, i, f)
            for f in ("xy", "marks", "xy2", "marks2", "log_fwd",
                      "log_back"):
                np.testing.assert_allclose(
                    getattr(tp, f)[0, 0].numpy(), np.asarray(getattr(jp, f)),
                    atol=ATOL, rtol=0, err_msg=f"{name} key {i} {f}")
            ja = jk.apply_proposal(js, jp)
            ta = tk.apply_proposal(ts, _t_prop(jp))
            for f in ("xy", "marks", "alive"):
                np.testing.assert_array_equal(getattr(ta, f)[0, 0].numpy(),
                                              np.asarray(getattr(ja, f)))
    # every kernel is seen both proposing and as a no-op (full or empty)
    assert len(seen) == 2 and jk.NOOP in seen, seen


def _many_lanes(n, c, m):
    js = j_state(c, m, capacity=K)
    return TState(
        xy=torch.from_numpy(np.array(js.xy))[None, None].expand(1, n, K, 2),
        marks=torch.from_numpy(np.array(js.marks))[None, None].expand(
            1, n, K, 3),
        alive=torch.from_numpy(np.array(js.alive))[None, None].expand(1, n,
                                                                      K))


def test_kernel_frequencies_follow_p_kernels(data):
    """20,000 lanes of one draw: the kernel counts against p_kernels
    (chi-square, 9 degrees of freedom, p = 1e-3)."""
    _, tkd, _ = data
    n = 20_000
    _, c, m = _states()[0]
    v = tk.draw_variates(torch.Generator().manual_seed(0),
                         _many_lanes(n, c, m), tkd)
    counts = torch.bincount(v.kernel.reshape(-1), minlength=10).double()
    expected = tkd.p_kernels[0].double() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_9, (counts.tolist(), expected.tolist(), chi2)


def test_data_births_follow_the_birth_map(data):
    """Data-birth pixels of 20,000 lanes, binned in 6 x 5 blocks of the
    map, against the normalised detection map's block masses
    (chi-square, 29 degrees of freedom, p = 1e-3)."""
    _, tkd, _ = data
    n = 20_000
    v = tk.draw_variates(torch.Generator().manual_seed(1),
                         _many_lanes(n, *_states()[2][1:]), tkd)
    px = v.pixel_d.reshape(-1, 2)
    bx, by = H // 6 + 1, W // 5 + 1
    blocks = (px[:, 0] // bx) * 5 + px[:, 1] // by
    counts = torch.bincount(blocks, minlength=30).double()
    prob = torch.exp(tkd.log_birth_density[0]).double()
    mass = torch.zeros(30, dtype=torch.float64)
    ii, jj = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    mass.index_add_(0, ((ii // bx) * 5 + jj // by).reshape(-1),
                    prob.reshape(-1))
    expected = mass / mass.sum() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_29, chi2


def test_laned_moves_keep_lanes_apart(data):
    """Two images of 3 samples each, several moves: every lane stays a
    valid configuration of its own image (points inside its map, marks in
    range), and a lane's result depends only on its own variates."""
    jkd, tkd, _ = data
    det2, dists2 = _maps(seed=5)
    kd2 = tk.make_kernel_data(det2, dists2, t_mappings(C, 0, 16), 4.0)
    kd1 = tk.make_kernel_data(*_maps(), t_mappings(C, 0, 16), 9.0)
    kd = type(kd1)(**{f: torch.stack([getattr(kd1, f), getattr(kd2, f)])
                      for f in kd1.__dataclass_fields__})
    _, c, m = _states()[0]
    st = _many_lanes(3, c, m)
    st = TState(xy=st.xy.expand(2, 3, K, 2).clone(),
                marks=st.marks.expand(2, 3, K, 3).clone(),
                alive=st.alive.expand(2, 3, K).clone())
    gen = torch.Generator().manual_seed(2)
    for _ in range(30):
        v = tk.draw_variates(gen, st, kd)
        prop = tk.build_proposal(v, st, kd)
        # lane (1, 2) alone, from the same variates
        one = tk.build_proposal(
            tk.Variates(**{f: getattr(v, f)[1:2, 2:3]
                           for f in tk.Variates.__dataclass_fields__}),
            TState(xy=st.xy[1:2, 2:3], marks=st.marks[1:2, 2:3],
                   alive=st.alive[1:2, 2:3]),
            type(kd)(**{f: getattr(kd, f)[1:2]
                        for f in kd.__dataclass_fields__}))
        for f in tk.Proposal.__dataclass_fields__:
            assert torch.equal(getattr(one, f)[0, 0],
                               getattr(prop, f)[1, 2]), f
        st = tk.apply_proposal(st, prop)
    assert st.alive.sum() > 0
    xy = st.xy[st.alive]
    assert bool((xy >= 0).all()) and bool((xy[:, 0] < H + 1).all())
    marks = st.marks[st.alive]
    assert bool((marks[:, 0] >= 0).all() and (marks[:, 0] <= 16).all())
