"""The port's meshes against the JAX package's, on the CPU: the halo
exchange (JAX's under ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``, the port's on ``[cpu] * 8``), the banded U-Net
forward (the same weights in both packages, and the port's own
whole-scene forward), and the banded exact chain against the port's
one-band chain -- equal draw for draw, with the centers of
``tests/test_sharded_scene.py`` straddling the 2- and 4-way band borders,
for the default moves, the split/merge pair and the move switch -- its
carried energy against a fresh one, two segments threading the cache, and
the banded chain's hard errors. A mesh of the port may repeat a device:
every band of these runs lies on the one CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpp_cnn_rs_object_detection_torch.models import unet as tunet
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_from_jax,
)
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energies as ten
from mpp_cnn_rs_object_detection_torch.mpp import kernels as tker
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    expand_lanes,
    lane,
    state_from_arrays,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import default_mappings
from mpp_cnn_rs_object_detection_torch.parallel.halo import (
    halo_exchange_rows,
    sharded_unet_inference,
    split_rows,
)
from mpp_cnn_rs_object_detection_torch.parallel.mesh import make_mesh
from mpp_cnn_rs_object_detection_torch.parallel.sharded_scene import (
    run_exact_scene_chain,
)
from mpp_cnn_rs_object_detection_tpu.models import unet as junet
from mpp_cnn_rs_object_detection_tpu.parallel import halo as jhalo
from tests._torch_util import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
H, W, C = 256, 192, 8
# tests/test_sharded_scene.py:58-59: pairs across the 2-way (row 128) and
# 4-way (rows 64, 192) band borders
CENTERS = [(30, 30), (126, 100), (131, 103), (63, 160), (66, 158),
           (200, 50), (192, 52), (100, 30)]
WEIGHTS = {"PositionEnergy": 1.0, "ShapeEnergy": 0.25,
           "RectangleOverlapEnergy": 0.75, "ShapeAlignmentEnergy": 0.1,
           "AreaPriorEnergy": 0.25}
N_SUPER, ALPHA = 40, 0.985
MOVES = {"default": {}, "split_merge": {"split_merge": True},
         "move_switch": {"move_switch": True}}


def test_make_mesh():
    """An explicit list (a device may repeat) and its first n; with no GPU
    and no list the default raises rather than fall back to the CPU."""
    assert make_mesh(devices=["cpu"] * 4) == (CPU,) * 4
    assert make_mesh(2, devices=["cpu"] * 4) == (CPU,) * 2
    with pytest.raises(ValueError):
        make_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_halo_exchange_rows_matches_jax():
    """n = 8 bands of 4 rows, halo 2: the port's blocks equal JAX's
    ``ppermute`` exchange under ``shard_map``."""
    n, h_loc, halo = 8, 4, 2
    x = np.arange(n * h_loc * 3, dtype=np.float32).reshape(n * h_loc, 3)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    want = jhalo.shard_map(
        lambda b: jhalo.halo_exchange_rows(b, halo, "data"), mesh=mesh,
        in_specs=(P("data", None),), out_specs=P("data", None),
    )(jnp.asarray(x))
    want = np.asarray(want).reshape(n, h_loc + 2 * halo, 3)
    got = halo_exchange_rows(split_rows(torch.from_numpy(x), [CPU] * n),
                             halo)
    for d in range(n):
        np.testing.assert_array_equal(got[d].numpy(), want[d])
    # along another axis: the same exchange, transposed
    got_t = halo_exchange_rows(
        split_rows(torch.from_numpy(x.T.copy()), [CPU] * n, dim=1), halo,
        dim=1)
    for d in range(n):
        np.testing.assert_array_equal(got_t[d].numpy().T, want[d])
    with pytest.raises(ValueError, match="one-hop"):
        halo_exchange_rows(split_rows(torch.from_numpy(x), [CPU] * n), 5)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_unet_matches_jax(n):
    """A PosNet [8, 16] in both packages with the same weights: the port's
    banded forward on ``[cpu] * n`` equals JAX's ``shard_map`` forward on n
    devices and the port's forward of the scene zero-padded by the halo
    (rtol 2e-4, atol 2e-5, tests/test_parallel.py:72)."""
    h_loc, halo, w = 32, 16, 32
    jnet = junet.PosNet(hidden_dims=[8, 16], out_channels=3)
    var = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                    train=False)
    stats = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).uniform(0.5, 1.5, a.shape)
        .astype(np.float32), var["batch_stats"])
    scene = np.random.default_rng(1).uniform(
        size=(n * h_loc, w, 3)).astype(np.float32)

    def apply_hwc(x):
        return jnet.apply({"params": var["params"], "batch_stats": stats},
                          x[None], train=False)[0]

    want = np.asarray(jhalo.sharded_unet_inference(
        apply_hwc, jnp.asarray(scene),
        Mesh(np.asarray(jax.devices()[:n]), ("data",)), halo=halo))
    tnet = tunet.PosNet([8, 16]).eval()
    tnet.load_state_dict(params_from_jax(
        {"params": jax.device_get(var["params"]), "batch_stats": stats}))
    x = torch.from_numpy(scene).permute(2, 0, 1)[None]
    with torch.no_grad():
        got = sharded_unet_inference(tnet, x, [CPU] * n, halo=halo)
        whole = tnet(torch.nn.functional.pad(x, (0, 0, halo, halo)))
    got_hwc = got[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got_hwc, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), whole[..., halo:-halo, :].numpy(),
                               rtol=2e-4, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _scene():
    gy, gx = np.mgrid[:H, :W]
    det = np.zeros((H, W))
    for c in CENTERS:
        det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / (2 * 2.0 ** 2))
    det = np.clip(det, 0, 1).astype(np.float32)
    dist = np.full((H, W, C), 1.0 / C, np.float32)
    dist[..., 3] = 3.0 / C
    dist /= dist.sum(-1, keepdims=True)
    tm = default_mappings(C, 0, 16)
    t = torch.from_numpy
    maps = ten.make_energy_maps(det, [-t(dist)] * 3, 0.5, 4.0, 200.0, tm)
    kd = tker.make_kernel_data(t(det), [t(dist)] * 3, tm,
                               intensity=len(CENTERS))
    comb = tcomb.manual_hierarchical(ten.LEGACY_SPEC.names, WEIGHTS)
    # every planted object starts alive: pairs interact across the borders
    init = state_from_arrays(np.asarray(CENTERS, np.float32) + 0.25,
                             np.tile([[5.0, 0.5, 0.3]], (len(CENTERS), 1)),
                             capacity=32)
    return maps, kd, comb, init


def _run(mesh, seed=7, n_super=N_SUPER, init=None, cache=None, t0=1.0,
         **moves):
    maps, kd, comb, init0 = _scene()
    init = expand_lanes(init0, 1) if init is None else init
    return run_exact_scene_chain(
        [torch.Generator().manual_seed(seed)], init, expand_lanes(maps, 1),
        ten.LEGACY_SPEC, comb, expand_lanes(kd, 1), n_supersteps=n_super,
        t0=t0, alpha_t=ALPHA, cache=cache,
        mesh=None if mesh is None else [CPU] * mesh, **moves)


@functools.lru_cache(maxsize=None)
def _one_band(moves):
    return _run(None, **MOVES[moves])


def _assert_same_chain(got, want):
    (s1, c1, st1), (s2, c2, st2) = got, want
    assert torch.equal(s1.alive, s2.alive)
    np.testing.assert_allclose(s1.xy.numpy(), s2.xy.numpy(), atol=1e-5)
    np.testing.assert_allclose(s1.marks.numpy(), s2.marks.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(st1.final_energy[0]),
                               float(st2.final_energy[0]), rtol=1e-4,
                               atol=1e-4)
    assert int(st1.accepted.sum()) == int(st2.accepted.sum())
    assert torch.equal(st1.accepted_by_kind, st2.accepted_by_kind)
    for f in ("dist", "overlap", "align", "pos_e", "mark_e"):
        np.testing.assert_allclose(getattr(c1, f).numpy(),
                                   getattr(c2, f).numpy(), atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("moves", sorted(MOVES))
@pytest.mark.parametrize("n", [2, 4])
def test_banded_chain_equals_one_band(n, moves):
    """n row bands on ``[cpu] * n`` against the one-band chain from the
    same generator: the same alive set, coordinates within 1e-5 (the JAX
    test's tolerance; the runs are bit-identical here), the same accepts
    by kind, energy and cache. The run moves, splits or switches types."""
    want = _one_band(moves)
    got = _run(n, **MOVES[moves])
    _assert_same_chain(got, want)
    by_kind = want[2].accepted_by_kind[0]
    assert int(by_kind[1:].sum()) > 0, by_kind
    if moves == "split_merge":
        assert int(by_kind[4] + by_kind[5]) > 0, by_kind


def test_banded_energy_is_exact_across_borders():
    """n = 4: the carried energy equals a fresh ``total_energy`` of the
    final state; a missed cross-band pair term would break it."""
    maps, _, comb, _ = _scene()
    state, _, stats = _run(4)
    fresh = float(ten.total_energy(lane(state, 0), maps, ten.LEGACY_SPEC,
                                   comb))
    np.testing.assert_allclose(float(stats.final_energy[0]), fresh,
                               rtol=1e-3, atol=1e-3)


def test_banded_segments_thread_the_cache():
    """Two banded segments (n = 2), the second from the first's state and
    cache with another generator, equal the same two one-band segments."""
    t1 = ALPHA ** 20
    a = _run(2, seed=0, n_super=20)
    b = _run(2, seed=1, n_super=20, init=a[0], cache=a[1], t0=t1)
    c = _run(None, seed=0, n_super=20)
    d = _run(None, seed=1, n_super=20, init=c[0], cache=c[1], t0=t1)
    _assert_same_chain(b, d)


def test_banded_hard_errors():
    """The JAX package's preconditions, raised as errors: the CNN data
    term only, rows divisible by the bands, bands of at least 2 CELL."""
    with pytest.raises(ValueError, match="CNN data term"):
        maps, kd, comb, init = _scene()
        run_exact_scene_chain(
            [torch.Generator()], expand_lanes(init, 1),
            expand_lanes(maps, 1),
            dataclasses.replace(ten.LEGACY_SPEC, data_term="contrast"),
            comb, expand_lanes(kd, 1), n_supersteps=1, mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        _run(3, n_super=1)
    with pytest.raises(ValueError, match="2\\*CELL"):
        _run(8, n_super=1)
