"""The exact chain runner's segment checkpoint and stopping check in the PyTorch
port: an interrupted batched run leaves a checkpoint, a rerun resumes the
batch where it stood and ends with the uninterrupted run's configuration,
the batch stops jointly on the JAX package's summary, and the stopping
conditions decide as the JAX package's do."""

import logging
import os

import numpy as np
import pytest

from mpp_cnn_rs_object_detection_torch.mpp import mpp_model as tmm
from mpp_cnn_rs_object_detection_torch.mpp import stopping as tstop
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
from mpp_cnn_rs_object_detection_torch.mpp import scene as tscene
from mpp_cnn_rs_object_detection_torch.mpp.scene import (
    run_exact_scenes_batched,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import default_mappings
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import scene as jscene
from mpp_cnn_rs_object_detection_tpu.mpp import stopping as jstop
from mpp_cnn_rs_object_detection_tpu.mpp.energy_setups import (
    make_energy_setup as j_make_energy_setup,
)
from mpp_cnn_rs_object_detection_tpu.mpp.image_data import (
    ImageWMaps as JImageWMaps,
)
from mpp_cnn_rs_object_detection_tpu.mpp.rjmcmc import (
    RJMCMCParams as JParams,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import (
    default_mappings as j_default_mappings,
)
from tests._torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "models_storage", "mpp",
                        "mpp_log_r12ttapar")
# 1200 moves -> 100 supersteps of the 64 px bucket, in 2 segments of 50
PARAMS = RJMCMCParams(n_steps=1200, samples_interval=1, alpha_t=0.99)
SEGMENT = 600


def _scene(seed, image_w_maps=ImageWMaps, mappings_of=default_mappings):
    """Oracle-like maps of 64 x 64: blobs at 6 random centers, one-hot
    marks of a vehicle (size 7, ratio 0.5, any angle); in the port's types,
    or the JAX package's."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(8, 56, (6, 2))
    gy, gx = np.mgrid[:64, :64]
    d2 = ((gy[..., None] - centers[:, 0]) ** 2
          + (gx[..., None] - centers[:, 1]) ** 2)
    det = np.exp(-d2.min(-1) / 4.5).astype(np.float32)
    mappings = mappings_of(n_classes=32)
    angles = rng.uniform(0, np.pi, 6)[d2.argmin(-1)]
    dists = []
    for m, v in zip(mappings, (np.full((64, 64), 7.0),
                               np.full((64, 64), 0.5), angles)):
        dists.append(np.eye(32, dtype=np.float32)[m.value_to_class(v)])
    return image_w_maps(image=np.zeros((64, 64, 3), np.float32), name=str(seed),
                      shape=(64, 64), detection_map=det,
                      param_dist_maps=dists, mappings=mappings, labels={},
                      gt_centers=np.zeros((0, 2), np.float32),
                      gt_marks=np.zeros((0, 3), np.float32))


def _run(**kw):
    config = tmm.load_mpp_config("mpp_log_r12ttapar")
    setup, comb = tmm.load_energy_model(config, FLAGSHIP, "cpu")
    return run_exact_scenes_batched(
        [_scene(0), _scene(1)], setup, comb, PARAMS, seeds=[3, 4],
        segment_size=SEGMENT, device="cpu", **kw)


def test_interrupted_batch_resumes(tmp_path):
    ck = str(tmp_path / "batched_chains.ck.npz")
    whole = _run()
    assert [r.supersteps for r in whole] == [100, 100]
    first = _run(checkpoint_path=ck, max_segments=1)
    assert [r.supersteps for r in first] == [50, 50]
    saved = np.load(ck)
    # one progress for the batch, as the JAX package's checkpoint holds
    assert saved["done"].shape == () and int(saved["done"]) == 50
    assert saved["fingerprint"][0] == tscene.CHECKPOINT_FORMAT == 2.0
    assert saved["xy"].shape[:2] == (2, first[0].capacity)
    resumed = _run(checkpoint_path=ck)
    assert not os.path.exists(ck)
    for a, b in zip(resumed, whole):
        assert a.supersteps == 100
        np.testing.assert_array_equal(a.centers, b.centers)
        np.testing.assert_array_equal(a.marks, b.marks)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5)


def test_checkpoint_of_another_run_is_not_resumed(tmp_path):
    ck = str(tmp_path / "batched_chains.ck.npz")
    _run(checkpoint_path=ck, max_segments=1)
    config = tmm.load_mpp_config("mpp_log_r12ttapar")
    setup, comb = tmm.load_energy_model(config, FLAGSHIP, "cpu")
    # other seeds: another fingerprint, so the chains start over
    out = run_exact_scenes_batched(
        [_scene(0), _scene(1)], setup, comb, PARAMS, seeds=[5, 6],
        segment_size=SEGMENT, device="cpu", checkpoint_path=ck,
        max_segments=1)
    assert [r.supersteps for r in out] == [50, 50]
    assert int(np.load(ck)["done"]) == 50


class _Interrupted(Exception):
    pass


def test_checkpoints_of_the_two_packages_are_not_shared(tmp_path,
                                                        monkeypatch, caplog):
    """Both packages write ``batched_chains.ck.npz`` into the same inference
    directory, in different layouts: each restarts (and says so) on a
    checkpoint the other wrote, for the same scenes, budget and seeds."""
    ck = str(tmp_path / "batched_chains.ck.npz")
    first = _run(checkpoint_path=ck, max_segments=1)
    port_fingerprint = np.load(ck)["fingerprint"]

    # the JAX batched run on the port's file, interrupted once it has
    # checkpointed its first segment
    def interrupt(msg):
        raise _Interrupted(msg)

    monkeypatch.setattr(jscene, "maybe_yield_device", interrupt)
    config = tmm.load_mpp_config("mpp_log_r12ttapar")
    setup_j = j_make_energy_setup(config)
    setup_j.load_calibration(FLAGSHIP)
    comb_j = jcomb.load_combiner(os.path.join(
        FLAGSHIP, "energy_combination_model.json"))
    datas_j = [_scene(s, JImageWMaps, j_default_mappings) for s in (0, 1)]
    with caplog.at_level(logging.INFO), pytest.raises(_Interrupted):
        jscene.run_exact_scenes_batched(
            datas_j, setup_j, comb_j,
            JParams(n_steps=1200, samples_interval=1, alpha_t=0.99),
            seeds=[3, 4], segment_size=SEGMENT, checkpoint_path=ck,
            stopping=jstop.StopOnMaxIter(max_iter=10 ** 6))
    assert "checkpoint mismatch" in caplog.text
    assert "resuming" not in caplog.text
    saved = np.load(ck)
    assert saved["done"].shape == () and int(saved["done"]) == 50
    # the same budget, capacity, bucket, batch and seeds: only the port's
    # format tag tells the two fingerprints apart
    np.testing.assert_allclose(saved["fingerprint"], port_fingerprint[1:])

    # the port on the JAX package's file: a fresh first segment
    caplog.clear()
    with caplog.at_level(logging.INFO):
        again = _run(checkpoint_path=ck, max_segments=1)
    assert "checkpoint mismatch" in caplog.text
    assert "resuming" not in caplog.text
    assert int(np.load(ck)["done"]) == 50
    for a, b in zip(again, first):
        np.testing.assert_array_equal(a.centers, b.centers)
        np.testing.assert_array_equal(a.marks, b.marks)


def test_stopping_per_scene(monkeypatch):
    """The stopping block is evaluated once per segment over the whole
    batch, not per scene: every scene stops at the same superstep, and the
    summary the condition sees is the JAX batched run's (mean of the lanes'
    final energies, their largest point count, summed accepts over summed
    proposals) on the segment's lane stats. max_iter at one segment (50
    supersteps of 2 moves) stops the batch after its first segment; with
    the budget's end beyond reach the condition never fires."""
    seen, stats = [], []

    class Record(tstop.StopOnMaxIter):
        def do_stop(self, summaries):
            seen.append(summaries[-1])
            return super().do_stop(summaries)

    chain = tscene.run_exact_scene_chain

    def recording_chain(*a, **k):
        out = chain(*a, **k)
        stats.append(out[2])
        return out

    monkeypatch.setattr(tscene, "run_exact_scene_chain", recording_chain)
    out = _run(stopping=Record(max_iter=100))
    assert all(r.stopped and r.supersteps == 50 for r in out)
    assert len(seen) == len(stats) == 1
    st = stats[0]
    assert st.final_energy.shape == (2,)
    # the JAX batched run's summary (tpu/mpp/scene.py, run_exact_scenes_
    # batched), on these lane stats
    acc = float(np.sum(np.asarray(st.accepted)))
    nprop = float(np.sum(np.asarray(st.proposed)))
    want = jstop.SegmentSummary(
        iter=50 * 2, energy=float(np.mean(np.asarray(st.final_energy))),
        n_points=int(np.max(np.asarray(st.final_n_points))),
        temperature=seen[0].temperature, accept_rate=acc / max(nprop, 1.0),
        seconds=seen[0].seconds)
    assert (seen[0].iter, seen[0].energy, seen[0].n_points,
            seen[0].accept_rate) == (want.iter, want.energy, want.n_points,
                                     want.accept_rate)
    # the lanes differ, so per-scene summaries would not be this one
    assert st.final_energy[0] != st.final_energy[1]
    out = _run(stopping=tstop.StopOnMaxIter(max_iter=10 ** 6))
    assert all(not r.stopped and r.supersteps == 100 for r in out)


@pytest.mark.parametrize("cfg", [
    {"kind": "max_iter", "max_iter": 300},
    {"kind": "rejects", "n_window": 2, "tol": 0.05},
    {"kind": "delta_u", "tol": 4.0, "n_window": 1, "min_iter": 150},
    {"kind": "approval_rate", "target_rate": 0.02, "min_iter": 200},
    [{"kind": "max_iter", "max_iter": 10 ** 6},
     {"kind": "approval_rate", "target_rate": 0.3}],
])
def test_stopping_decisions_match_jax(cfg):
    rng = np.random.default_rng(0)
    t_cond = tstop.stopping_from_config(cfg)
    j_cond = jstop.stopping_from_config(cfg)
    t_sum, j_sum = [], []
    decisions = []
    for i in range(1, 9):
        row = dict(iter=100 * i, energy=float(-10 - 3 * i + rng.uniform()),
                   n_points=10, temperature=0.5 ** i,
                   accept_rate=float(rng.uniform(0, 0.2) / i), seconds=0.1)
        t_sum.append(tstop.SegmentSummary(**row))
        j_sum.append(jstop.SegmentSummary(**row))
        decisions.append(t_cond.do_stop(t_sum))
        assert decisions[-1] == j_cond.do_stop(j_sum), (i, cfg)
    assert any(decisions)
    assert tstop.stopping_from_config(None) is None
