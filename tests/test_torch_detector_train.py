"""Training of the baseline detectors in the PyTorch port against the JAX
package's, on the CPU at ``tests/test_detectors.py``'s tiny sizes (depth
18, width 8, patches of 32-64 px, float32):

  - one batch's loss terms, gradients and BatchNorm statistics for each
    detector, through the loss and targets that JAX's ``_build_steps``
    hands its epoch functions, from one set of weights;
  - three steps of the detectors' optimizer against optax's
    ``chain(clip_by_global_norm, adam(warmup_cosine_decay_schedule))``,
    the clip both applied and not, and its state in flax's layout;
  - checkpoints both ways: JAX's ``load_checkpoint`` restores a port
    checkpoint (optimizer included, no fallback), the port resumes JAX's;
  - the CLI round trip of ``tests/test_detectors.py`` (train, infer, eval,
    re-infer with ``overwrite=False`` to the same DOTA snapshot), a resume
    with ``-r`` and the refusal to infer without a checkpoint.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mpp_cnn_rs_object_detection_torch import __main__ as tcli
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.models import fasterrcnn_model as tfm
from mpp_cnn_rs_object_detection_torch.models import train_utils as ttu
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_to_jax,
    read_checkpoint,
    train_state_to_jax,
)
from mpp_cnn_rs_object_detection_torch.mpp.optim import (
    Optimizer,
    warmup_cosine_decay_schedule,
)
from mpp_cnn_rs_object_detection_tpu.models import fasterrcnn_model as jfm
from mpp_cnn_rs_object_detection_tpu.models import train_utils as jtu
from tests._dota_util import dota_snapshot

from _torch_util import one_torch_thread  # noqa: F401

KINDS = {"fasterrcnn": (jfm.FasterRCNNModel, tfm.FasterRCNNModel),
         "bbavec": (jfm.BBAVecModel, tfm.BBAVecModel)}


def _config(name, kind, patch=32, n_epochs=3):
    """``tests/test_detectors.py``'s config (no ``device_pipeline`` flag)."""
    model = (
        {"depth": 18, "width": 8, "head_conv": 16, "down_ratio": 4,
         "dtype": "float32"}
        if kind == "bbavec"
        else {"depth": 18, "width": 8, "fpn_channels": 16, "box_hidden": 64,
              "anchor_sizes": (4, 8, 16, 32, 64), "pre_nms": 64,
              "post_nms_train": 16, "post_nms_infer": 32, "dtype": "float32"}
    )
    return {
        "model_name": name,
        "data_loader": {
            "dataset": "synth_d",
            "dataset_update_interval": 16,
            "patch_maker_params": {
                "patch_size": patch, "n_patches": 16, "max_objects": 16,
                "unf_sampler_weight": 0.5, "obj_sampler_weight": 0.5,
                "obj_sampler_sigma": 4,
            },
        },
        "trainer": {"n_epochs": n_epochs, "batch_size": 4},
        "model": model,
        "loss": {"learning_rate": 2e-3},
    }


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("det_train_ws")
    (ws / "data").mkdir()
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    make_synth_dataset(name="synth_d", n_items=2, shape=(64, 64), n_rect=12,
                       seed=5, base_dir=str(ws / "data"))
    return ws


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _jax_tree(state):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats,
         "opt_state": state.opt_state}))


def _models(ws, monkeypatch, kind, name, **cfg_kw):
    """The port's model (flax-initialised, ``train=False``) and the JAX
    package's from the same weights (its ``_init_variables`` returns the
    port's, which skips flax's eager init); also the loss and target
    functions JAX's ``_build_steps`` gives its epoch functions."""
    monkeypatch.chdir(ws)
    jcls, tcls = KINDS[kind]
    tm = tcls(_config(f"port_{name}", kind, **cfg_kw), device="cpu",
              overwrite=True, train=False)
    variables = tm.state.to_jax()
    variables.pop("opt_state")
    captured = {}

    def capture(apply_loss, tx, target_fn):
        captured.update(apply_loss=apply_loss, target_fn=target_fn)
        return None, None

    monkeypatch.setattr(jcls, "_init_variables", lambda self, key: variables)
    monkeypatch.setattr(jfm, "make_device_epoch_fns", capture)
    jm = jcls(_config(f"jax_{name}", kind, **cfg_kw), overwrite=True,
              train=False)
    return jm, tm, captured


def _batch(seed, b, p, n=6):
    """Images and padded marks of ``b`` patches of ``p``^2, ``n`` objects
    in each but the last, which has none."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, p, p, 3)).astype(np.float32)
    cen = np.zeros((b, 8, 2), np.float32)
    par = np.zeros((b, 8, 3), np.float32)
    val = np.zeros((b, 8), bool)
    cen[:, :n] = rng.uniform(2, p - 2, (b, n, 2))
    par[:, :n] = np.stack([rng.uniform(2, 5, (b, n)),
                           rng.uniform(5, 12, (b, n)),
                           rng.uniform(0, np.pi, (b, n))], -1)
    val[:-1, :n] = True
    return x, cen, par, val


@pytest.mark.parametrize("kind", ["fasterrcnn", "bbavec"])
def test_one_batch_loss_and_gradients(ws, monkeypatch, kind):
    """A train-mode batch of 4 x 64^2: equal targets, the loss terms to
    rtol 1e-4, every gradient leaf within 1e-3 of its largest entry (sums
    over the batch's pixels through train-mode BatchNorm, in float32 in
    another order), the running statistics to 1e-5."""
    jm, tm, fns = _models(ws, monkeypatch, kind, f"grad_{kind}", patch=64)
    x, cen, par, val = _batch(0, 4, 64)
    y = jax.jit(jax.vmap(fns["target_fn"]))(cen, par, val)
    y_t = tm.targets(*(torch.from_numpy(a) for a in (cen, par, val)))
    assert set(y_t) == set(y)
    for k in y:
        np.testing.assert_allclose(y_t[k].numpy().astype(np.float32),
                                   np.asarray(y[k], np.float32), rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    def loss_fn(params, batch_stats, x, y):
        return fns["apply_loss"](params, batch_stats, (x, y), True)

    grads, (metrics, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jm.state.params, jm.state.batch_stats, x, y)
    tm.state.train(True)
    loss, tmetrics = tm.loss(torch.from_numpy(x), y_t, True)
    tgrads = torch.autograd.grad(loss, list(tm.state.params.values()))
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(tmetrics[k].detach().numpy(),
                                   np.asarray(metrics[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(metrics["loss"]) > 0
    want = _leaves(jax.tree_util.tree_map(np.asarray, grads))
    got = _leaves(params_to_jax(dict(zip(tm.state.params, tgrads)))["params"])
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        if "/CombinationModule_" in path and path.endswith("bias") \
                and "/Conv_" in path:
            # a conv bias its BatchNorm re-centres (CTRBOX's decoder): a
            # zero gradient but for float noise, in both packages
            assert max(np.abs(got[path]).max(), np.abs(w).max()) \
                <= 1e-6 * top, path
            continue
        assert np.abs(got[path] - w).max() <= 1e-3 * np.abs(w).max(), path
    want = _leaves(jax.tree_util.tree_map(np.asarray, stats))
    got = _leaves(params_to_jax(tm.state.buffers())["batch_stats"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5,
                                   err_msg=path)


def test_three_optimizer_steps_match_optax():
    """The chain JAX's detectors build, on a schedule of 8 steps (warmup 1):
    step 0 at 5 % of the peak and clipped, step 1 at the peak and not
    clipped, step 2 on the cosine and clipped; the parameters, adam's
    moments and both counts after each, in the tree flax stores (a conv
    kernel, its bias and a dense kernel)."""
    rng = np.random.default_rng(0)
    shapes = {"Conv_0.weight": (8, 4, 3, 3), "Conv_0.bias": (8,),
              "Dense_0.weight": (5, 16)}
    tparams = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for k, s in shapes.items()}
    peak, total, clip = 2e-3, 8, 1.0
    sched = (peak * 0.05, peak, max(1, total // 20), total, peak * 0.01)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adam(optax.warmup_cosine_decay_schedule(
                         init_value=sched[0], peak_value=sched[1],
                         warmup_steps=sched[2], decay_steps=sched[3],
                         end_value=sched[4])))
    jparams = params_to_jax(tparams)["params"]
    opt_state = tx.init(jparams)
    opt = Optimizer(tparams, peak, schedule=warmup_cosine_decay_schedule(
        *sched), clip_norm=clip)
    for step, scale in enumerate((3.0, 0.05, 2.0)):
        grads = {k: torch.from_numpy((rng.normal(0, 1, s) * scale / 12)
                                     .astype(np.float32))
                 for k, s in shapes.items()}
        norm = np.sqrt(sum((g.double() ** 2).sum().item()
                           for g in grads.values()))
        assert (norm > clip) == (step != 1)
        updates, opt_state = tx.update(params_to_jax(grads)["params"],
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams = opt.step(tparams, grads)
        stored = jax.tree_util.tree_map(np.asarray, {
            "params": jparams,
            "opt_state": serialization.to_state_dict(opt_state)})
        ours = train_state_to_jax(tparams, {}, opt.mu, opt.nu, opt.count,
                                  chain=True)
        want, got = _leaves(stored), _leaves(ours)
        assert set(got) == set(want)
        for path, w in want.items():
            if path.endswith("count"):
                assert int(got[path]) == int(w) == step + 1, path
            elif path.startswith("/params"):
                # an lr-sized step from equal parameters, rounded to
                # float32 either way: one ulp apart at most
                np.testing.assert_allclose(got[path], w, rtol=1.2e-7,
                                           atol=1e-9, err_msg=f"{path} {step}")
            else:
                np.testing.assert_allclose(got[path], w, rtol=1e-5,
                                           atol=1e-9, err_msg=path)


@pytest.mark.parametrize("kind", ["fasterrcnn", "bbavec"])
def test_checkpoints_pass_both_ways(ws, monkeypatch, caplog, kind):
    """The port writes after one step, JAX's ``load_checkpoint`` restores
    params, batch_stats, the chain's opt_state and the epoch exactly,
    without its fallback warning; JAX writes that state into a model store
    and the port resumes it (``train=True`` with ``load``)."""
    jm, tm, _ = _models(ws, monkeypatch, kind, f"ckpt_{kind}")
    x, cen, par, val = _batch(1, 4, 32)
    y_t = tm.targets(*(torch.from_numpy(a) for a in (cen, par, val)))
    ttu.train_step(tm.state, tm.loss, torch.from_numpy(x), y_t)
    ttu.save_checkpoint(tm.save_path, tm.state, 2)
    path = os.path.join(tm.save_path, "checkpoint_0002.msgpack")
    with caplog.at_level(logging.WARNING):
        restored, epoch = jtu.load_checkpoint(path, jm.state)
    assert not [r for r in caplog.records if "opt_state" in r.getMessage()]
    assert epoch == 2
    want = _leaves(tm.state.to_jax())
    got = _leaves(_jax_tree(restored))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["/opt_state/1/0/count"]) == 1

    cfg = _config(f"port_ckpt_{kind}", kind)
    jtu.save_checkpoint(tm.save_path, restored, 3)  # replaces the port's
    assert not os.path.exists(path)
    resumed = KINDS[kind][1](cfg, device="cpu", load=True, train=True)
    assert resumed.last_epoch == 3 and resumed.state.opt.count == 1
    assert resumed.device_pipeline
    got = _leaves(resumed.state.to_jax())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["fasterrcnn", "bbavec"])
def test_cli_round_trip(ws, monkeypatch, kind):
    """``tests/test_detectors.py``'s round trip through the port's CLI (the
    config has no ``device_pipeline`` flag: the device pipeline all the
    same), then ``-r`` to 4 epochs; and inference without a checkpoint
    raises."""
    monkeypatch.chdir(ws)
    name = f"cli_{kind}"
    cfg = _config(name, kind)
    cfg["inference"] = {"min_confidence": 0.05}
    path = ws / f"{name}.json"
    path.write_text(json.dumps(cfg))
    argv = ["-m", kind, "-c", str(path)]
    m = tcli.main(["-p", "train", "-o", *argv], device="cpu")
    assert m.device_pipeline
    assert [s for s, _ in m.stack_seconds] == ["train", "val"]
    assert m.state.opt.count == 3 * 4
    store = ws / "models" / kind / name
    ck = read_checkpoint(str(store / "model.msgpack"))
    assert int(ck["opt_state"]["1"]["0"]["count"]) == 12
    log = json.loads((store / "log.json").read_text())
    assert np.isfinite(log["train_loss"]).all() and log["epoch"] == [0, 1, 2]

    tcli.main(["-p", "infer", *argv], device="cpu")
    results = ws / "data" / "inference" / "synth_d" / "val" / name
    import pickle

    with open(results / "0000_results.pkl", "rb") as f:
        res = pickle.load(f)
    if kind == "bbavec":
        assert res["detection_type"] == "poly"
        assert res["detection"].shape[1:] == (4, 2) \
            or len(res["detection"]) == 0
    else:
        assert res["detection_type"] == "bbox"
    tcli.main(["-p", "eval", *argv], device="cpu")
    assert (results / "dota" / "metrics0.25.json").exists()
    first = dota_snapshot(str(results))
    assert any(v.strip() for v in first.values())
    model = tcli.main(["-p", "infer", *argv], device="cpu")
    model.infer(subset="val", overwrite=False)
    assert dota_snapshot(str(results)) == first

    cfg["trainer"]["n_epochs"] = 4
    path.write_text(json.dumps(cfg))
    m = tcli.main(["-p", "train", "-r", *argv], device="cpu")
    assert m.last_epoch == 3 and m.state.opt.count == 16

    missing = ws / f"missing_{kind}.json"
    missing.write_text(json.dumps(_config(f"missing_{kind}", kind)))
    with pytest.raises(FileNotFoundError, match="train before"):
        tcli.main(["-p", "infer", "-m", kind, "-c", str(missing)],
                  device="cpu")
