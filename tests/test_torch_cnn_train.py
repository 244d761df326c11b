"""CNN training of the PyTorch port against the JAX package's, on the CPU
at float32 and hidden_dims [8, 16]:

  - three train steps of a flax-initialised PosNet (with its DivClassifier
    head) and ShapeNet, carried into the port: losses, parameters, adam's
    moments and the BatchNorm statistics after each step;
  - checkpoints both ways: JAX's ``load_checkpoint`` restores a port file
    (optimizer included, no fallback), the port resumes a JAX file;
  - the CLI: ``-p train -m posnet`` with a regeneration, then ``-r``;
  - two epochs of both packages from one state with augmentation replaced
    by the identity in both: the numpy draws give the same stacks and
    batch order, so the epoch losses agree.

The host pipeline's configs are held to JAX in
``tests/test_torch_host_pipeline.py``.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mpp_cnn_rs_object_detection_torch import __main__ as tcli
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.models import base as tbase
from mpp_cnn_rs_object_detection_torch.models import train_utils as ttu
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    read_checkpoint,
    train_state_from_jax,
)
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    PosNetModel as TPosNet,
)
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel as TShapeNet,
)
from mpp_cnn_rs_object_detection_tpu.data import device_pipeline as jdp
from mpp_cnn_rs_object_detection_tpu.models import train_utils as jtu
from mpp_cnn_rs_object_detection_tpu.models.posnet_model import (
    PosNetModel as JPosNet,
)
from mpp_cnn_rs_object_detection_tpu.models.shapenet_model import (
    ShapeNetModel as JShapeNet,
)

from _torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, B = 32, 16
BASE = {"posnet": "pos_r2cp", "shapenet": "shape_r5ls"}
MODELS = {"posnet": (JPosNet, TPosNet), "shapenet": (JShapeNet, TShapeNet)}
LR = 1e-3


def tiny_config(kind, name, n_epochs=2, patch=P, batch=B, n_patches=64):
    """The trained config of ``kind`` at a tiny size: 64 train and 64 val
    patches of 32^2, batches of 16, U-Net [8, 16] in float32; everything
    else (losses, copy-paste, div head, label smoothing) as configured."""
    with open(os.path.join(ROOT, "model_configs", kind,
                           BASE[kind] + ".json")) as f:
        cfg = json.load(f)
    cfg["model_name"] = name
    dl = cfg["data_loader"]
    dl.update(dataset="tiny", dataset_update_interval=1)
    dl["patch_maker_params"].update(patch_size=patch, n_patches=n_patches,
                                    val_patches=64, max_objects=16)
    cfg["trainer"].update(n_epochs=n_epochs, batch_size=batch)
    cfg["model"] = {"hidden_dims": [8, 16], "dtype": "float32"}
    return cfg


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("cnn_train_ws")
    (ws / "data").mkdir()
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    make_synth_dataset(name="tiny", n_items=2, shape=(96, 96), n_rect=40,
                       seed=0, base_dir=str(ws / "data"))
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


def _noise_bias(path):
    """``ttu.recentred_bias`` of a flax tree path: adam moves such a bias
    along the sign of float noise, in each package independently; the
    loss does not change, but the running means follow it."""
    return ttu.recentred_bias(path.replace("/", "."))


def _sync_noise_biases(tm, jax_tree):
    """Set the port's noise biases (and their adam moments) to JAX's."""
    st = train_state_from_jax(jax_tree)
    with torch.no_grad():
        for name, p in tm.state.params.items():
            if _noise_bias("/" + name.replace(".", "/")):
                p.copy_(st["params"][name])
                tm.state.opt.mu[name] = st["mu"][name]
                tm.state.opt.nu[name] = st["nu"][name]


def _batch(kind, seed, b, p, mappings=None):
    """Images and JAX's targets of ``b`` patches of ``p``^2 with 6
    integer-centred objects each."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, p, p, 3)).astype(np.float32)
    n = 6
    cen = np.zeros((b, 16, 2), np.float32)
    par = np.zeros((b, 16, 3), np.float32)
    val = np.zeros((b, 16), bool)
    cen[:, :n] = np.trunc(rng.uniform(2, p - 2, (b, n, 2)))
    par[:, :n] = np.stack([rng.uniform(3, 6, (b, n)),
                           rng.uniform(6, 12, (b, n)),
                           rng.uniform(0, np.pi, (b, n))], -1)
    val[:, :n] = True
    if kind == "posnet":
        y = jax.vmap(lambda c, q, v: jdp.pos_targets(
            c, q, v, p, 8, sigma_dil=0.6))(cen, par, val)
        y_t = {k: torch.tensor(np.asarray(v)) for k, v in y.items()}
    else:
        y = jax.vmap(lambda c, q, v: jdp.shape_targets(
            c, q, v, p, mappings))(cen, par, val)
        y_t = {"value_class_map": [torch.tensor(np.asarray(v)).long()
                                   for v in y["value_class_map"]],
               "loss_mask": torch.tensor(np.asarray(y["loss_mask"]))}
    return x, y, y_t


def _models(ws, monkeypatch, kind, name, **cfg_kw):
    """The JAX package's model (flax-initialised) and the port's, both on
    the tiny config, the port's state carried over from JAX's."""
    monkeypatch.chdir(ws)
    jcls, tcls = MODELS[kind]
    cfg = tiny_config(kind, name, **cfg_kw)
    jm = jcls(cfg, overwrite=True, train=False)
    tm = tcls(cfg, device="cpu", overwrite=True, train=True)
    assert tm.state.load_jax(_jax_tree(jm.state))
    return jm, tm


@pytest.mark.parametrize("kind", ["posnet", "shapenet"])
def test_three_train_steps_match_jax(ws, monkeypatch, kind):
    """Batches of 4 patches of 16^2: at this size JAX's float32 gradient
    sums lose little to cancellation (at 16 x 32^2 its BatchNorm-fed
    gradients part from a float64 step by ~1 %, the port's far less), so
    the tolerances stay float32-tight."""
    jm, tm = _models(ws, monkeypatch, kind, f"steps_{kind}")
    jstate = jm.state
    for step in range(3):
        x, y, y_t = _batch(kind, step, 4, 16, getattr(jm, "mappings", None))
        jstate, jmetrics = jm.train_step(jstate, (x, y))
        tmetrics = ttu.train_step(tm.state, tm.loss, torch.from_numpy(x),
                                  y_t)
        assert set(tmetrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(tmetrics[k].numpy(),
                                       np.asarray(jmetrics[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {step}")
        jtree = _jax_tree(jstate)
        want, got = _leaves(jtree), _leaves(tm.state.to_jax())
        assert set(got) == set(want)
        assert int(got["/opt_state/0/count"]) == step + 1
        for path, w in want.items():
            if _noise_bias(path):
                if path.startswith("/params/"):
                    assert np.abs(got[path] - w).max() <= 2 * LR * (step + 1)
                continue
            if path.startswith("/opt_state/0/"):
                # gradient sums over the batch's pixels (float32, in
                # another order), relative to the leaf's largest moment
                scale = np.abs(w).max() if w.ndim else 1.0
                assert np.abs(got[path] - w).max() <= 1e-3 * scale, path
            else:
                # params (lr-sized adam steps) and BatchNorm statistics
                np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5,
                                           err_msg=path)
        _sync_noise_biases(tm, jtree)


def test_checkpoints_pass_both_ways(ws, monkeypatch, caplog):
    """The port writes after one step, JAX's ``load_checkpoint`` restores
    params, batch_stats, opt_state and epoch exactly without its fallback
    warning; JAX writes that state back and the port resumes it."""
    jm, tm = _models(ws, monkeypatch, "posnet", "ckpt_posnet")
    x, _, y_t = _batch("posnet", 0, 4, 16)
    ttu.train_step(tm.state, tm.loss, torch.from_numpy(x), y_t)
    port_dir = ws / "ckpt_port"
    port_dir.mkdir()
    ttu.save_checkpoint(str(port_dir), tm.state, 5)
    path = str(port_dir / "checkpoint_0005.msgpack")
    with caplog.at_level(logging.WARNING):
        restored, epoch = jtu.load_checkpoint(path, jm.state)
    assert not [r for r in caplog.records if "opt_state" in r.getMessage()]
    assert epoch == 5
    want = _leaves(tm.state.to_jax())
    got = _leaves(_jax_tree(restored))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["/opt_state/0/count"]) == 1

    # JAX writes into a model store; the port resumes it through -r
    store = ws / "models" / "posnet" / "ckpt_posnet"
    jtu.save_checkpoint(str(store), restored, 7)
    cfg = tiny_config("posnet", "ckpt_posnet")
    resumed = TPosNet(cfg, device="cpu", load=True, train=True)
    assert resumed.last_epoch == 7 and resumed.state.opt.count == 1
    got = _leaves(resumed.state.to_jax())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _log(ws, kind, name):
    with open(ws / "models" / kind / name / "log.json") as f:
        return json.load(f)


def test_cli_trains_regenerates_and_resumes(ws, monkeypatch):
    """``-p train -m posnet`` for 3 epochs (the train stack regenerated
    after epoch 1), then the same config at 4 epochs with ``-r``: it
    resumes at epoch 3 with adam's count, and the log goes on."""
    monkeypatch.chdir(ws)
    cfg = tiny_config("posnet", "cli_posnet", n_epochs=3)
    path = ws / "cli_posnet.json"
    path.write_text(json.dumps(cfg))
    m = tcli.main(["-p", "train", "-m", "posnet", "-c", str(path), "-o"],
                  device="cpu")
    steps = 64 // B
    assert [s for s, _ in m.stack_seconds] == ["train", "val", "train"]
    assert m.state.opt.count == 3 * steps
    store = ws / "models" / "posnet" / "cli_posnet"
    assert sorted(os.listdir(store)) == [
        "checkpoint_0003.msgpack", "config.json", "log.json",
        "model.msgpack"]
    assert int(read_checkpoint(str(store / "model.msgpack"))[
        "opt_state"]["0"]["count"]) == 3 * steps
    log = _log(ws, "posnet", "cli_posnet")
    assert set(log) == {"epoch", "timestamp"} | {
        f"{s}_{k}" for s in ("train", "val")
        for k in ("loss", "vec_loss", "mask_loss")} | {"train_div_loss"}
    assert np.isfinite(log["train_loss"]).all()

    cfg["trainer"]["n_epochs"] = 4
    path.write_text(json.dumps(cfg))
    m = tcli.main(["-p", "train", "-m", "posnet", "-c", str(path), "-r"],
                  device="cpu")
    assert m.last_epoch == 3 and m.state.opt.count == 4 * steps
    assert _log(ws, "posnet", "cli_posnet")["epoch"] == [0, 1, 2, 3]


def test_two_identity_augmented_epochs_match_jax(ws, monkeypatch):
    """Both trainers from one state on the same tiny config (4-patch
    batches of 16^2, copy-paste on) with augmentation replaced by the
    identity: the numpy generator gives both the same stacks and batch
    order, so their logged epoch means agree."""
    def j_identity(key, imgs, cen, par, val):
        return imgs.astype(jnp.float32) / 255.0, cen, par, val

    def t_identity(imgs, cen, par, val, v):
        return imgs.to(torch.float32) / 255.0, cen, par, val

    monkeypatch.setattr(jdp, "augment_batch", j_identity)
    monkeypatch.setattr(tbase, "augment_batch", t_identity)
    monkeypatch.chdir(ws)
    kw = dict(patch=16, batch=4, n_patches=32)
    jm = JPosNet(tiny_config("posnet", "e2e_jax", **kw), overwrite=True)
    tm = TPosNet(tiny_config("posnet", "e2e_port", **kw), device="cpu",
                 overwrite=True, train=True)
    assert tm.state.load_jax(_jax_tree(jm.state))
    jm.train()
    tm.train()
    want, got = _log(ws, "posnet", "e2e_jax"), _log(ws, "posnet", "e2e_port")
    assert set(got) == set(want) and got["epoch"] == want["epoch"] == [0, 1]
    for k in want:
        if k.startswith("train_"):
            # 16 float32 steps in another summation order
            np.testing.assert_allclose(got[k], want[k], rtol=5e-5, err_msg=k)
        elif k.startswith("val_"):
            # eval mode normalises with the running means, which follow
            # the noise biases (_noise_bias) that adam moves independently
            # in each package (the statistics' formula is held to 1e-5 by
            # the three-step test): ~1e-3 apart after 16 steps
            np.testing.assert_allclose(got[k], want[k], rtol=3e-3, err_msg=k)

