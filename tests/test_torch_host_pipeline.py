"""The host CNN-training pipeline of the PyTorch port against the JAX
package's, on the same numpy inputs and generator seeds (CPU, tiny sizes:
synthetic scenes of 96 x 80, patches of 32^2, U-Net [8, 16] in float32):

  - ``extract_patch``, ``sample_point_2d`` and ``DensitySampler`` on the
    same density files: the same crops, centers and generator states;
  - both label processors in every mode (with ``class_perturbation``):
    equal targets, equal generator states;
  - ``make_patch_dataset`` with copy-paste and with error densities,
    against JAX's ``multiprocess=False``: identical pixels, annotations,
    metadata and generator states;
  - an epoch of the port's ``BatchLoader`` with 4 workers equals its own
    with 1 worker bit for bit, and JAX's with ``num_workers=1`` (patches
    within 1e-5: the linear resize's rounding; targets exactly);
  - ``PatchDataset`` against JAX's;
  - ``-p train -m posnet|shapenet`` on the host configs, both packages
    from one initial state for two epochs (a regeneration after the last;
    for the PosNet also a hard-mining pass there, so no loss depends on
    it): per-epoch losses within the tolerances of
    ``tests/test_torch_cnn_train.py``'s two-epoch test, the error maps within
    one level, the mined patch sets compared, and each package resuming
    the other's checkpoint. The JAX model is built as ``main.py`` builds
    it, with ``multiprocess=False`` and ``num_workers=1`` monkeypatched in;
  - ``-p data_preview -m posnet|shapenet``: the train loader's first batch
    written as the JAX package writes it, pixel for pixel; a
    device-pipeline config refused before anything is built.
"""

import functools
import json
import logging
import os

import jax
import numpy as np
import pytest
from flax import serialization
from PIL import Image

from mpp_cnn_rs_object_detection_torch import __main__ as tcli
from mpp_cnn_rs_object_detection_torch.data import augmentation as taug
from mpp_cnn_rs_object_detection_torch.data import dataset as tds
from mpp_cnn_rs_object_detection_torch.data import label_processing as tlp
from mpp_cnn_rs_object_detection_torch.data import patch_making as tpm
from mpp_cnn_rs_object_detection_torch.data import patch_samplers as tps
from mpp_cnn_rs_object_detection_torch.data.synth import make_synth_dataset
from mpp_cnn_rs_object_detection_torch.models import base as tbase
from mpp_cnn_rs_object_detection_torch.ops import mappings as tmap
from mpp_cnn_rs_object_detection_torch.ops.sampler2d import (
    sample_point_2d as t_sample_point_2d,
)
from mpp_cnn_rs_object_detection_torch.utils.png import (
    read_png,
    save_unit_image,
)
from mpp_cnn_rs_object_detection_tpu.data import augmentation as jaug
from mpp_cnn_rs_object_detection_tpu.data import dataset as jds
from mpp_cnn_rs_object_detection_tpu.data import label_processing as jlp
from mpp_cnn_rs_object_detection_tpu.data import patch_making as jpm
from mpp_cnn_rs_object_detection_tpu.data import patch_samplers as jps
from mpp_cnn_rs_object_detection_tpu.models import base as jbase
from mpp_cnn_rs_object_detection_tpu.models import posnet_model as jposnet
from mpp_cnn_rs_object_detection_tpu.models import train_utils as jtu
from mpp_cnn_rs_object_detection_tpu.models.posnet_model import (
    PosNetModel as JPosNet,
)
from mpp_cnn_rs_object_detection_tpu.models.shapenet_model import (
    ShapeNetModel as JShapeNet,
)
from mpp_cnn_rs_object_detection_tpu.ops import mappings as jmap
from mpp_cnn_rs_object_detection_tpu.ops.sampler2d import (
    sample_point_2d as j_sample_point_2d,
)

from _torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, B = 32, 16
# patches through a linear resize written out against OpenCV's SIMD one
PATCH_TOL = 1e-5
PERTURB = {-1: 0.2, 0: 0.6, 1: 0.2}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("host_ws")
    (ws / "data").mkdir()
    (ws / "paths_config.json").write_text(json.dumps(
        {"dataset_path": [str(ws / "data")],
         "model_path": [str(ws / "models")]}))
    make_synth_dataset(name="tiny", n_items=3, shape=(96, 80), n_rect=30,
                       seed=0, base_dir=str(ws / "data"))
    # error maps of the train scenes at 1/8 (12 x 10): some all zero
    dens = ws / "dens"
    dens.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        m = rng.random((12, 10)) ** 3 if i != 1 else np.zeros((12, 10))
        save_unit_image(str(dens / f"{i:04}.png"), m)
    return ws


def _dens(ws):
    return [str(ws / "dens" / f) for f in sorted(os.listdir(ws / "dens"))]


def _assert_tree_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def test_extract_patch_matches_jax():
    img = np.random.default_rng(0).random((50, 40, 3)).astype(np.float32)
    for anchor in [(25, 20), (0, 0), (3, 39), (49, 2), (60, 50), (-20, 10),
                   (16, 16), (34, 24)]:
        got = tds.extract_patch(img, np.array(anchor), 32)
        want = jds.extract_patch(img, np.array(anchor), 32)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(anchor))


@pytest.mark.parametrize("mode,max_distance", [
    ("uvec", 8), ("uvec", "auto"), ("vec", 6), ("dist", "auto"),
    ("dist", 8)])
def test_pos_label_processor_matches_jax(mode, max_distance):
    rng = np.random.default_rng(1)
    kw = dict(max_distance=max_distance, mode=mode, n_classes=4,
              sigma_dil=0.6)
    t, j = tlp.PosLabelProcessor(**kw), jlp.PosLabelProcessor(**kw)
    for n in (0, 1, 9):
        patch = rng.random((P, P, 3))
        centers = rng.integers(0, P, (n, 2)) if n else np.array([])
        params = np.stack([rng.uniform(2, 5, n), rng.uniform(5, 10, n),
                           rng.uniform(0, np.pi, n)], -1) if n \
            else np.array([])
        _assert_tree_equal(t.process(patch, centers, params, 0),
                           j.process(patch, centers, params, 0),
                           f"{mode} {max_distance} n={n}")


@pytest.mark.parametrize("mask_mode,sigma,perturb", [
    ("shapes", "auto", None), ("shapes", None, PERTURB),
    ("gaussian", "auto", PERTURB), ("gaussian", 2.0, None)])
def test_shape_label_processor_matches_jax(mask_mode, sigma, perturb):
    rng = np.random.default_rng(2)
    kw = dict(mask_mode=mask_mode, mask_sigma=sigma, mask_cutoff_dist=5.0,
              class_perturbation=perturb)
    t = tlp.ShapeLabelProcessor(mappings=tmap.default_mappings(32),
                                rng=np.random.default_rng(7), **kw)
    j = jlp.ShapeLabelProcessor(mappings=jmap.default_mappings(32),
                                rng=np.random.default_rng(7), **kw)
    for n in (0, 1, 12, 5):
        patch = rng.random((P, P, 3))
        centers = rng.integers(0, P, (n, 2)).astype(float)
        params = np.stack([rng.uniform(2, 5, n), rng.uniform(5, 10, n),
                           rng.uniform(0, 2 * np.pi, n)], -1)
        _assert_tree_equal(t.process(patch, centers, params, 0),
                           j.process(patch, centers, params, 0),
                           f"{mask_mode} n={n}")
        assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_sample_point_2d_matches_jax():
    rng = np.random.default_rng(3)
    dens = rng.random((12, 10)) ** 3
    mask = rng.random((12, 10)) < 0.3
    for kw in (dict(), dict(density=dens), dict(mask=mask),
               dict(density=dens, mask=mask),
               dict(density=dens / dens.sum(), skip_normalization=True)):
        for size in (1, 5):
            a, b = np.random.default_rng(9), np.random.default_rng(9)
            got = t_sample_point_2d((12, 10), size=size, rng=a, **kw)
            want = j_sample_point_2d((12, 10), size=size, rng=b, **kw)
            np.testing.assert_array_equal(got, want)
            assert a.bit_generator.state == b.bit_generator.state


def test_density_sampler_matches_jax(ws, monkeypatch):
    """The same density PNGs (one all zero: uniform draws) inside the
    mixed sampler, as hard mining adds it."""
    monkeypatch.chdir(ws)
    paths = tds.fetch_data_paths("tiny", "train")
    samplers = []
    for mod in (tps, jps):
        rng = np.random.default_rng(5)
        s = mod.MixedSampler(
            n_patches=64, rng=rng, weights=[0.33, 0.66],
            samplers=[mod.UniformSampler(n_patches=64, patch_size=P,
                                         rng=rng),
                      mod.ObjectSampler(n_patches=64, patch_size=P, rng=rng,
                                        sigma=10)])
        s.add_sampler(mod.DensitySampler(
            n_patches=64, patch_size=P, rng=rng, density_files=_dens(ws),
            rescale_fac=1 / 8), 0.5)
        s.initialise(paths["images"], paths["annotations"], paths["metadata"])
        samplers.append(s)
    t, j = samplers
    np.testing.assert_array_equal(t.weights, j.weights)
    np.testing.assert_array_equal(t.sample_density_per_image,
                                  j.sample_density_per_image)
    assert len(t) == len(j) == 64
    for _ in range(60):
        image = t.sample_image()
        assert image == j.sample_image()
        centers = tds.load_annotation(paths["annotations"][image])["centers"]
        np.testing.assert_array_equal(
            t.sample_patch_center(image, np.array([96, 80]), centers),
            j.sample_patch_center(image, np.array([96, 80]), centers))
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def _config(kind, name, n_epochs=2, copy_paste=None, **dl):
    base = {"posnet": "config_pos", "shapenet": "config_shape"}[kind]
    with open(os.path.join(ROOT, "model_configs", kind, base + ".json")) as f:
        cfg = json.load(f)
    cfg["model_name"] = name
    cfg["data_loader"].update(dataset="tiny", dataset_update_interval=1,
                              **dl)
    cfg["data_loader"]["patch_maker_params"].update(patch_size=P,
                                                    n_patches=64)
    if copy_paste:
        cfg["data_loader"]["patch_maker_params"]["copy_paste"] = copy_paste
    cfg["trainer"].update(n_epochs=n_epochs, batch_size=B)
    cfg["model"] = {"hidden_dims": [8, 16], "dtype": "float32"}
    return cfg


def _read_set(root):
    """{relative path: content} of a patch set: PNG pixels, pickles,
    metadata dicts."""
    out = {}
    for sub, _, files in os.walk(root):
        for f in files:
            path = os.path.join(sub, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".png"):
                out[rel] = np.asarray(Image.open(path))
            elif f.endswith(".pkl"):
                out[rel] = tds.load_annotation(path)
            else:
                with open(path) as fh:
                    out[rel] = json.load(fh)
    return out


def _assert_sets_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for rel in want:
        if isinstance(want[rel], dict) and "anchor" in want[rel]:
            assert got[rel] == want[rel], rel
        else:
            _assert_tree_equal(got[rel], want[rel], f"{what} {rel}")


@pytest.mark.parametrize("case", ["copy_paste", "densities"])
def test_make_patch_dataset_matches_jax(ws, monkeypatch, case):
    monkeypatch.chdir(ws)
    copy_paste = {"p": 0.7, "n_range": [1, 3]} if case == "copy_paste" \
        else None
    cfg = _config("posnet", "mpd", copy_paste=copy_paste)
    kw = dict(source_dataset="tiny", config=cfg, make_val=True)
    if case == "densities":
        kw.update(sampling_densities=_dens(ws), d_sampler_weight=0.5,
                  densities_rescale_fac=1 / 8)
    rt, rj = np.random.default_rng(6), np.random.default_rng(6)
    tpm.make_patch_dataset(new_dataset=f"t_{case}", rng=rt, **kw)
    jpm.make_patch_dataset(new_dataset=f"j_{case}", rng=rj,
                           multiprocess=False, **kw)
    assert rt.bit_generator.state == rj.bit_generator.state
    got = _read_set(ws / "data" / f"t_{case}")
    want = _read_set(ws / "data" / f"j_{case}")
    assert len(want) == 3 * (64 + 32)
    _assert_sets_equal(got, want, case)


def _loader_epoch(mod, root_rng_seed, workers, augment, perturb):
    """One shuffled, augmented train epoch and one in-order val epoch of
    ``mod``'s loaders over the ``mpd`` set (class perturbation drawing
    from the trainer's generator in both)."""
    rng = np.random.default_rng(root_rng_seed)
    lp = (tlp if mod is tds else jlp).ShapeLabelProcessor(
        mappings=(tmap if mod is tds else jmap).default_mappings(32),
        class_perturbation=perturb, rng=rng)
    aug = (taug if mod is tds else jaug).DataAugment(
        rng=rng, dataset="tiny", subset="train", hist_match_images=True,
        aug_level="strong") if augment else None
    train = mod.ImageDataset("t_copy_paste", "train", rng, lp, augmenter=aug)
    val = mod.ImageDataset("t_copy_paste", "val", rng, lp)
    batches = list(mod.BatchLoader(train, B, shuffle=True, rng=rng,
                                   num_workers=workers))
    batches += list(mod.BatchLoader(val, B, shuffle=False,
                                    num_workers=workers))
    return batches, rng


def test_batch_loader_matches_jax_and_ignores_worker_count(ws, monkeypatch):
    monkeypatch.chdir(ws)
    if not (ws / "data" / "t_copy_paste").exists():
        tpm.make_patch_dataset("t_copy_paste", "tiny", _config(
            "posnet", "mpd", copy_paste={"p": 0.7}), np.random.default_rng(6),
            make_val=True)
    four, r4 = _loader_epoch(tds, 8, 4, True, PERTURB)
    one, r1 = _loader_epoch(tds, 8, 1, True, PERTURB)
    jax_one, rj = _loader_epoch(jds, 8, 1, True, PERTURB)
    assert len(four) == len(jax_one) == 64 // B + 32 // B
    assert r4.bit_generator.state == r1.bit_generator.state \
        == rj.bit_generator.state
    for b, ((x4, y4), (x1, y1), (xj, yj)) in enumerate(zip(four, one,
                                                           jax_one)):
        np.testing.assert_array_equal(x4, x1)
        _assert_tree_equal(y4, y1, f"batch {b}")
        np.testing.assert_allclose(x4, xj, rtol=0, atol=PATCH_TOL)
        _assert_tree_equal(y4, yj, f"batch {b}")


def test_patch_dataset_matches_jax(ws, monkeypatch):
    monkeypatch.chdir(ws)
    items = []
    for mod, smod, lmod in ((tds, tps, tlp), (jds, jps, jlp)):
        rng = np.random.default_rng(12)
        sampler = smod.MixedSampler(
            n_patches=40, rng=rng, weights=[0.5, 0.5],
            samplers=[smod.UniformSampler(n_patches=40, patch_size=P,
                                          rng=rng),
                      smod.ObjectSampler(n_patches=40, patch_size=P, rng=rng,
                                         sigma=4)])
        d = mod.PatchDataset(P, "tiny", "train", rng,
                             lmod.PosLabelProcessor(max_distance=8), sampler)
        assert len(d) == 40
        items.append(([d[i] for i in range(20)], rng))
    (got, rt), (want, rj) = items
    assert rt.bit_generator.state == rj.bit_generator.state
    _assert_tree_equal([list(g) for g in got], [list(w) for w in want],
                       "items")


# ---------------------------------------------------------------- the CLI


def _jax_host_path(monkeypatch):
    """JAX's deterministic host semantics: patch sets drawn in the parent,
    one loader thread."""
    mpd = functools.partial(jpm.make_patch_dataset, multiprocess=False)
    for mod in (jpm, jbase, jposnet):
        monkeypatch.setattr(mod, "make_patch_dataset", mpd)
    monkeypatch.setattr(jbase, "BatchLoader",
                        functools.partial(jds.BatchLoader, num_workers=1))


def _keep_patch_sets(monkeypatch):
    """Both trainers' ``clean`` records the set instead of removing it;
    returns the records and the port's ``clean``."""
    kept, port_clean = [], tbase.PatchBasedTrainer.clean
    monkeypatch.setattr(jbase.PatchBasedTrainer, "clean",
                        lambda self: kept.append(self.temp_dataset))
    monkeypatch.setattr(tbase.PatchBasedTrainer, "clean",
                        lambda self: kept.append(self.temp_dataset))
    return kept, port_clean


def _log(ws, kind, name):
    with open(ws / "models" / kind / name / "log.json") as f:
        return json.load(f)


def _jax_tree(state):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats,
         "opt_state": state.opt_state}))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("kind", ["posnet", "shapenet"])
def test_cli_trains_host_configs_like_jax(ws, monkeypatch, caplog, kind):
    """The reference recipe (``config_pos`` / ``config_shape``: strong
    augmentation with histogram matching; for the PosNet the div head and
    hard mining), 2 epochs of 4 steps, the train set regenerated after
    epoch 1 (the last) and, for the PosNet, mined there too. JAX trains
    first; its initial state goes to the port's store as
    ``checkpoint_0000.msgpack``, which ``-r`` resumes."""
    monkeypatch.chdir(ws)
    _jax_host_path(monkeypatch)
    kept, port_clean = _keep_patch_sets(monkeypatch)
    mining = {"error_update_interval": 1} if kind == "posnet" else {}
    jname, tname = f"cli_{kind}_jax", f"cli_{kind}_port"
    jcls = JPosNet if kind == "posnet" else JShapeNet
    # as main.py builds it for -p train
    jm = jcls(_config(kind, jname, **mining), overwrite=True, load=False,
              train=True, dataset=None)
    tstore = ws / "models" / kind / tname
    tstore.mkdir(parents=True)
    jtu.save_checkpoint(str(tstore), jm.state, 0)
    jm.train()
    path = ws / f"{tname}.json"
    path.write_text(json.dumps(_config(kind, tname, **mining)))
    tm = tcli.main(["-p", "train", "-m", kind, "-c", str(path), "-r"],
                   device="cpu")
    assert tm.last_epoch == 0 and tm.state.opt.count == 2 * (64 // B)
    assert [s for s, _ in tm.stack_seconds] == ["train+val", "train"]
    assert tm.regenerations == [(1, kind == "posnet")]

    want, got = _log(ws, kind, jname), _log(ws, kind, tname)
    assert set(got) == set(want) and got["epoch"] == want["epoch"] == [0, 1]
    for k in want:
        if k.startswith("train_"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-5, err_msg=k)
        elif k.startswith("val_"):
            # eval mode: the running means follow the biases a BatchNorm
            # re-centres, which adam moves along float noise
            np.testing.assert_allclose(got[k], want[k], rtol=3e-3, err_msg=k)
    assert sorted(os.listdir(tstore)) == [
        "checkpoint_0002.msgpack", "config.json", "log.json",
        "model.msgpack"]

    sets = {n: _read_set(ws / "data" / f"temp_{n}" / "train")
            for n in (jname, tname)}
    if kind == "posnet":
        # the error maps: both models' masks after 8 steps part by float
        # noise, which moves a truncated level here and there; on these
        # 12 x 10 maps 5-8 % of pixels sit one level apart
        maps = {n: ws / "data" / "error_maps" / "tiny" / "train" / n
                for n in (jname, tname)}
        names = sorted(os.listdir(maps[jname]))
        assert names == sorted(os.listdir(maps[tname])) == [
            "0000.png", "0001.png", "0002.png"]
        equal_sources = []
        for f in names:
            a = np.asarray(Image.open(maps[jname] / f)).astype(int)
            b = np.asarray(Image.open(maps[tname] / f)).astype(int)
            assert a.shape == b.shape == (12, 10, 3)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.15, f
            if (a == b).all():
                equal_sources.append(f)
        # the mined sets, wherever their maps are equal
        for rel, meta in sets[jname].items():
            if rel.startswith("metadata") and meta["source"] in \
                    equal_sources:
                stem = rel[len("metadata/"):-len(".json")]
                for sub, ext in (("images", "png"), ("annotations", "pkl"),
                                 ("metadata", "json")):
                    r = f"{sub}/{stem}.{ext}"
                    _assert_sets_equal({r: sets[tname][r]},
                                       {r: sets[jname][r]}, "mined")
    else:
        _assert_sets_equal(sets[tname], sets[jname], "regenerated")
    assert sorted(kept) == sorted(f"temp_{n}" for n in (jname, tname))
    port_clean(tm)
    assert not (ws / "data" / f"temp_{tname}").exists()

    # each package resumes the other's files: the port JAX's store, JAX
    # the port's (optimizer included, no fallback) through the restore its
    # constructor runs on ``load=True`` (with its trained state as the
    # template, which has the fresh state's tree)
    tcls = type(tm)
    back = tcls(_config(kind, jname, **mining), device="cpu", load=True,
                train=True)
    assert back.last_epoch == 2 and back.state.opt.count == 8
    port_clean(back)
    with caplog.at_level(logging.WARNING):
        jback, jepoch = jtu.load_checkpoint(
            jtu.latest_checkpoint(str(tstore)), jm.state)
    assert not [r for r in caplog.records if "opt_state" in r.getMessage()]
    assert jepoch == 2
    port = _leaves(tm.state.to_jax())
    restored = _leaves(_jax_tree(jback))
    assert set(port) == set(restored)
    for k in port:
        np.testing.assert_array_equal(restored[k], port[k], err_msg=k)
    jstate = _leaves(_jax_tree(jm.state))
    for k, v in _leaves(back.state.to_jax()).items():
        np.testing.assert_array_equal(v, jstate[k], err_msg=k)


# ------------------------------------------------------------ data preview


@pytest.mark.parametrize("kind", ["posnet", "shapenet"])
def test_data_preview_matches_jax(ws, monkeypatch, kind):
    """``-p data_preview``: both packages build the model as ``main.py``
    does for it (``train=True``, ``load=True``) and write the first train
    batch's first 8 patches (and a PosNet's masks) as
    ``data_samples_train/sample_b00_{j:04}_{raw,mask}.png``: the same
    files, pixel for pixel."""
    monkeypatch.chdir(ws)
    _jax_host_path(monkeypatch)
    jname, tname = f"preview_{kind}_jax", f"preview_{kind}_port"
    jcls = JPosNet if kind == "posnet" else JShapeNet
    jcls(_config(kind, jname), overwrite=False, load=True, train=True,
         dataset=None).data_preview()
    path = ws / f"{tname}.json"
    path.write_text(json.dumps(_config(kind, tname)))
    tcli.main(["-p", "data_preview", "-m", kind, "-c", str(path)],
              device="cpu")
    j_dir, t_dir = (ws / "models" / kind / n / "data_samples_train"
                    for n in (jname, tname))
    names = sorted(os.listdir(j_dir))
    parts = ("raw", "mask") if kind == "posnet" else ("raw",)
    assert names == sorted(os.listdir(t_dir)) == sorted(
        f"sample_b00_{j:04}_{p}.png" for j in range(8) for p in parts)
    for name in names:
        np.testing.assert_array_equal(read_png(str(t_dir / name)),
                                      np.asarray(Image.open(j_dir / name)))


def test_data_preview_refuses_the_device_pipeline(ws, monkeypatch):
    """A device-pipeline config has no batch loader to preview: the port
    raises before building the model or its stacks. (JAX's fails there
    with an ``AttributeError``: its device path builds no
    ``train_loader``, which its ``data_preview`` reads; read from its
    code, since building JAX's device stacks costs test time here.)"""
    import inspect

    monkeypatch.chdir(ws)
    assert "train_loader" in inspect.getsource(JPosNet.data_preview)
    assert "train_loader" not in inspect.getsource(
        jbase.PatchBasedTrainer.__init_data_device__)
    cfg = _config("posnet", "preview_device", device_pipeline=True)
    path = ws / "preview_device.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="device_pipeline"):
        tcli.main(["-p", "data_preview", "-m", "posnet", "-c", str(path)],
                  device="cpu")
    assert not (ws / "models" / "posnet" / "preview_device").exists()
