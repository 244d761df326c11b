"""Files of the PyTorch port against the JAX package and its libraries: the
PNG codec against PIL, the synthetic dataset writer, path resolution, the
msgpack checkpoint writer against flax, and the result-pickle reader."""

import filecmp
import json
import os
import pickle
import struct
import zlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mpp_cnn_rs_object_detection_torch.data.synth import (
    make_synth_dataset as t_make_synth_dataset,
)
from mpp_cnn_rs_object_detection_torch.models import checkpoint as tck
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    PosNetModel as TPosNetModel,
)
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel as TShapeNetModel,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    ValueMapping as TValueMapping,
)
from mpp_cnn_rs_object_detection_torch.utils import config as tconfig
from mpp_cnn_rs_object_detection_torch.utils import png
from mpp_cnn_rs_object_detection_torch.utils.files import load_results
from mpp_cnn_rs_object_detection_tpu.data.synth import (
    make_synth_dataset as j_make_synth_dataset,
)
from mpp_cnn_rs_object_detection_tpu.models import unet as junet
from mpp_cnn_rs_object_detection_tpu.ops.mappings import default_mappings
from mpp_cnn_rs_object_detection_tpu.utils import config as jconfig
from tests._torch_util import encode_png
from tests._torch_util import one_torch_thread  # noqa: F401


def _pil_filters(path, bpp):
    """The row filter types in a PNG file."""
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(rows[:, 0].tolist())


def _mixed_image(h, w, c, seed):
    """Smooth bands between noise bands: PIL's writer picks several row
    filters for such an image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = (np.sin(yy / 5)[..., None] * 100 + xx[..., None]
              + np.arange(c) * 30) % 256
    noise = rng.integers(0, 256, (h, w, c))
    img = np.where((yy % 7 < 3)[..., None], smooth, noise).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("mode,c", [("RGB", 3), ("RGBA", 4), ("L", 1),
                                    ("LA", 2)])
def test_png_reads_pil_files(tmp_path, mode, c):
    img = _mixed_image(48, 67, c, seed=c)
    path = str(tmp_path / "pil.png")
    pil = Image.fromarray(img)
    assert pil.mode == mode
    pil.save(path)
    # PIL's writer uses None, Sub, Up and Paeth rows here
    assert _pil_filters(path, c) == {0, 1, 2, 4}
    np.testing.assert_array_equal(png.read_png(path), np.asarray(
        Image.open(path)))


@pytest.mark.parametrize("mode,c", [("RGB", 3), ("RGBA", 4), ("L", 1),
                                    ("LA", 2)])
def test_png_header_gives_the_loaded_shape(tmp_path, mode, c):
    """``png_header`` reads (H, W, samples) without decoding, and the host
    loader's ``image_shape`` gives the shape ``load_image`` returns."""
    from mpp_cnn_rs_object_detection_torch.data import dataset as tds

    path = str(tmp_path / "pil.png")
    Image.fromarray(_mixed_image(48, 67, c, seed=c)).save(path)
    assert png.png_header(path) == (48, 67, c)
    assert tds.image_shape(path) == tds.load_image(path).shape


def _encode(img, filters):
    """A PNG of an (h, w, 3) uint8 image whose row i uses filter
    ``filters[i % len(filters)]`` (all five types, Average included, which
    PIL's writer does not pick)."""
    h, w, bpp = img.shape
    x = img.astype(np.int32)
    rows = []
    for r in range(h):
        f = filters[r % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), x[r].reshape(-1)[:-bpp]])
        b = x[r - 1].reshape(-1) if r else np.zeros(w * bpp, np.int32)
        ul = (np.concatenate([np.zeros(bpp, np.int32),
                              b[:-bpp]]) if r else np.zeros(w * bpp, np.int32))
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = [0, a, b, (a + b) // 2, paeth][f]
        rows.append(bytes([f]) + ((x[r].reshape(-1) - pred) & 0xFF)
                    .astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_every_filter_type(tmp_path):
    img = _mixed_image(23, 31, 3, seed=9)
    path = tmp_path / "filters.png"
    path.write_bytes(_encode(img, [0, 1, 2, 3, 4, 3, 3, 4]))
    assert _pil_filters(str(path), 3) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("h,w", [(40, 29), (1, 517)])
def test_png_written_reads_back_through_pil(tmp_path, h, w):
    """RGB, and the gray, gray + alpha and RGBA images the dataset
    translators write, read back through PIL and the port's reader; a
    float image and 5 channels are refused."""
    img = _mixed_image(h, w, 3, seed=5)
    path = str(tmp_path / "port.png")
    for pixels in (img, img[..., 0], _mixed_image(h, w, 2, seed=6),
                   _mixed_image(h, w, 4, seed=7)):
        png.write_png(path, pixels)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), pixels)
        np.testing.assert_array_equal(png.read_png(path), pixels)
    for bad in (img.astype(np.float32), _mixed_image(h, w, 5, seed=8)):
        with pytest.raises(ValueError):
            png.write_png(path, bad)


@pytest.mark.parametrize("level", [1, 6])
def test_png_writer_compression_level(tmp_path, level):
    """Level 1 (the training patch sets, as the JAX package writes them)
    and the default 6: the IDAT stream is zlib's at that level over the
    filter-0 rows, the header is read without decoding, and PIL reads the
    pixels back."""
    img = _mixed_image(37, 21, 3, seed=level)
    path = str(tmp_path / f"level{level}.png")
    if level == 6:
        png.write_png(path, img)
    else:
        png.write_png(path, img, level=level)
    with open(path, "rb") as f:
        data = f.read()
    start = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[start - 4:start])
    rows = np.concatenate([np.zeros((37, 1), np.uint8),
                           img.reshape(37, -1)], axis=1)
    assert data[start + 4:start + 4 + n] == zlib.compress(rows.tobytes(),
                                                          level)
    assert png.png_header(path) == (37, 21, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every color type and bit depth the standard allows, each non-interlaced
# and Adam7, and with a tRNS chunk where the type may carry one
FORMATS = [(color, depth, interlace, trns)
           for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                 (3, (1, 2, 4, 8)), (4, (8, 16)),
                                 (6, (8, 16)))
           for depth in depths for interlace in (0, 1)
           for trns in ((False, True) if color in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("color,depth,interlace,trns", FORMATS)
def test_png_refuses_what_it_does_not_read(tmp_path, color, depth,
                                           interlace, trns):
    """The reader reads every PNG the standard allows: for each color type,
    bit depth, interlace and tRNS chunk, ``read_png`` equals
    ``np.asarray(Image.open(path))`` in dtype, shape and values (exact),
    and ``png_header`` gives that array's channels. 13 x 11 pixels, so
    Adam7's passes have ragged sizes."""
    rng = np.random.default_rng(100 * color + 10 * depth + interlace)
    h, w = 13, 11
    values = rng.integers(0, 1 << depth, (h, w, SAMPLES[color]))
    extra = []
    if color == 3:
        n = 1 << depth
        extra.append((b"PLTE", rng.integers(0, 256, 3 * n)
                      .astype(np.uint8).tobytes()))
        if trns:
            extra.append((b"tRNS", bytes(range(min(n, 5)))))
    elif trns:
        extra.append((b"tRNS", b"\x00\x01" * SAMPLES[color]))
    path = str(tmp_path / "x.png")
    encode_png(path, values, depth, color, interlace, rng, extra)
    want = np.asarray(Image.open(path))
    got = png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    assert png.png_header(path) == (h, w) + (
        (1,) if want.ndim == 2 else want.shape[2:])


def test_make_synth_dataset_matches_jax(tmp_path):
    """The same seed: identical images, centers, categories, difficulty
    flags and metadata. ``parameters`` come from float32 polygons, whose
    trigonometry XLA and torch round differently (XLA's float32 cos is not
    correctly rounded): they agree to 1e-5."""
    kw = dict(n_items=3, shape=(64, 64), n_rect=14, seed=7)
    j_make_synth_dataset(name="j", base_dir=str(tmp_path), **kw)
    t_make_synth_dataset(name="t", base_dir=str(tmp_path), **kw)
    for ss in ("train", "val"):
        for i in range(3):
            a, b = (tmp_path / n / ss for n in ("j", "t"))
            np.testing.assert_array_equal(
                png.read_png(str(b / "images" / f"{i:04}.png")),
                np.asarray(Image.open(a / "images" / f"{i:04}.png")))
            assert filecmp.cmp(a / "metadata" / f"{i:04}.json",
                               b / "metadata" / f"{i:04}.json", shallow=False)
            with open(a / "annotations" / f"{i:04}.pkl", "rb") as f:
                la = pickle.load(f)
            with open(b / "annotations" / f"{i:04}.pkl", "rb") as f:
                lb = pickle.load(f)
            assert sorted(la) == sorted(lb)
            assert len(lb["centers"]) > 0
            for k in ("centers", "categories", "difficult"):
                np.testing.assert_array_equal(lb[k], la[k])
                assert lb[k].dtype == la[k].dtype
            np.testing.assert_allclose(lb["parameters"], la["parameters"],
                                       rtol=0, atol=1e-5)


def test_path_resolution(tmp_path, monkeypatch):
    """paths_config.json in the working directory: both packages resolve
    the same roots, files, inference dirs and configs."""
    data, models = tmp_path / "data", tmp_path / "models"
    (data / "ds" / "val" / "images").mkdir(parents=True)
    (data / "ds" / "val" / "annotations").mkdir()
    for i in (0, 1, 2):
        (data / "ds" / "val" / "images" / f"{i:04}.png").write_bytes(b"")
    for i in (0, 1):  # image 2 has no annotation: dropped
        (data / "ds" / "val" / "annotations" / f"{i:04}.pkl").write_bytes(b"")
    (tmp_path / "paths_config.json").write_text(json.dumps(
        {"dataset_path": ["missing_dir", "data"], "model_path": ["models"]}))
    (tmp_path / "model_configs" / "posnet").mkdir(parents=True)
    (tmp_path / "model_configs" / "posnet" / "here.json").write_text(
        json.dumps({"model_name": "here"}))
    monkeypatch.chdir(tmp_path)

    assert tconfig.get_dataset_base_path() == str(data)
    assert tconfig.get_model_base_path() == str(models)
    assert os.path.isdir(models)
    for mod in (tconfig, jconfig):
        paths = mod.fetch_data_paths("ds", "val", metadata=False)
        assert [os.path.basename(p) for p in paths["images"]] == [
            "0000.png", "0001.png"]
    assert (tconfig.fetch_data_paths("ds", "val", metadata=False)
            == jconfig.fetch_data_paths("ds", "val", metadata=False))
    assert tconfig.get_inference_path("m", "ds", "val") == str(
        data / "inference" / "ds" / "val" / "m")

    cfg, _, save_path = tconfig.startup_config({"model_name": "saved"},
                                               "shapenet")
    assert save_path == str(models / "shapenet" / "saved")
    assert json.load(open(os.path.join(save_path, "config.json"))) == cfg
    with pytest.raises(FileExistsError):
        tconfig.startup_config({"model_name": "saved"}, "shapenet")
    tconfig.startup_config({"model_name": "saved"}, "shapenet",
                           load_model=True)
    for name in ("here", "here.json", "saved", "pos_r2cp",
                 str(tmp_path / "paths_config.json")):
        assert (tconfig.resolve_model_config_path(name)
                == jconfig.resolve_model_config_path(name)), name
    with pytest.raises(FileNotFoundError):
        tconfig.resolve_model_config_path("no_such_model")


def _flax_posnet(seed=0):
    net = junet.PosNet(hidden_dims=[8, 16], out_channels=3, dtype=jnp.float32)
    var = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                   train=False)
    div = {"Conv_0": {"kernel": jnp.full((1, 1, 1, 1), -3.0),
                      "bias": jnp.full((1,), 0.5)}}
    return (jax.device_get({"net": var["params"], "div": div}),
            jax.device_get(var["batch_stats"]))


def test_msgpack_writer_against_flax(tmp_path):
    params, stats = _flax_posnet()
    tree = {"params": params, "batch_stats": stats, "epoch": 256,
            "meta": {"lr": 1e-3, "name": "x" * 40, "neg": -70000,
                     "ok": True, "none": None, "step": np.int32(7)}}
    blob = tck.write_msgpack(tree)
    assert blob == flax.serialization.msgpack_serialize(tree)
    back = flax.serialization.msgpack_restore(blob)
    mine = tck.read_msgpack(blob)
    for restored in (back, mine):
        assert restored["epoch"] == 256
        assert restored["meta"]["neg"] == -70000
        assert restored["meta"]["step"] == 7
        leaves_a = jax.tree_util.tree_leaves(restored["params"])
        leaves_b = jax.tree_util.tree_leaves(params)
        assert len(leaves_a) == len(leaves_b)
        for a, b in zip(leaves_a, leaves_b):
            np.testing.assert_array_equal(a, b)


def test_model_save_restores_in_flax(tmp_path):
    """A PosNet and a ShapeNet saved by the port are restored by flax
    (against an initialised template) with the weights they were loaded
    from; ``params_to_jax`` inverts ``params_from_jax``."""
    params, stats = _flax_posnet(seed=3)
    cfg = {"div_clf_model": True, "loss": {"learn_mask": True},
           "trainer": {"n_epochs": 5},
           "model": {"hidden_dims": [8, 16], "dtype": "float32"}}
    model = TPosNetModel(cfg, device="cpu")
    model.load_variables(params, stats)
    model.save_path = str(tmp_path)
    model.save()
    blob = (tmp_path / "model.msgpack").read_bytes()
    restored = flax.serialization.from_bytes(
        {"params": params, "batch_stats": stats, "epoch": 0}, blob)
    assert restored["epoch"] == 5
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(restored["batch_stats"]),
                    jax.tree_util.tree_leaves(stats)):
        np.testing.assert_array_equal(a, b)

    net = junet.ShapeNet(hidden_dims=[8, 16], n_classes=4, dtype=jnp.float32)
    var = jax.device_get(net.init(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 32, 32, 3)), train=False))
    sm = TShapeNetModel({"trainer": {"n_classes": 4, "n_epochs": 1},
                         "model": {"hidden_dims": [8, 16],
                                   "dtype": "float32"}}, device="cpu")
    sm.load_variables(var["params"], var["batch_stats"])
    back = tck.params_to_jax(sm.net.state_dict())
    for part in ("params", "batch_stats"):
        for a, b in zip(jax.tree_util.tree_leaves(back[part]),
                        jax.tree_util.tree_leaves(var[part])):
            np.testing.assert_array_equal(a, b)
    for k, v in tck.params_from_jax(back).items():
        if k.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(v, sm.net.state_dict()[k].float(),
                                   rtol=0, atol=0)


def test_result_pickle_remapping(tmp_path):
    """The JAX package's ValueMapping loads as the port's; any other class
    of the JAX package is refused."""
    path = tmp_path / "r.pkl"
    with open(path, "wb") as f:
        pickle.dump({"mappings": default_mappings(n_classes=8),
                     "output": [np.ones((1, 8, 2, 2), np.float32)]}, f)
    res = load_results(str(path))
    assert all(type(m) is TValueMapping for m in res["mappings"])
    assert res["mappings"][2].is_cyclic
    assert res["mappings"][0].class_to_center_value(0) == 2.0  # 8 bins of 4
    from mpp_cnn_rs_object_detection_tpu.mpp.stopping import StopOnMaxIter

    with open(path, "wb") as f:
        pickle.dump({"stop": StopOnMaxIter(3)}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_results(str(path))


def test_logger_round_trip(tmp_path):
    """log.json: what the port's Logger writes, both packages load."""
    from mpp_cnn_rs_object_detection_torch.utils.logger import Logger
    from mpp_cnn_rs_object_detection_tpu.utils.logger import (
        Logger as JLogger,
    )

    log = Logger(str(tmp_path))
    log.update(0, {"loss": np.float32(0.5), "n": np.int64(3)})
    log.update(1, {"loss": 0.25, "n": 4}, prefix="val_")
    path = str(tmp_path / "log.json")
    for cls in (Logger, JLogger):
        back = cls.load(path)
        assert back.save_dir == str(tmp_path)
        assert back.log["epoch"] == [0, 1]
        assert back.log["loss"] == [0.5] and back.log["val_loss"] == [0.25]
        assert back.log["n"] == [3] and len(back.log["timestamp"]) == 2
