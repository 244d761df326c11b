"""The dataset translators and ``check_div`` of the PyTorch port against the
JAX package, on small raw trees written here (the raw DOTA and COWC sets
are not in the repository).

DOTA: one raw tree in the layout ``fetch_dota_paths`` globs for goes
through both packages' ``translate_dota`` with ``prune_empty`` on and off
and a ``drop_rate`` on the train subset. Its scenes cover integer and
float label coordinates, RGB, RGBA and gray images, GSDs whose rescale is
fractional (0.30 -> 0.6), an integer factor (0.25 -> 0.5, OpenCV's fast
area path, at even and odd sizes) and none (0.50), a banned source, a GSD
above the target, a missing GSD, a scene the category filter leaves
empty, and the three date forms. The annotation pickles are equal, with
their dtypes; the metadata are equal; the decoded images are equal (both
resizes equal OpenCV's here, so no level is allowed to differ); the
port's ``df_paths_and_meta.pkl`` dict has the DataFrame's columns, rows
and values. Under pandas 3 a missing date or source is NaN in the JAX
package's DataFrame (its metadata then read "nan" and NaN), where pandas 2
and the port keep None ("None" and null): that one difference is
normalised below.

COWC: the layout of ``tests/test_data_layer.py:256`` plus an RGBA scene,
and a tree of gray + alpha scenes (Pillow's premultiplied resize).

The PNG reader: the formats it once refused, written by Pillow, read as
Pillow reads them.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data import translate_dota as tdota
from mpp_cnn_rs_object_detection_torch.utils import png
from mpp_cnn_rs_object_detection_torch.utils.png import read_png
from mpp_cnn_rs_object_detection_tpu.data import translate_cowc as jcowc
from mpp_cnn_rs_object_detection_tpu.data import translate_dota as jdota
from tests import _torch_workspace as tw
from tests._torch_util import encode_png

PANDAS_NAN_NONE = int(pd.__version__.split(".")[0]) >= 3

# (id, subset, mode, (h, w), gsd, source, date, coordinates, categories)
SCENES = [
    (1, "train", "RGB", (60, 80), "0.30", "GoogleEarth", "2017-08-13", "int",
     ("small-vehicle", "large-vehicle", "plane")),
    (2, "train", "RGBA", (64, 80), "0.25", "GF-2", "2016/05/12", "float",
     ("small-vehicle", "small-vehicle", "ship")),
    (3, "train", "L", (50, 70), "0.5", "None", "None", "int",
     ("large-vehicle", "small-vehicle")),
    (4, "train", "RGB", (60, 80), "0.30", "Aerial", "2017-08-13", "int",
     ("small-vehicle",)),
    (5, "train", "RGB", (60, 80), "0.5", "GoogleEarth", "", "float",
     ("plane", "ship")),
    (6, "train", "RGB", (60, 80), "0.6", "GoogleEarth", "2017-08-13", "int",
     ("small-vehicle",)),
    (7, "train", "RGB", (60, 80), "None", "GoogleEarth", "2017-08-13", "int",
     ("small-vehicle",)),
    (8, "train", "RGB", (61, 83), "0.25", "GF-2", "2016/05/12", "int",
     ("small-vehicle", "large-vehicle")),
    (9, "train", "RGB", (60, 80), "0.30", "JL-1", "2016/05/12", "float",
     ("large-vehicle",)),
    (11, "val", "RGB", (64, 80), "0.25", "GoogleEarth", "2017-08-13", "int",
     ("small-vehicle", "large-vehicle", "small-vehicle")),
    (12, "val", "RGBA", (60, 80), "0.30", "GoogleEarth", "None", "float",
     ("small-vehicle",)),
    (13, "val", "RGB", (60, 80), "0.5", "Aerial", "2016/05/12", "int",
     ("small-vehicle",)),
]
SUB_FOLDERS = ["raw_images", "images", "raw_annotations", "annotations",
               "metadata"]


def _label_line(rng, h, w, cat, kind):
    c = rng.uniform([8, 8], [h - 8, w - 8])
    a, b, ang = rng.uniform(3, 5), rng.uniform(6, 12), rng.uniform(0, np.pi)
    sx = np.array([a, a, -a, -a]) / 2
    sy = np.array([b, -b, -b, b]) / 2
    ys = c[0] + sx * np.cos(ang) - sy * np.sin(ang)
    xs = c[1] + sx * np.sin(ang) + sy * np.cos(ang)
    pts = np.stack([xs, ys], -1).reshape(-1)
    coords = (" ".join(str(int(round(v))) for v in pts) if kind == "int"
              else " ".join(f"{v:.1f}" for v in pts))
    return f"{coords} {cat} {int(rng.integers(2))}"


def write_raw_dota(root, scenes=SCENES, seed=0):
    """A raw DOTA tree: ``<subset>/images/P*.png``,
    ``<subset>/DOTA-v2.0_<subset>/P*.txt`` and ``<subset>/meta/P*.txt``."""
    rng = np.random.default_rng(seed)
    for pid, subset, mode, (h, w), gsd, source, date, kind, cats in scenes:
        for d in ("images", f"DOTA-v2.0_{subset}", "meta"):
            os.makedirs(os.path.join(root, subset, d), exist_ok=True)
        channels = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
        pixels = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        Image.fromarray(pixels[..., 0] if mode == "L" else pixels,
                        mode).save(os.path.join(root, subset, "images",
                                                f"P{pid:04}.png"))
        lines = [_label_line(rng, h, w, c, kind) for c in cats]
        with open(os.path.join(root, subset, f"DOTA-v2.0_{subset}",
                               f"P{pid:04}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(root, subset, "meta", f"P{pid:04}.txt"),
                  "w") as f:
            f.write(f"acquisition dates:{date}\nimagesource:{source}\n"
                    f"gsd:{gsd}\n")


def _config(raw, name, prune_empty):
    with open(os.path.join(tw.ROOT, "model_configs", "translation",
                           "translate_DOTA_config.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, dota_base_path=[str(raw)], prune_empty=prune_empty,
               drop_rate={"train": 0.25, "val": 0.0})
    return cfg


def _nan_to_none(v):
    return None if isinstance(v, float) and np.isnan(v) else v


def _jax_meta(meta):
    """The JAX package's metadata as pandas 2 writes it (see the module
    docstring)."""
    if PANDAS_NAN_NONE:
        meta = dict(meta, source=_nan_to_none(meta["source"]))
        if meta["date"] == "nan":
            meta["date"] = "None"
    return meta


def _assert_same_pickle(got, want, where):
    assert got.keys() == want.keys(), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


def _compare_trees(ws_j, ws_t, name, subsets):
    root_j, root_t = ws_j / "data" / name, ws_t / "data" / name
    for ss in subsets:
        j, t = root_j / ss, root_t / ss
        for sub in SUB_FOLDERS:
            assert (sorted(os.listdir(j / sub))
                    == sorted(os.listdir(t / sub))), (ss, sub)
        for fname in sorted(os.listdir(j / "annotations")):
            with open(j / "annotations" / fname, "rb") as f:
                want = pickle.load(f)
            with open(t / "annotations" / fname, "rb") as f:
                got = pickle.load(f)
            _assert_same_pickle(got, want, f"{ss}/{fname}")
            stem = fname[:-4]
            meta_j = json.loads((j / "metadata" / f"{stem}.json").read_text())
            meta_t = json.loads((t / "metadata" / f"{stem}.json").read_text())
            assert meta_t == _jax_meta(meta_j), (ss, stem)
            img_j = np.asarray(Image.open(j / "images" / f"{stem}.png"))
            img_t = read_png(str(t / "images" / f"{stem}.png"))
            assert img_t.shape == img_j.shape == tuple(meta_t["shape"])
            np.testing.assert_array_equal(img_t, img_j, err_msg=stem)
            for sub, ext in (("raw_images", "png"), ("raw_annotations",
                                                     "txt")):
                assert ((j / sub / f"{stem}.{ext}").read_bytes()
                        == (t / sub / f"{stem}.{ext}").read_bytes())
        df = pd.read_pickle(j / "df_paths_and_meta.pkl")
        with open(t / "df_paths_and_meta.pkl", "rb") as f:
            table = pickle.load(f)
        assert list(table) == list(df.columns)
        for col in df.columns:
            want = [_nan_to_none(v) if col in ("date", "source") else v
                    for v in df[col].tolist()]
            assert table[col] == want, col
    return root_t


@pytest.fixture(scope="module")
def dota(tmp_path_factory):
    base = tmp_path_factory.mktemp("translate")
    raw = base / "raw"
    write_raw_dota(str(raw))
    ws_j, ws_t = tw.workspace(base / "jax"), tw.workspace(base / "torch")
    return raw, ws_j, ws_t


@pytest.mark.parametrize("prune_empty", [True, False])
def test_translate_dota_matches_jax(dota, prune_empty):
    raw, ws_j, ws_t = dota
    name = f"DOTA_t{int(prune_empty)}"
    cfg = _config(raw, name, prune_empty)
    path = ws_t / f"{name}.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws_j):
        jdota.translate_dota(json.loads(json.dumps(cfg)))
    with tw.inside(ws_t):
        counts = t_main(["-p", "translate_dota", "-c", str(path)],
                        device="cpu")
    root = _compare_trees(ws_j, ws_t, name, ["train", "val"])
    # train: 6 of 9 scenes pass (4 banned, 6 coarser, 7 without GSD), 5
    # when the empty scene 5 is pruned; the drop rate keeps int(n * 0.75)
    n_train = int((5 if prune_empty else 6) * 0.75)
    assert counts == {"train": n_train, "val": 2}, counts
    names = {int(f[:4]) for f in os.listdir(root / "train" / "images")}
    assert not names & {4, 6, 7}
    if not prune_empty and 5 in names:
        with open(root / "train" / "annotations" / "0005.pkl", "rb") as f:
            empty = pickle.load(f)
        assert all(v.shape == (0,) and v.dtype == np.float64
                   for v in empty.values())
    metas = {f: json.loads((root / "val" / "metadata" / f).read_text())
             for f in os.listdir(root / "val" / "metadata")}
    assert {m["date"] for m in metas.values()} == {"2017-08-13 00:00:00",
                                                  "None"}


@pytest.mark.parametrize("text,want", [
    ("2017-08-13", "2017-08-13 00:00:00"),
    ("2016/05/12", "2016-05-12 00:00:00"),
    ("2016/5/2", "2016-05-02 00:00:00"), ("", "NaT"), ("None", None),
    ("12/05/2016", ValueError), ("2016-05-12 10:00", ValueError),
    ("May 2016", ValueError)])
def test_dates_as_pandas_reads_them(text, want):
    """The date forms DOTA uses, as ``str(pd.to_datetime(text))`` gives
    them ("None" makes pandas raise, and the JAX package keeps None); any
    other string raises, naming it."""
    if want is ValueError:
        with pytest.raises(ValueError, match=repr(text)):
            tdota.parse_date(text)
        return
    assert tdota.parse_date(text) == want
    if want is None:
        with pytest.raises(Exception):
            pd.to_datetime(text)
    else:
        assert str(pd.to_datetime(text)) == want


def test_label_columns_typed_as_pandas(tmp_path):
    """Each column's dtype as ``pd.read_csv(sep=" ")`` infers it over the
    whole file: an integer column with one float becomes float64."""
    path = tmp_path / "l.txt"
    path.write_text("10 20 30 20 30 40 10 40 small-vehicle 0\n"
                    "1.5 2 3 2 3 4 1 4 plane 1\n\n"
                    "5 6 7 8 9 10 11 12 ship 0\n")
    got = tdota.parse_label_file(str(path))
    want = jdota.parse_label_file(str(path))
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, (c, got[c].dtype, w.dtype)
        np.testing.assert_array_equal(got[c], w)


@pytest.mark.parametrize("mode,named", [
    ("P", "palette"), ("I;16", "bit depth 16"), ("interlaced", "interlaced"),
    ("1", "bit depth 1"), ("P;1", "palette at 1 bit"),
    ("P;2", "palette at 2 bits"), ("P;4", "palette at 4 bits"),
    ("LA", "gray + alpha"), ("RGBA", "RGBA"),
    ("interlaced;16", "interlaced RGB at 16 bits")])
def test_png_formats_refused(tmp_path, mode, named):
    """The formats the reader once refused, as Pillow writes them (the
    interlaced ones encoded here: Pillow writes no Adam7 file): ``read_png``
    equals ``np.asarray(Image.open(path))`` (dtype, shape, exact values),
    and so does the translators' float view of it."""
    path = str(tmp_path / "x.png")
    rng = np.random.default_rng(len(mode))
    if mode.startswith("interlaced"):
        depth = 16 if mode.endswith("16") else 8
        encode_png(path, rng.integers(0, 1 << depth, (6, 8, 3)), depth, 2,
                      1, rng)
    elif mode.startswith("P"):
        bits = int(mode[2:]) if ";" in mode else 8
        pixels = rng.integers(0, 1 << bits, (6, 8)).astype(np.uint8)
        img = Image.fromarray(pixels, "L").convert("P")
        img.putpalette(list(rng.integers(0, 256, 3 * 256)))
        img.save(path, bits=bits)
    else:
        shape = {"LA": (6, 8, 2), "RGBA": (6, 8, 4)}.get(mode, (6, 8))
        dtype = np.uint16 if mode == "I;16" else np.uint8
        pixels = rng.integers(0, 1 << (8 * dtype().itemsize), shape)
        img = Image.fromarray(pixels.astype(dtype))
        (img.convert("1") if mode == "1" else img).save(path)
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape, named
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.float32)[..., :3],
                                  np.asarray(Image.open(path),
                                             dtype=np.float32)[..., :3])


def _raw_cowc(root, seed=3):
    """``tests/test_data_layer.py:256``'s raw COWC layout, plus an RGBA
    scene whose cars are marked in an RGBA annotation."""
    raw = root / "Utah"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(4):
        img = rng.uniform(0, 255, (60, 80, 3)).astype(np.uint8)
        ann = np.zeros((60, 80, 3), np.uint8)
        for r, c in [(10, 12), (30, 40), (50, 70)]:
            ann[r, c] = (255, 0, 0)
        if i == 3:
            img = np.concatenate([img, np.full((60, 80, 1), 200, np.uint8)],
                                 -1)
            ann = np.concatenate([ann, ann[..., :1]], -1)
        Image.fromarray(img).save(raw / f"img{i}.png")
        Image.fromarray(ann).save(raw / f"img{i}_Annotated_Cars.png")
        Image.fromarray(ann[..., :3] * 0).save(
            raw / f"img{i}_Annotated_Negatives.png")


def test_translate_cowc_matches_jax(tmp_path):
    _raw_cowc(tmp_path / "cowc_raw")
    cfg = {"name": "COWC_t", "cowc_base_path": [str(tmp_path / "cowc_raw")],
           "target_gsd": 0.5, "val_fraction": 0.34, "seed": 0}
    ws_j = tw.workspace(tmp_path / "jax")
    ws_t = tw.workspace(tmp_path / "torch")
    path = ws_t / "cowc.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws_j):
        jcowc.translate_cowc(dict(cfg))
    with tw.inside(ws_t):
        counts = t_main(["-p", "translate_cowc", "-c", str(path)],
                        device="cpu")
    assert counts == {"val": 1, "train": 3}
    for ss in ("train", "val"):
        j = ws_j / "data" / "COWC_t" / ss
        t = ws_t / "data" / "COWC_t" / ss
        files = sorted(os.listdir(j / "annotations"))
        assert files == sorted(os.listdir(t / "annotations"))
        for fname in files:
            with open(j / "annotations" / fname, "rb") as f:
                want = pickle.load(f)
            with open(t / "annotations" / fname, "rb") as f:
                got = pickle.load(f)
            _assert_same_pickle(got, want, f"{ss}/{fname}")
            assert got["centers"].shape == (3, 2)
            stem = fname[:-4]
            assert (json.loads((t / "metadata" / f"{stem}.json").read_text())
                    == json.loads((j / "metadata" / f"{stem}.json")
                                  .read_text()))
            img_j = np.asarray(Image.open(j / "images" / f"{stem}.png"))
            img_t = read_png(str(t / "images" / f"{stem}.png"))
            assert img_t.shape == (18, 24, 3)
            np.testing.assert_array_equal(img_t, img_j)


def test_translate_cowc_gray_alpha_matches_jax(tmp_path):
    """A raw COWC tree of gray + alpha scenes (alpha 0, 255 and in between,
    so Pillow's premultiplied resize rounds every way; one scene's
    annotation gray + alpha too): both packages' translations equal, the
    images kept as 2-channel PNGs, pixel for pixel."""
    raw = tmp_path / "cowc_raw" / "Potsdam"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for i in range(3):
        img = rng.integers(0, 256, (61, 79, 2)).astype(np.uint8)
        img[..., 1] = rng.choice([0, 255, 3, 128, 200], (61, 79))
        ann = np.zeros((61, 79, 2 if i == 0 else 3), np.uint8)
        for r, c in [(11, 13), (33, 47), (52, 70)]:
            ann[r, c] = 255
        Image.fromarray(img).save(raw / f"g{i}.png")
        Image.fromarray(ann).save(raw / f"g{i}_Annotated_Cars.png")
    cfg = {"name": "COWC_la", "cowc_base_path": [str(raw.parent)],
           "target_gsd": 0.5, "val_fraction": 0.34, "seed": 1}
    ws_j = tw.workspace(tmp_path / "jax")
    ws_t = tw.workspace(tmp_path / "torch")
    path = ws_t / "cowc.json"
    path.write_text(json.dumps(cfg))
    with tw.inside(ws_j):
        jcowc.translate_cowc(dict(cfg))
    with tw.inside(ws_t):
        counts = t_main(["-p", "translate_cowc", "-c", str(path)],
                        device="cpu")
    assert counts == {"val": 1, "train": 2}
    for ss in ("train", "val"):
        j = ws_j / "data" / "COWC_la" / ss
        t = ws_t / "data" / "COWC_la" / ss
        files = sorted(os.listdir(j / "annotations"))
        assert files == sorted(os.listdir(t / "annotations"))
        for fname in files:
            with open(j / "annotations" / fname, "rb") as f:
                want = pickle.load(f)
            with open(t / "annotations" / fname, "rb") as f:
                got = pickle.load(f)
            _assert_same_pickle(got, want, f"{ss}/{fname}")
            stem = fname[:-4]
            assert (json.loads((t / "metadata" / f"{stem}.json").read_text())
                    == json.loads((j / "metadata" / f"{stem}.json")
                                  .read_text()))
            img_j = np.asarray(Image.open(j / "images" / f"{stem}.png"))
            img_t = read_png(str(t / "images" / f"{stem}.png"))
            assert img_t.shape == (18, 23, 2)
            np.testing.assert_array_equal(img_t, img_j)


def test_check_div_on_the_cpu(capsys):
    """``-p check_div`` on the CPU: the numpy divergence against the
    port's, the plain detection map against numpy's, and no kernel line."""
    errors = t_main(["-p", "check_div"], device="cpu")
    out = capsys.readouterr().out
    assert set(errors) == {"divergence", "plain"}
    assert errors["divergence"] < 1e-5 and errors["plain"] < 1e-5, errors
    assert "numpy vs torch divergence" in out
    assert "needs the CUDA device" in out and "CUDA kernel" not in out
