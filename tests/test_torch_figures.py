"""The port's figures against the JAX package's and matplotlib: the raster
plotter (``utils/raster_plot.py``), ``mpp/figures.py``, the image-stack
viewer (``utils/show_img_seq.py``), the PR curves of ``dota_eval`` and
``make_gif``.

Held: the canvas size of every figure (read from the JAX package's own
PNG with PIL), the data-to-pixel transform (to matplotlib's within 1
pixel; each data point's pixel carries the line colour), the colormap
tables (to 1/255 after uint8), and what each figure function computes:
``energy_attribution`` (a linear combiner's exactly ``w * x``, 1e-5;
the mlp's completeness, and the logistic and mlp combiners' equal to
JAX's, 1e-5), the papangelou field (rtol 1e-5), the interaction pairs
(JAX's cache matrices, 1e-5), the cross-plot histograms (numpy's, exact)
and the summary plot's jitter (numpy's ``default_rng(0)``, exact). GIF
frames decode with Pillow to the source pixels (exact at 256 colours or
fewer); frame count, duration and loop equal the JAX package's GIF. The
pixels of a figure are not held.
"""

import functools
import importlib
import os
import re
from types import SimpleNamespace

import jax
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from mpp_cnn_rs_object_detection_torch.metrics import dota_eval as teval
from mpp_cnn_rs_object_detection_torch.metrics import dota_writer as twriter
from mpp_cnn_rs_object_detection_torch.mpp import combinators as tcomb
from mpp_cnn_rs_object_detection_torch.mpp import energy_setups as tes
from mpp_cnn_rs_object_detection_torch.mpp import figures as tfig
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    ImageWMaps as TImageWMaps,
)
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    build_cache as t_build_cache,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import expand_lanes, lane
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    state_from_arrays as t_state,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    default_mappings as t_mappings,
)
from mpp_cnn_rs_object_detection_torch.utils import display as tdisp
from mpp_cnn_rs_object_detection_torch.utils import files as tfiles
from mpp_cnn_rs_object_detection_torch.utils import raster_plot as rp
from mpp_cnn_rs_object_detection_torch.utils import show_img_seq as tseq
from mpp_cnn_rs_object_detection_torch.utils.png import (
    png_header,
    read_png,
    write_png,
)
from mpp_cnn_rs_object_detection_tpu.mpp import combinators as jcomb
from mpp_cnn_rs_object_detection_tpu.mpp import figures as jfig
from mpp_cnn_rs_object_detection_tpu.mpp.energy_setups import (
    NoCalibrationEnergySetup as JSetup,
)
from mpp_cnn_rs_object_detection_tpu.mpp.rjmcmc import (
    build_cache as j_build_cache,
)
from mpp_cnn_rs_object_detection_tpu.mpp.state import (
    state_from_arrays as j_state,
)
from mpp_cnn_rs_object_detection_tpu.utils import display as jdisp
from mpp_cnn_rs_object_detection_tpu.utils import show_img_seq as jseq
from tests._torch_util import one_torch_thread  # noqa: F401
from tests.test_figures_viewer import NAMES, _small_scene
from tests.test_torch_metrics import _fill

matplotlib.use("Agg")
# the module (the JAX package's metrics/__init__ re-exports a function of
# the same name)
jeval = importlib.import_module(
    "mpp_cnn_rs_object_detection_tpu.metrics.dota_eval")

ATOL = 1e-5
PAP_RTOL = 1e-5
MARKS = (5.0, 0.5, 0.3)


def _size(path):
    """(H, W) of a PNG the JAX package wrote, read with PIL."""
    return np.asarray(Image.open(path)).shape[:2]


def _port_size(path):
    return png_header(str(path))[:2]


# ---------------------------------------------------------- the plotter


@pytest.mark.parametrize("name", ["plasma", "viridis", "coolwarm",
                                  "tab10"])
def test_colormap_tables_match_matplotlib(name):
    """The tables to 1/255 after uint8, and the lookup of values in and
    out of [0, 1] to matplotlib's ``cmap(x, bytes=True)``."""
    mcm = matplotlib.colormaps[name]
    cm = rp.get_cmap(name)
    want = np.asarray(mcm(np.arange(mcm.N)))[:, :3] * 255
    assert cm.lut.shape == (mcm.N, 3)
    assert np.abs(cm.lut.astype(float) - want).max() <= 1.0
    x = np.concatenate([np.random.default_rng(0).uniform(-0.2, 1.2, 500),
                        [0.0, 1.0, 0.5, 255 / 256]])
    got = cm(x).astype(int)
    ref = np.asarray(mcm(x, bytes=True))[:, :3].astype(int)
    assert np.abs(got - ref).max() <= 1


def test_font_covers_printable_ascii():
    """Every printable character but the space has set pixels; text boxes
    grow by 6 pixels per character at scale 1, and are 7 rows tall, 9
    where a glyph descends."""
    for code in range(33, 127):
        assert rp.text_mask(chr(code), 1).any(), chr(code)
    assert rp.text_mask("ab", 2).shape == (14, 22)
    assert rp.text_mask("gb", 2).shape == (18, 22)
    assert rp.text_size("0.25", 10, 100) == (46, 14)


def _pr_data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    tp = rng.random(n) < 0.4
    rec = np.cumsum(tp) / (tp.sum() + 20)
    prec = np.cumsum(tp) / np.arange(1, n + 1)
    return rec, prec


def test_pr_curve_transform_matches_matplotlib(tmp_path):
    """The JAX package's PR figure (``plt.figure(figsize=(8, 4))``, default
    subplot parameters, 100 dpi): the port's canvas has matplotlib's size,
    its limits and data-to-pixel transform matplotlib's (within a pixel),
    and each (recall, precision) point's pixel carries the line colour."""
    import matplotlib.pyplot as plt

    rec, prec = _pr_data()
    path = str(tmp_path / "pr.png")
    ax = teval.pr_curve_plot(rec, prec, path)
    fig = plt.figure(figsize=(8, 4))
    plt.xlabel("recall")
    plt.ylabel("precision")
    plt.plot(rec, prec)
    plt.savefig(str(tmp_path / "mpl.png"))
    max_ = plt.gca()
    np.testing.assert_allclose(ax._transform[4], max_.get_xlim(), rtol=1e-12)
    np.testing.assert_allclose(ax._transform[5], max_.get_ylim(), rtol=1e-12)
    disp = max_.transData.transform(np.stack([rec, prec], -1))
    rows, cols = ax.to_pixel(rec, prec)
    assert np.abs(cols - np.floor(disp[:, 0])).max() <= 1
    assert np.abs(rows - np.floor(fig.bbox.height - disp[:, 1])).max() <= 1
    plt.close("all")
    img = read_png(path)
    assert img.shape == (400, 800, 4) and _size(tmp_path / "mpl.png") == (
        400, 800)
    line = rp.to_rgb("C0")[0]
    assert (img[rows, cols, :3] == line).all()


def test_eval_pr_curves_at_jax_canvas(tmp_path, monkeypatch):
    """Both packages' ``dota_eval`` on one DOTA directory: each writes the 5
    ``prec_rec_curve_{iou}.png``; the port's at the canvas of JAX's."""
    sizes = {}
    for pkg, mod in (("jax", jeval), ("torch", teval)):
        ws = tmp_path / pkg
        results = ws / "data" / "inference" / "ds" / "val" / "model"
        (ws / "models").mkdir(parents=True)
        results.mkdir(parents=True)
        (ws / "paths_config.json").write_text(
            '{"dataset_path": ["%s"], "model_path": ["%s"]}'
            % (ws / "data", ws / "models"))
        monkeypatch.chdir(ws)
        _fill(twriter, str(results), "obb", "", seed=3)
        mod.dota_eval(str(ws / "models" / "model"), "ds", "val", "obb")
        files = sorted(f for f in os.listdir(results / "dota")
                       if f.endswith(".png"))
        assert files == [f"prec_rec_curve_{t:.2f}.png"
                         for t in teval.IOU_THRESHOLDS]
        read = _size if pkg == "jax" else _port_size
        sizes[pkg] = [read(results / "dota" / f) for f in files]
    assert sizes["torch"] == sizes["jax"] == [(400, 800)] * 5


# ------------------------------------------------------ energy figures


def _combiners():
    lin = jcomb.linear(NAMES).replace(params={
        "weights": np.asarray([2.0, -1.0, 0.5, 0.0, 3.0], np.float32),
        "bias": np.asarray(0.7, np.float32)})
    return {"linear": lin, "logistic": jcomb.logistic(NAMES).replace(
        params={"weights": np.asarray([0.8, -0.3, 1.2, 0.4, -0.9],
                                      np.float32),
                "bias": np.asarray(-0.2, np.float32)}),
        "mlp": jcomb.mlp(NAMES, hidden_features=6, hidden_layers=2, seed=3)}


def _port(comb):
    return tcomb.combiner_from_dict(jcomb.combiner_to_dict(comb))


@pytest.mark.parametrize("kind", ["linear", "logistic", "mlp"])
def test_energy_attribution_matches_jax(kind):
    """The port's (one (n_steps, N, E) ``combine`` under autograd) equals
    JAX's; the linear combiner's is exactly ``w * x``."""
    comb = _combiners()[kind]
    x = np.random.default_rng(1).standard_normal((12, 5)).astype(
        np.float32) * 0.5
    got = tfig.energy_attribution(_port(comb), torch.from_numpy(x))
    assert got.shape == (12, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, jfig.energy_attribution(comb, x),
                               rtol=ATOL, atol=ATOL)
    if kind == "linear":
        np.testing.assert_allclose(
            got, x * np.asarray(comb.params["weights"]), rtol=ATOL,
            atol=ATOL)


def test_energy_attribution_completeness_mlp():
    """``tests/test_figures_viewer.py``'s axiom on the port: rows sum to
    combine(x) - combine(0) (n_steps 256, rtol 5e-2, atol 5e-3)."""
    comb = _port(jcomb.mlp(NAMES, hidden_features=6, hidden_layers=2,
                           seed=3))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 5)).astype(np.float32) * 0.5)
    attr = tfig.energy_attribution(comb, x, n_steps=256)
    gap = (tcomb.combine(comb, x) - tcomb.combine(comb, torch.zeros_like(x))
           ).numpy()
    np.testing.assert_allclose(attr.sum(-1), gap, rtol=5e-2, atol=5e-3)


def test_attribution_summary_plot_matches_jax(tmp_path):
    """JAX's canvas; the jitter replayed from numpy's ``default_rng(0)``
    row by row in JAX's order (exact)."""
    x = np.random.default_rng(2).standard_normal((20, 5)).astype(np.float32)
    comb = _combiners()["logistic"]
    attr = jfig.energy_attribution(comb, x)
    jfig.attribution_summary_plot(attr, x, list(NAMES),
                                  str(tmp_path / "j.png"))
    ys = tfig.attribution_summary_plot(attr, torch.from_numpy(x),
                                       list(NAMES), str(tmp_path / "t.png"))
    rng = np.random.default_rng(0)
    order = np.argsort(np.abs(attr).mean(axis=0))
    want = np.stack([row + 0.12 * rng.standard_normal(20)
                     for row in range(len(order))])
    np.testing.assert_array_equal(ys, want)
    assert _port_size(tmp_path / "t.png") == _size(tmp_path / "j.png")


def test_energy_cross_plots_counts(tmp_path):
    """Each term's histogram is numpy's (20 bins, exact); JAX's canvas."""
    v = np.random.default_rng(3).standard_normal((50, 5)).astype(np.float32)
    e = v.sum(-1)
    counts = tfig.energy_cross_plots(torch.from_numpy(v), list(NAMES),
                                     str(tmp_path / "t.png"),
                                     per_point_energy=torch.from_numpy(e))
    jfig.energy_cross_plots(v, list(NAMES), str(tmp_path / "j.png"),
                            per_point_energy=e)
    np.testing.assert_array_equal(counts, np.stack(
        [np.histogram(v[:, i], bins=20)[0] for i in range(5)]))
    assert _port_size(tmp_path / "t.png") == _size(tmp_path / "j.png")


def _scenes():
    """``tests/test_figures_viewer.py:_small_scene`` in both packages, with
    each package's calibrated setup."""
    jd = _small_scene()
    td = TImageWMaps(**{**jd.__dict__, "mappings": t_mappings(
        n_classes=8, size_min=0, size_max=16)})
    js = JSetup()
    js.calibrate([jd], np.random.default_rng(0), save_path="")
    ts = tes.NoCalibrationEnergySetup()
    ts.calibrate([td], np.random.default_rng(0), save_path="")
    return jd, js, td, ts


def test_papangelou_heatmap_matches_jax(tmp_path):
    """The 64^2 scene at stride 4 with the sum combiner: the field equals
    JAX's (rtol 1e-5); JAX's canvas."""
    jd, js, td, ts = _scenes()
    want = jfig.papangelou_heatmap(jd.image, js.make_maps(jd), js.spec,
                                   jcomb.sum_combiner(js.spec.names), MARKS,
                                   str(tmp_path / "j.png"), stride=4)
    got = tfig.papangelou_heatmap(td.image, ts.make_maps(td), ts.spec,
                                  tcomb.sum_combiner(ts.spec.names), MARKS,
                                  str(tmp_path / "t.png"), stride=4)
    assert got.shape == want.shape == (16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PAP_RTOL)
    assert _port_size(tmp_path / "t.png") == _size(tmp_path / "j.png")


def test_interaction_figure_pairs_match_jax_cache(tmp_path):
    """The pairs drawn are the alive pairs within ``max_dist``, each with
    JAX's cache value (1e-5); JAX's canvas."""
    jd, js, td, ts = _scenes()
    centers = np.concatenate([jd.gt_centers, jd.gt_centers[:2] + 3.0])
    marks = np.concatenate([jd.gt_marks, jd.gt_marks[:2]])
    jst = j_state(centers, marks, capacity=8)
    # jitted, as the JAX chain builds it (eager dispatch takes seconds)
    jcache = jax.jit(functools.partial(j_build_cache, spec=js.spec))(
        jst, js.make_maps(jd))
    jfig.interaction_figure(jd.image, jst, jcache, str(tmp_path / "j.png"))
    tst = t_state(centers, marks, capacity=8)
    tcache = lane(t_build_cache(expand_lanes(tst, 1),
                                expand_lanes(ts.make_maps(td), 1), ts.spec),
                  0)
    pairs = tfig.interaction_figure(td.image, tst, tcache,
                                    str(tmp_path / "t.png"))
    dist, ov = np.asarray(jcache.dist), np.asarray(jcache.overlap)
    n = len(centers)
    want = {(i, j) for i in range(n) for j in range(i + 1, n)
            if dist[i, j] <= 32.0}
    assert {(i, j) for i, j, _ in pairs} == want and len(want) > 3
    err = max(abs(v - ov[i, j]) for i, j, v in pairs)
    assert err <= ATOL, err
    assert _port_size(tmp_path / "t.png") == _size(tmp_path / "j.png")


def test_weight_and_loss_plots_at_jax_canvas(tmp_path):
    log = {"PositionEnergy_weight": [1.0, 1.2, 1.1], "bias": [0.0, 0.1, 0.3],
           "loss": [3.0, 2.0, 1.0]}
    for mod, tag in ((jfig, "j"), (tfig, "t")):
        mod.weight_trajectory_plot(log, str(tmp_path / f"w_{tag}.png"))
        mod.loss_plot([3.0, 2.0, 1.5], [3.5, 2.5, 2.0],
                      str(tmp_path / f"l_{tag}.png"))
    for f in ("w", "l"):
        assert _port_size(tmp_path / f"{f}_t.png") == _size(
            tmp_path / f"{f}_j.png")


# ------------------------------------------------------- viewer and GIF


def _draw(i, ax, data):
    ax.imshow(data[i]["img"])
    ax.set_title(f"frame {i}")


@pytest.mark.parametrize("n_axes", [1, 2, (2, 2)])
def test_export_frames_at_jax_canvas(tmp_path, n_axes):
    frames = [{"img": np.random.default_rng(k).random((8, 8))}
              for k in range(3)]

    def draw(i, axs, data):
        for ax in (np.ravel(axs) if isinstance(axs, np.ndarray) else [axs]):
            _draw(i, ax, data)

    jp = jseq.export_frames(frames, draw, str(tmp_path / "j"),
                            n_axes=n_axes)
    tp = tseq.export_frames(frames, draw, str(tmp_path / "t"),
                            n_axes=n_axes)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p)
                                                 for p in jp]
    assert [_port_size(p) for p in tp] == [_size(p) for p in jp] == [
        (528, 704)] * 3


def test_image_stack_display_navigation_and_export(tmp_path):
    """Right and left step and clamp; ``e`` writes the current frame at the
    figure's 100 dpi (the JAX viewer's canvas)."""
    import matplotlib.pyplot as plt

    frames = [{"img": np.full((4, 4), k / 4.0)} for k in range(3)]
    seen = []

    def draw(i, ax, data):
        seen.append(i)
        _draw(i, ax, data)

    fig, ax = rp.subplots()
    view = tseq.ImageStackDisplay(ax, draw, frames, save_path=str(tmp_path),
                                  save_prefix="v")
    jfig_, jax_ = plt.subplots()
    jview = jseq.ImageStackDisplay(jax_, _draw, frames,
                                   save_path=str(tmp_path),
                                   save_prefix="j")
    for key in ("left", "right", "right", "right", "e", "left", "e"):
        event = SimpleNamespace(key=key)
        view.key(event)
        jview.key(event)
        assert view.ind == jview.ind
    plt.close("all")
    assert seen == [0, 0, 1, 2, 2, 2, 1, 1]
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("v")) == [
        "v_001.png", "v_002.png"]
    assert _port_size(tmp_path / "v_002.png") == _size(
        tmp_path / "j_002.png") == (480, 640)
    assert tseq.show_image_sequence(frames, _draw) is None


def _gif_frames(path):
    im = Image.open(path)
    out = []
    for k in range(im.n_frames):
        im.seek(k)
        out.append((np.asarray(im.convert("RGB")), im.info.get("duration")))
    return out, im.info.get("loop")


def test_make_gif_matches_jax(tmp_path):
    """Frames of at most 256 colours (a gray one, a repeated one that both
    writers merge, an RGBA one) decode to their exact pixels; the frame
    count, the durations and the loop equal the JAX package's GIF."""
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    frames = [palette[rng.integers(0, 256, (21, 33))],
              palette[rng.integers(0, 7, (21, 33))],
              np.repeat(rng.integers(0, 256, (21, 33, 1)), 3, -1).astype(
                  np.uint8)]
    frames.append(frames[2])
    rgba = np.concatenate([palette[rng.integers(0, 9, (21, 33))],
                           np.full((21, 33, 1), 255, np.uint8)], -1)
    frames.append(rgba)
    for k, f in enumerate(frames):
        write_png(str(tmp_path / f"f{k}.png"), f)
    for mod in (jdisp, tdisp):
        assert mod.make_gif(str(tmp_path), "none*.png", "x.gif") is None
    jpath = jdisp.make_gif(str(tmp_path), "f*.png", "j.gif", duration_ms=300)
    tpath = tdisp.make_gif(str(tmp_path), "f*.png", "t.gif", duration_ms=300)
    assert tpath == str(tmp_path / "t.gif")
    got, loop_t = _gif_frames(tpath)
    want, loop_j = _gif_frames(jpath)
    assert loop_t == loop_j == 0
    assert [d for _, d in got] == [d for _, d in want] == [300, 300, 600,
                                                          300]
    for (g, _), f in zip(got, [frames[0], frames[1], frames[2], rgba]):
        np.testing.assert_array_equal(g, f[..., :3])


def test_gif_many_colours_uses_own_palette(tmp_path):
    """More than 256 colours: the port's median cut (Pillow's quantizer is
    not copied); the decoded frame stays within the palette's error."""
    yy, xx = np.mgrid[:40, :50]
    frame = np.stack([yy * 6, xx * 5, (yy + xx) * 3], -1).astype(np.uint8)
    tdisp.write_gif(str(tmp_path / "m.gif"), [frame])
    (got, _), = _gif_frames(str(tmp_path / "m.gif"))[0]
    err = np.abs(got.astype(int) - frame)
    assert err.mean() < 4 and err.max() <= 32


def test_timestamp_format():
    assert re.fullmatch(r"\d{8}-\d{6}", tfiles.timestamp())
