"""A raster plotter in numpy: the part of matplotlib the figures draw with.

The GPU host has no matplotlib, and the port has no JAX counterpart for
this module (as for ``utils/png.py``). A ``Figure`` holds a grid of
``Axes``; each axes keeps what was drawn on it (lines, scatters, a
histogram's bars, an image, polygons, vertical lines, labels, ticks, a
legend, a colorbar) and the figure rasterises it all at ``savefig`` into an
RGBA canvas written by ``utils/png.py:write_png``.

Held to matplotlib (``tests/test_torch_figures.py``):
- the canvas's pixel size for a ``figsize`` and ``dpi`` (``int(size *
  dpi)``; 100 dpi by default, ``figsize`` (6.4, 4.8) for ``subplots``);
- the data-to-pixel transform (``Axes.to_pixel``) at matplotlib's default
  subplot parameters, with its autoscaling: data limits widened by 5 %
  margins (not past a histogram's 0), an image's extent, ticks at "nice"
  steps of 1, 2, 2.5, 5 or 10;
- the colormap tables ``plasma``, ``viridis``, ``coolwarm`` and the
  ``tab10`` colour cycle.
Not held: the pixels. There is no antialiasing; text is a 5 x 7 bitmap font
of printable ASCII scaled by whole pixels; ``tight_layout`` sizes a
uniform grid from the labels' extents, more simply than matplotlib's.

Lines are OpenCV's 8-connected segments (``utils/display.py``), vectorised
over every segment of a call, widened by whole pixels; no drawing loops
per point in Python.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpp_cnn_rs_object_detection_torch.utils.display import (
    _segment_pixels,
    last_writes,
)
from mpp_cnn_rs_object_detection_torch.utils.png import write_png

DPI = 100.0            # matplotlib's figure.dpi and savefig's default
FIGSIZE = (6.4, 4.8)   # matplotlib's figure.figsize
FONT_SIZE = 10.0       # points: tick labels, axis labels, legend
TITLE_SIZE = 12.0      # points ("large")
MARGIN = 0.05          # autoscale margin, each side
# matplotlib's default subplot parameters, as fractions of the figure
SUBPLOT_PARS = {"left": 0.125, "right": 0.9, "bottom": 0.11, "top": 0.88,
                "wspace": 0.2, "hspace": 0.2}
TIGHT_PAD = 1.08       # tight_layout's padding, in font sizes
TICK_LEN = 3.5         # points
TICK_PAD = 3.5         # points between a tick and its label
LABEL_PAD = 4.0        # points between tick labels and an axis label
TITLE_PAD = 6.0        # points
LINE_WIDTH = 1.5       # points
SPINE_WIDTH = 0.8      # points
MARKER_AREA = 36.0     # scatter's default ``s``, points^2
# a colorbar's share of its parent's box, and the gap before it
CBAR_FRACTION, CBAR_PAD, CBAR_ASPECT = 0.15, 0.05, 20.0
TICK_STEPS = (1.0, 2.0, 2.5, 5.0, 10.0)
BLACK = np.zeros(3, np.uint8)
WHITE = np.full(3, 255, np.uint8)


# ----------------------------------------------------------------- colours


def _hex_rgb(h: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(h.lstrip("#")), np.uint8).copy()


TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
_TAB_NAMES = ("blue", "orange", "green", "red", "purple", "brown", "pink",
              "gray", "olive", "cyan")
_NAMED = {"black": "#000000", "white": "#ffffff", "gray": "#808080",
          "grey": "#808080", "lime": "#00ff00", "red": "#ff0000",
          "green": "#008000", "blue": "#0000ff"}


def to_rgb(color) -> Tuple[np.ndarray, float]:
    """A matplotlib colour -- a name (``"gray"``, ``"lime"``,
    ``"tab:blue"``, ``"C0"``), ``"#rrggbb"`` or an RGB(A) tuple of floats
    in [0, 1] -- as (uint8 RGB, alpha)."""
    if isinstance(color, str):
        if color.startswith("#"):
            return _hex_rgb(color), 1.0
        if color.startswith("tab:"):
            return _hex_rgb(TAB10[_TAB_NAMES.index(color[4:])]), 1.0
        if len(color) == 2 and color[0] == "C" and color[1].isdigit():
            return _hex_rgb(TAB10[int(color[1])]), 1.0
        return _hex_rgb(_NAMED[color]), 1.0
    c = np.asarray(color, np.float64).reshape(-1)
    rgb = np.round(np.clip(c[:3], 0.0, 1.0) * 255).astype(np.uint8)
    return rgb, float(c[3]) if c.size > 3 else 1.0


class Colormap:
    """A lookup table of N entries: ``cmap(x)`` of values in [0, 1] gives
    (..., 3) uint8 RGB, as matplotlib's ``int(x * N)``, clipped (below 0
    the first entry, above 1 the last; NaN the first)."""

    def __init__(self, name: str, lut: np.ndarray):
        self.name = name
        self.lut = lut

    def __call__(self, x) -> np.ndarray:
        n = len(self.lut)
        x = np.nan_to_num(np.asarray(x, np.float64), nan=0.0)
        idx = np.clip(np.floor(x * n), 0, n - 1).astype(np.int64)
        return self.lut[idx]


def get_cmap(name: str) -> Colormap:
    """``plasma``, ``viridis``, ``coolwarm`` or ``tab10`` (10 entries)."""
    if name == "tab10":
        return Colormap(name, np.stack([_hex_rgb(h) for h in TAB10]))
    lut = np.frombuffer(bytes.fromhex("".join(_CMAPS[name])), np.uint8)
    return Colormap(name, lut.reshape(256, 3).copy())


class ScalarMappable:
    """What ``imshow`` and ``scatter`` return for a colorbar: the
    colormap and the values that map to its ends."""

    def __init__(self, cmap: Colormap, vmin: float, vmax: float):
        self.cmap, self.vmin, self.vmax = cmap, float(vmin), float(vmax)

    def colors(self, values) -> np.ndarray:
        span = self.vmax - self.vmin
        t = (np.asarray(values, np.float64) - self.vmin) / (
            span if span != 0 else 1.0)
        return self.cmap(t)


# -------------------------------------------------------------------- text


def _parse_font() -> np.ndarray:
    glyphs = np.zeros((95, 9, 5), bool)
    for ch, rows in _FONT.items():
        for r, bits in enumerate(rows.split()):
            glyphs[ord(ch) - 32, r] = [b == "#" for b in bits]
    return glyphs


def font_scale(size: float, dpi: float) -> int:
    """Whole-pixel scale of the 5 x 7 font for a font size in points: an
    8-pixel em per scale step."""
    return max(1, int(round(size * dpi / 72.0 / 8.0)))


def _codes(text: str) -> np.ndarray:
    """Glyph indices; characters outside printable ASCII draw as ``?``."""
    return np.array([ord(c) - 32 if 32 <= ord(c) < 127 else 31
                     for c in text] or [0])


def _rows(codes: np.ndarray) -> int:
    """9 glyph rows where a glyph descends below the baseline, else 7."""
    return 9 if _GLYPHS[codes, 7:].any() else 7


def text_mask(text: str, scale: int) -> np.ndarray:
    """The (r s, (6 n - 1) s) bool raster of ``text`` at scale s: 7 rows
    above the baseline (r = 9 with the 2 below, where a glyph descends), a
    1-pixel gap between glyphs."""
    codes = _codes(text)
    cells = np.zeros((len(codes), 9, 6), bool)
    cells[..., :5] = _GLYPHS[codes]
    strip = cells.transpose(1, 0, 2).reshape(9, -1)[:_rows(codes), :-1]
    return np.repeat(np.repeat(strip, scale, axis=0), scale, axis=1)


def text_size(text: str, size: float, dpi: float) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` drawn unrotated."""
    s = font_scale(size, dpi)
    return (6 * max(len(text), 1) - 1) * s, _rows(_codes(text)) * s


def _draw_text(canvas: np.ndarray, text: str, x: float, y: float,
               size: float, dpi: float, ha: str = "left", va: str = "top",
               rotation: int = 0, color=BLACK) -> None:
    """Draw ``text`` with its box anchored at pixel (x = column, y = row):
    ``ha`` left / center / right, ``va`` top / center / bottom;
    ``rotation`` 90 reads bottom to top."""
    if not text:
        return
    mask = text_mask(text, font_scale(size, dpi))
    if rotation == 90:
        mask = np.rot90(mask)
    h, w = mask.shape
    c0 = int(round(x - {"left": 0, "center": w / 2, "right": w}[ha]))
    r0 = int(round(y - {"top": 0, "center": h / 2, "bottom": h}[va]))
    rr, cc = np.nonzero(mask)
    _paint(canvas, rr + r0, cc + c0, color)


# ---------------------------------------------------------------- painting


def _paint(canvas: np.ndarray, rows, cols, colors, alpha: float = 1.0,
           bounds: Optional[Tuple[int, int, int, int]] = None) -> None:
    """Set pixels (rows, cols) to ``colors`` ((3,) or one row per pixel),
    the last write of a pixel winning, blended with ``alpha``; only
    inside ``bounds`` (row0, row1, col0, col1), or the canvas."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    r0, r1, c0, c1 = bounds or (0, canvas.shape[0], 0, canvas.shape[1])
    r0, c0 = max(r0, 0), max(c0, 0)
    r1, c1 = min(r1, canvas.shape[0]), min(c1, canvas.shape[1])
    keep = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    colors = np.asarray(colors, np.uint8)
    if colors.ndim == 2:
        colors = colors[keep]
    rows, cols = rows[keep], cols[keep]
    if rows.size == 0:
        return
    sel = last_writes(rows * canvas.shape[1] + cols)
    rows, cols = rows[sel], cols[sel]
    if colors.ndim == 2:
        colors = colors[sel]
    if alpha >= 1.0:
        canvas[rows, cols] = colors
        return
    under = canvas[rows, cols].astype(np.float64)
    canvas[rows, cols] = np.round(under * (1.0 - alpha)
                                  + colors.astype(np.float64) * alpha
                                  ).astype(np.uint8)


def _brush(width: int) -> np.ndarray:
    """(k, 2) pixel offsets of a square brush ``width`` pixels wide."""
    d = np.arange(-((width - 1) // 2), width // 2 + 1)
    return np.stack(np.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2)


def _disc(radius: float) -> np.ndarray:
    """(k, 2) pixel offsets within ``radius`` (at least the centre)."""
    r = int(np.ceil(radius))
    d = np.arange(-r, r + 1)
    off = np.stack(np.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2)
    return off[(off ** 2).sum(-1) <= max(radius, 0.5) ** 2]


def _draw_segments(canvas, p1, p2, colors, width: int, alpha: float,
                   bounds) -> None:
    """Segments between float pixel points (N, 2) (col, row), one colour
    each ((N, 3)) or one for all, ``width`` pixels wide, clipped to
    ``bounds``."""
    r0, r1, c0, c1 = bounds
    ok = np.isfinite(p1).all(-1) & np.isfinite(p2).all(-1)
    # far outside the canvas: clamp to a frame around it before the int
    # cast (the segment's part inside stays the same line up to a pixel)
    lim = 4.0 * max(canvas.shape)
    a = np.floor(np.clip(p1[ok], -lim, lim)).astype(np.int64)
    b = np.floor(np.clip(p2[ok], -lim, lim)).astype(np.int64)
    origin = np.array([c0, r0])
    seg, rows, cols = _segment_pixels(a - origin, b - origin, r1 - r0,
                                      c1 - c0)
    colors = np.asarray(colors, np.uint8)
    if colors.ndim == 2:
        colors = colors[ok][seg]
    brush = _brush(width)
    rows = (rows[:, None] + brush[None, :, 0]).reshape(-1) + r0
    cols = (cols[:, None] + brush[None, :, 1]).reshape(-1) + c0
    if colors.ndim == 2:
        colors = np.repeat(colors, len(brush), axis=0)
    _paint(canvas, rows, cols, colors, alpha, bounds)


def _px(points: float, dpi: float) -> float:
    return points * dpi / 72.0


def _width_px(points: float, dpi: float) -> int:
    return max(1, int(round(_px(points, dpi))))


# ------------------------------------------------------------------- ticks


def nice_ticks(lo: float, hi: float, nbins: int) -> np.ndarray:
    """Ticks inside [lo, hi] at the smallest step of 1, 2, 2.5, 5 or 10
    times a power of ten that gives at most ``nbins`` intervals
    (matplotlib's ``MaxNLocator`` steps)."""
    lo, hi = min(lo, hi), max(lo, hi)
    span = hi - lo
    if not np.isfinite(span) or span <= 0:
        return np.array([lo])
    raw = span / max(nbins, 1)
    mag = 10.0 ** np.floor(np.log10(raw))
    step = next(s * mag for s in TICK_STEPS if s * mag >= raw * (1 - 1e-9))
    first = np.ceil(lo / step - 1e-9)
    last = np.floor(hi / step + 1e-9)
    ticks = np.arange(first, last + 1) * step
    return np.where(np.abs(ticks) < step * 1e-9, 0.0, ticks)


def tick_labels(ticks: np.ndarray) -> List[str]:
    """Labels with the decimals the ticks' step needs (``%g`` for very
    large or small values)."""
    ticks = np.asarray(ticks, np.float64)
    if ticks.size == 0:
        return []
    big = float(np.abs(ticks).max())
    if big >= 1e5 or 0 < big < 1e-4:
        return [f"{t:.3g}" for t in ticks]
    step = float(np.diff(ticks).min()) if ticks.size > 1 else big or 1.0
    e = int(np.floor(np.log10(step) + 1e-9))
    decimals = max(0, -e) + (1 if round(step / 10.0 ** e, 6) == 2.5
                             and e <= 0 else 0)
    out = [f"{t:.{decimals}f}" for t in ticks]
    return ["0" if float(s) == 0 else s for s in out]


def _autoscale(lo: float, hi: float, sticky: Optional[float] = None
               ) -> Tuple[float, float]:
    """Data limits widened by ``MARGIN`` of their span on each side (not
    past ``sticky`` where the data ends there); a single value widened by
    5 % of itself (0 by 0.05), as matplotlib's ``nonsingular``."""
    if not (np.isfinite(lo) and np.isfinite(hi)):
        return 0.0, 1.0
    d = (hi - lo) * MARGIN
    a = lo if sticky is not None and lo == sticky else lo - d
    b = hi if sticky is not None and hi == sticky else hi + d
    if b - a <= 1e-12 * max(abs(a), abs(b), 1e-300):
        if a == 0 and b == 0:
            return -0.05, 0.05
        return a - 0.05 * abs(a), b + 0.05 * abs(b)
    return a, b


# -------------------------------------------------------------------- axes


class Axes:
    """One plot area of a ``Figure``; drawing calls record, ``savefig``
    rasterises."""

    def __init__(self, figure: "Figure"):
        self.figure = figure
        self.clear()

    def clear(self) -> None:
        """Forget everything drawn and set (matplotlib's ``cla``)."""
        self._artists: List[Dict] = []
        self._image: Optional[Dict] = None
        self._title = self._xlabel = self._ylabel = None
        self._yticks: Optional[np.ndarray] = None
        self._yticklabels: Optional[Tuple[List[str], float]] = None
        self._labelsize = FONT_SIZE
        self._axis_on = True
        self._legend: Optional[float] = None
        self._cycle = 0
        self._transform = None

    # ------------------------------------------------------------ drawing

    def _next_color(self) -> np.ndarray:
        rgb = _hex_rgb(TAB10[self._cycle % len(TAB10)])
        self._cycle += 1
        return rgb

    def plot(self, x, y=None, color=None, c=None, lw: float = LINE_WIDTH,
             alpha: float = 1.0, label: Optional[str] = None) -> None:
        """A polyline through (x, y); ``plot(y)`` plots against 0..n-1.
        Without a colour it takes the next of the ``tab10`` cycle."""
        if y is None:
            x, y = None, x
        y = np.asarray(y, np.float64).reshape(-1)
        x = (np.arange(y.size, dtype=np.float64) if x is None
             else np.asarray(x, np.float64).reshape(-1))
        color = color if color is not None else c
        if color is None:
            rgb = self._next_color()
        else:
            rgb, a = to_rgb(color)
            alpha = alpha * a
        self._artists.append({"kind": "line", "x": x, "y": y, "rgb": rgb,
                              "lw": lw, "alpha": alpha, "label": label})

    def segments(self, x0, y0, x1, y1, colors, lws, alpha: float = 1.0
                 ) -> None:
        """Many separate segments (x0, y0) -> (x1, y1) in one call, each
        with its own colour ((N, 3) uint8) and width (points): one ``plot``
        per segment, drawn at once."""
        self._artists.append({
            "kind": "segments",
            "p": np.stack([np.asarray(v, np.float64).reshape(-1)
                           for v in (x0, y0, x1, y1)], -1),
            "rgb": np.asarray(colors, np.uint8).reshape(-1, 3),
            "lw": np.asarray(lws, np.float64).reshape(-1), "alpha": alpha})

    def scatter(self, x, y, s: float = MARKER_AREA, c=None,
                cmap: Optional[str] = None, vmin: Optional[float] = None,
                vmax: Optional[float] = None, color=None
                ) -> Optional[ScalarMappable]:
        """Filled discs of area ``s`` points^2: one colour (``color``, or
        ``c`` a colour), or per-point values ``c`` through ``cmap``
        (``viridis``) between ``vmin`` and ``vmax`` (their min and max)."""
        x = np.asarray(x, np.float64).reshape(-1)
        y = np.asarray(y, np.float64).reshape(-1)
        c = color if c is None else c
        mappable = None
        if c is None:
            rgb = self._next_color()
        elif isinstance(c, str) or (np.ndim(c) == 1 and len(c) in (3, 4)
                                    and len(x) not in (3, 4)):
            rgb = to_rgb(c)[0]
        else:
            v = np.asarray(c, np.float64).reshape(-1)
            fin = v[np.isfinite(v)]
            lo = float(fin.min()) if vmin is None and fin.size else (
                vmin if vmin is not None else 0.0)
            hi = float(fin.max()) if vmax is None and fin.size else (
                vmax if vmax is not None else 1.0)
            mappable = ScalarMappable(get_cmap(cmap or "viridis"), lo, hi)
            rgb = mappable.colors(v)
        self._artists.append({"kind": "scatter", "x": x, "y": y, "s": s,
                              "rgb": rgb})
        return mappable

    def hist(self, values, bins: int = 20, color=None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Bars of ``np.histogram(values, bins)``; returns (counts,
        edges)."""
        v = np.asarray(values, np.float64).reshape(-1)
        counts, edges = np.histogram(v[np.isfinite(v)], bins=bins)
        rgb = self._next_color() if color is None else to_rgb(color)[0]
        self._artists.append({"kind": "bars", "edges": edges,
                              "counts": counts.astype(np.float64),
                              "rgb": rgb})
        return counts, edges

    def imshow(self, image, cmap: Optional[str] = None,
               vmin: Optional[float] = None, vmax: Optional[float] = None
               ) -> ScalarMappable:
        """An (h, w, 3) RGB image (floats in [0, 1] or uint8) or an (h, w)
        array through ``cmap`` (``viridis``; ``vmin`` / ``vmax`` default
        to its min / max), pixel centres at integer coordinates, row 0 at
        the top, square pixels, nearest sampling."""
        img = np.asarray(image)
        cm = get_cmap(cmap or "viridis")
        if img.ndim == 2:
            v = img.astype(np.float64)
            fin = v[np.isfinite(v)]
            lo = vmin if vmin is not None else (
                float(fin.min()) if fin.size else 0.0)
            hi = vmax if vmax is not None else (
                float(fin.max()) if fin.size else 1.0)
            mappable = ScalarMappable(cm, lo, hi)
            rgb = mappable.colors(v)
        else:
            mappable = ScalarMappable(cm, 0.0, 1.0)
            rgb = img[..., :3]
            if rgb.dtype != np.uint8:
                rgb = (np.clip(rgb.astype(np.float64), 0, 1) * 255).astype(
                    np.uint8)
        self._image = {"rgb": rgb}
        return mappable

    def add_polygon(self, xy, edgecolor="C0", lw: float = LINE_WIDTH
                    ) -> None:
        """Closed outlines of (V, 2) or (N, V, 2) (x, y) vertices."""
        xy = np.asarray(xy, np.float64)
        xy = xy.reshape((-1,) + xy.shape[-2:])
        self._artists.append({"kind": "polygons", "xy": xy,
                              "rgb": to_rgb(edgecolor)[0], "lw": lw})

    def axvline(self, x: float, color="C0", lw: float = LINE_WIDTH) -> None:
        """A vertical line at data ``x`` across the axes."""
        self._artists.append({"kind": "vline", "x": float(x),
                              "rgb": to_rgb(color)[0], "lw": lw})

    # ------------------------------------------------------------- labels

    def set_title(self, text: str, fontsize: float = TITLE_SIZE) -> None:
        self._title = (str(text), fontsize)

    def set_xlabel(self, text: str, fontsize: float = FONT_SIZE) -> None:
        self._xlabel = (str(text), fontsize)

    def set_ylabel(self, text: str, fontsize: float = FONT_SIZE) -> None:
        self._ylabel = (str(text), fontsize)

    def set_yticks(self, ticks) -> None:
        self._yticks = np.asarray(list(ticks), np.float64)

    def set_yticklabels(self, labels: Sequence[str],
                        fontsize: Optional[float] = None) -> None:
        self._yticklabels = ([str(s) for s in labels], fontsize)

    def tick_params(self, labelsize: Optional[float] = None) -> None:
        if labelsize is not None:
            self._labelsize = labelsize

    def legend(self, fontsize: float = FONT_SIZE) -> None:
        """A legend of the labelled lines, at the upper right."""
        self._legend = fontsize

    def axis(self, mode: str) -> None:
        """``"off"``: no spines, ticks, tick labels or axis labels."""
        self._axis_on = mode != "off"

    # -------------------------------------------------------- geometry

    def _limits(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        """(xlim, ylim), ylim[0] at the bottom."""
        if self._image is not None:
            h, w = self._image["rgb"].shape[:2]
            return (-0.5, w - 0.5), (h - 0.5, -0.5)
        xs, ys, sticky = [], [], None
        for a in self._artists:
            if a["kind"] in ("line", "scatter"):
                xs.append(a["x"])
                ys.append(a["y"])
            elif a["kind"] == "segments":
                xs.append(a["p"][:, [0, 2]].reshape(-1))
                ys.append(a["p"][:, [1, 3]].reshape(-1))
            elif a["kind"] == "bars":
                xs.append(a["edges"])
                ys.append(np.concatenate([[0.0], a["counts"]]))
                sticky = 0.0
            elif a["kind"] == "polygons":
                xs.append(a["xy"][..., 0].reshape(-1))
                ys.append(a["xy"][..., 1].reshape(-1))
            elif a["kind"] == "vline":
                xs.append(np.array([a["x"]]))
        return (self._span(xs, None), self._span(ys, sticky))

    @staticmethod
    def _span(parts, sticky) -> Tuple[float, float]:
        v = np.concatenate(parts) if parts else np.zeros(0)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return 0.0, 1.0
        return _autoscale(float(v.min()), float(v.max()), sticky)

    def _ticks(self, lim, length: float, dpi: float, axis: str):
        """(positions, labels, label size) of one axis."""
        if axis == "y" and self._yticks is not None:
            pos = self._yticks
            if self._yticklabels is not None:
                labels, size = self._yticklabels
                return pos, list(labels), size or self._labelsize
            return pos, tick_labels(pos), self._labelsize
        per = _px(self._labelsize, dpi) * (3.0 if axis == "x" else 2.0)
        nbins = int(max(1, min(9, np.floor(length / per))))
        pos = nice_ticks(lim[0], lim[1], nbins)
        return pos, tick_labels(pos), self._labelsize

    def _box_aspect(self, box, lims):
        """An image's box shrunk to square pixels, centred."""
        x0, y0, x1, y1 = box
        if self._image is None:
            return box
        (xa, xb), (ya, yb) = lims
        want = abs(yb - ya) / abs(xb - xa)
        w, h = x1 - x0, y1 - y0
        if h / w > want:
            nh = w * want
            return x0, y0 + (h - nh) / 2, x1, y0 + (h + nh) / 2
        nw = h / want
        return x0 + (w - nw) / 2, y0, x0 + (w + nw) / 2, y1

    def _data_to_px(self, x, y):
        x0, y0, x1, y1, (xa, xb), (ya, yb) = self._transform
        col = x0 + (np.asarray(x, np.float64) - xa) / (xb - xa) * (x1 - x0)
        row = y1 - (np.asarray(y, np.float64) - ya) / (yb - ya) * (y1 - y0)
        return col, row

    def to_pixel(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the pixels holding data points (x, y) in the
        figure's last ``savefig`` or ``render``."""
        if self._transform is None:
            raise RuntimeError("to_pixel needs a rendered figure")
        col, row = self._data_to_px(x, y)
        return (np.floor(row).astype(np.int64),
                np.floor(col).astype(np.int64))

    def _decorations(self, box, dpi: float) -> Tuple[float, ...]:
        """(left, bottom, top, right) pixels that the labels, ticks, title
        and colorbar take outside the box."""
        left = bottom = right = 0.0
        top = 0.0
        if self._title is not None:
            top = _px(TITLE_PAD, dpi) + text_size(self._title[0],
                                                  self._title[1], dpi)[1]
        if self._axis_on:
            xlim, ylim = self._limits()
            x0, y0, x1, y1 = box
            tick = _px(TICK_LEN + TICK_PAD, dpi)
            _, ylabels, ysize = self._ticks(ylim, y1 - y0, dpi, "y")
            _, xlabels, xsize = self._ticks(xlim, x1 - x0, dpi, "x")
            left = tick + max([text_size(s, ysize, dpi)[0] for s in ylabels]
                              or [0])
            bottom = tick + text_size("0", xsize, dpi)[1]
            if xlabels:
                right = text_size(xlabels[-1], xsize, dpi)[0] / 2
            if self._ylabel is not None:
                left += _px(LABEL_PAD, dpi) + text_size(
                    self._ylabel[0], self._ylabel[1], dpi)[1]
            if self._xlabel is not None:
                bottom += _px(LABEL_PAD, dpi) + text_size(
                    self._xlabel[0], self._xlabel[1], dpi)[1]
        cbar = self.figure._colorbars.get(id(self))
        if cbar is not None:
            mappable, label = cbar
            pos = nice_ticks(mappable.vmin, mappable.vmax, 9)
            right = _px(TICK_LEN + TICK_PAD, dpi) + max(
                text_size(s, self._labelsize, dpi)[0]
                for s in tick_labels(pos))
            if label:
                right += _px(LABEL_PAD, dpi) + text_size(label, FONT_SIZE,
                                                         dpi)[1]
        return left, bottom, top, right

    # ------------------------------------------------------------- render

    def _draw(self, canvas: np.ndarray, box, dpi: float) -> None:
        cbar = self.figure._colorbars.get(id(self))
        if cbar is not None:
            x0, y0, x1, y1 = box
            w = x1 - x0
            bar_w = min(CBAR_FRACTION * w, (y1 - y0) / CBAR_ASPECT)
            bar_x0 = x0 + (1.0 - CBAR_FRACTION) * w
            box = (x0, y0, x0 + (1.0 - CBAR_FRACTION - CBAR_PAD) * w, y1)
            bar_box = (bar_x0, y0, bar_x0 + bar_w, y1)
        lims = self._limits()
        box = self._box_aspect(box, lims)
        self._transform = tuple(box) + lims
        x0, y0, x1, y1 = box
        bounds = (int(np.floor(y0)), int(np.ceil(y1)), int(np.floor(x0)),
                  int(np.ceil(x1)))
        if self._image is not None:
            self._draw_image(canvas, bounds)
        for a in self._artists:
            getattr(self, "_draw_" + a["kind"])(canvas, a, bounds, dpi)
        if self._axis_on:
            self._draw_frame(canvas, box, lims, dpi)
        if self._title is not None:
            _draw_text(canvas, self._title[0], (x0 + x1) / 2,
                       y0 - _px(TITLE_PAD, dpi), self._title[1], dpi,
                       ha="center", va="bottom")
        if self._legend is not None:
            self._draw_legend(canvas, box, dpi)
        if cbar is not None:
            _draw_colorbar(canvas, bar_box, cbar[0], cbar[1],
                           self._labelsize, dpi)

    def _draw_image(self, canvas, bounds) -> None:
        rgb = self._image["rgb"]
        h, w = rgb.shape[:2]
        r0, r1, c0, c1 = bounds
        rows = np.arange(max(r0, 0), min(r1, canvas.shape[0]))
        cols = np.arange(max(c0, 0), min(c1, canvas.shape[1]))
        # the data coordinates of the pixel centres, nearest sample
        x, _ = self._data_to_px_inverse(cols + 0.5, None)
        _, y = self._data_to_px_inverse(None, rows + 0.5)
        j = np.floor(x + 0.5).astype(np.int64)
        i = np.floor(y + 0.5).astype(np.int64)
        ok_c, ok_r = (j >= 0) & (j < w), (i >= 0) & (i < h)
        canvas[np.ix_(rows[ok_r], cols[ok_c])] = rgb[np.ix_(i[ok_r],
                                                            j[ok_c])]

    def _data_to_px_inverse(self, col, row):
        x0, y0, x1, y1, (xa, xb), (ya, yb) = self._transform
        x = None if col is None else xa + (col - x0) / (x1 - x0) * (xb - xa)
        y = None if row is None else ya + (y1 - row) / (y1 - y0) * (yb - ya)
        return x, y

    def _draw_line(self, canvas, a, bounds, dpi) -> None:
        col, row = self._data_to_px(a["x"], a["y"])
        p = np.stack([col, row], -1)
        if len(p) == 1:
            p = np.concatenate([p, p])
        _draw_segments(canvas, p[:-1], p[1:], a["rgb"],
                       _width_px(a["lw"], dpi), a["alpha"], bounds)

    def _draw_segments(self, canvas, a, bounds, dpi) -> None:
        c0, r0 = self._data_to_px(a["p"][:, 0], a["p"][:, 1])
        c1, r1 = self._data_to_px(a["p"][:, 2], a["p"][:, 3])
        widths = np.maximum(1, np.round(_px(a["lw"], dpi))).astype(int)
        for w in np.unique(widths):
            s = widths == w
            _draw_segments(canvas, np.stack([c0[s], r0[s]], -1),
                           np.stack([c1[s], r1[s]], -1), a["rgb"][s],
                           int(w), a["alpha"], bounds)

    def _draw_scatter(self, canvas, a, bounds, dpi) -> None:
        col, row = self._data_to_px(a["x"], a["y"])
        ok = np.isfinite(col) & np.isfinite(row)
        disc = _disc(np.sqrt(a["s"]) / 2 * dpi / 72.0)
        rows = (np.floor(row[ok])[:, None] + disc[None, :, 0]).reshape(-1)
        cols = (np.floor(col[ok])[:, None] + disc[None, :, 1]).reshape(-1)
        rgb = a["rgb"]
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[ok], len(disc), axis=0)
        _paint(canvas, rows, cols, rgb, 1.0, bounds)

    def _draw_bars(self, canvas, a, bounds, dpi) -> None:
        e, n = a["edges"], a["counts"]
        c_lo, r_lo = self._data_to_px(e[:-1], np.zeros_like(n))
        c_hi, r_hi = self._data_to_px(e[1:], n)
        r0, r1, c0, c1 = bounds
        for k in range(len(n)):  # one rectangle per bin (20)
            rs = slice(max(int(np.floor(r_hi[k])), r0, 0),
                       min(int(np.floor(r_lo[k])), r1))
            cs = slice(max(int(np.floor(c_lo[k])), c0, 0),
                       min(int(np.floor(c_hi[k])), c1))
            canvas[rs, cs] = a["rgb"]

    def _draw_polygons(self, canvas, a, bounds, dpi) -> None:
        xy = a["xy"]
        col, row = self._data_to_px(xy[..., 0], xy[..., 1])
        p = np.stack([col, row], -1)
        starts = np.concatenate([p[:, -1:], p[:, :-1]], axis=1)
        _draw_segments(canvas, starts.reshape(-1, 2), p.reshape(-1, 2),
                       a["rgb"], _width_px(a["lw"], dpi), 1.0, bounds)

    def _draw_vline(self, canvas, a, bounds, dpi) -> None:
        x0, y0, x1, y1 = self._transform[:4]
        col, _ = self._data_to_px(a["x"], 0.0)
        _draw_segments(canvas, np.array([[col, y0]]),
                       np.array([[col, y1 - 1e-9]]), a["rgb"],
                       _width_px(a["lw"], dpi), 1.0, bounds)

    def _draw_frame(self, canvas, box, lims, dpi) -> None:
        """Spines, ticks outward, tick labels and the axis labels."""
        x0, y0, x1, y1 = box
        sw = _width_px(SPINE_WIDTH, dpi)
        ca, cb = int(np.floor(x0)), int(np.floor(x1))
        ra, rb = int(np.floor(y0)), int(np.floor(y1))
        for rs, cs in ((slice(ra, ra + sw), slice(ca, cb + sw)),
                       (slice(rb, rb + sw), slice(ca, cb + sw)),
                       (slice(ra, rb + sw), slice(ca, ca + sw)),
                       (slice(ra, rb + sw), slice(cb, cb + sw))):
            canvas[max(rs.start, 0):max(rs.stop, 0),
                   max(cs.start, 0):max(cs.stop, 0)] = BLACK
        tick = int(round(_px(TICK_LEN, dpi)))
        pad = _px(TICK_PAD, dpi)
        xlim, ylim = lims
        pos, labels, size = self._ticks(xlim, x1 - x0, dpi, "x")
        cols, _ = self._data_to_px(pos, 0.0)
        for c, s in zip(cols, labels):
            if not (x0 - 0.5 <= c <= x1 + 0.5):
                continue
            c = int(np.floor(c))
            canvas[max(rb, 0):max(rb + sw + tick, 0),
                   max(c, 0):max(c + sw, 0)] = BLACK
            _draw_text(canvas, s, c, rb + sw + tick + pad, size, dpi,
                       ha="center", va="top")
        label_h = text_size("0", size, dpi)[1]
        if self._xlabel is not None:
            _draw_text(canvas, self._xlabel[0], (x0 + x1) / 2,
                       rb + sw + tick + pad + label_h + _px(LABEL_PAD, dpi),
                       self._xlabel[1], dpi, ha="center", va="top")
        pos, labels, size = self._ticks(ylim, y1 - y0, dpi, "y")
        _, rows = self._data_to_px(0.0, pos)
        widest = 0
        for r, s in zip(np.broadcast_to(rows, np.shape(pos)), labels):
            if not (y0 - 0.5 <= r <= y1 + 0.5):
                continue
            r = int(np.floor(r))
            canvas[max(r, 0):max(r + sw, 0),
                   max(ca - tick, 0):max(ca, 0)] = BLACK
            _draw_text(canvas, s, ca - tick - pad, r, size, dpi,
                       ha="right", va="center")
            widest = max(widest, text_size(s, size, dpi)[0])
        if self._ylabel is not None:
            _draw_text(canvas, self._ylabel[0],
                       ca - tick - pad - widest - _px(LABEL_PAD, dpi),
                       (y0 + y1) / 2, self._ylabel[1], dpi, ha="right",
                       va="center", rotation=90)

    def _draw_legend(self, canvas, box, dpi) -> None:
        entries = [(a["label"], a["rgb"], a["lw"]) for a in self._artists
                   if a["kind"] == "line" and a.get("label")]
        if not entries:
            return
        size = self._legend
        em = _px(size, dpi)
        tw = max(text_size(s, size, dpi)[0] for s, _, _ in entries)
        th = text_size("0", size, dpi)[1]
        pad = 0.4 * em
        handle = 2.0 * em
        width = pad + handle + 0.8 * em + tw + pad
        height = pad + len(entries) * (th + 0.5 * em) - 0.5 * em + pad
        x0, y0, x1, y1 = box
        left, top = int(x1 - 0.5 * em - width), int(y0 + 0.5 * em)
        right, bottom = int(left + width), int(top + height)
        canvas[max(top, 0):max(bottom, 0), max(left, 0):max(right, 0)] = \
            WHITE
        grey = np.array([204, 204, 204], np.uint8)
        for rs, cs in ((slice(top, top + 1), slice(left, right)),
                       (slice(bottom - 1, bottom), slice(left, right)),
                       (slice(top, bottom), slice(left, left + 1)),
                       (slice(top, bottom), slice(right - 1, right))):
            canvas[max(rs.start, 0):max(rs.stop, 0),
                   max(cs.start, 0):max(cs.stop, 0)] = grey
        for k, (label, rgb, lw) in enumerate(entries):
            mid = top + pad + k * (th + 0.5 * em) + th / 2
            _draw_segments(canvas, np.array([[left + pad, mid]]),
                           np.array([[left + pad + handle, mid]]), rgb,
                           _width_px(lw, dpi), 1.0,
                           (0, canvas.shape[0], 0, canvas.shape[1]))
            _draw_text(canvas, label, left + pad + handle + 0.8 * em, mid,
                       size, dpi, ha="left", va="center")


def _draw_colorbar(canvas, box, mappable: ScalarMappable,
                   label: Optional[str], labelsize: float, dpi: float
                   ) -> None:
    """The bar (vmin at the bottom), its frame, ticks and labels on the
    right, and ``label`` rotated beside them."""
    x0, y0, x1, y1 = box
    ca, cb = int(np.floor(x0)), int(np.floor(x1))
    ra, rb = int(np.floor(y0)), int(np.floor(y1))
    rows = np.arange(max(ra, 0), min(rb, canvas.shape[0]))
    t = (y1 - (rows + 0.5)) / (y1 - y0)
    canvas[max(ra, 0):max(ra, 0) + len(rows), max(ca, 0):max(cb, 0)] = \
        mappable.cmap(t)[:, None, :]
    sw = _width_px(SPINE_WIDTH, dpi)
    for rs, cs in ((slice(ra, ra + sw), slice(ca, cb + sw)),
                   (slice(rb, rb + sw), slice(ca, cb + sw)),
                   (slice(ra, rb + sw), slice(ca, ca + sw)),
                   (slice(ra, rb + sw), slice(cb, cb + sw))):
        canvas[max(rs.start, 0):max(rs.stop, 0),
               max(cs.start, 0):max(cs.stop, 0)] = BLACK
    tick = int(round(_px(TICK_LEN, dpi)))
    pad = _px(TICK_PAD, dpi)
    span = mappable.vmax - mappable.vmin
    nbins = int(max(1, min(9, np.floor((y1 - y0)
                                       / (2 * _px(labelsize, dpi))))))
    pos = nice_ticks(mappable.vmin, mappable.vmax, nbins)
    widest = 0
    for v, s in zip(pos, tick_labels(pos)):
        frac = (v - mappable.vmin) / (span if span != 0 else 1.0)
        if not -1e-9 <= frac <= 1 + 1e-9:
            continue
        r = int(np.floor(y1 - frac * (y1 - y0)))
        canvas[max(r, 0):max(r + sw, 0),
               max(cb + sw, 0):max(cb + sw + tick, 0)] = BLACK
        _draw_text(canvas, s, cb + sw + tick + pad, r, labelsize, dpi,
                   ha="left", va="center")
        widest = max(widest, text_size(s, labelsize, dpi)[0])
    if label:
        _draw_text(canvas, label,
                   cb + sw + tick + pad + widest + _px(LABEL_PAD, dpi),
                   (y0 + y1) / 2, FONT_SIZE, dpi, ha="left", va="center",
                   rotation=90)


# ------------------------------------------------------------------ figure


class Figure:
    """A canvas of ``figsize`` inches at ``dpi``, a grid of ``Axes``."""

    def __init__(self, figsize=FIGSIZE, dpi: float = DPI):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self._grid: Optional[np.ndarray] = None
        self._tight = False
        self._colorbars: Dict[int, Tuple[ScalarMappable, Optional[str]]] = {}

    def subplots(self, nrows: int = 1, ncols: int = 1,
                 squeeze: bool = True):
        """The (nrows, ncols) grid of axes, squeezed as matplotlib's:
        one ``Axes``, a 1-D array for one row or column, else 2-D."""
        self._grid = np.empty((nrows, ncols), object)
        for i in range(nrows):
            for j in range(ncols):
                self._grid[i, j] = Axes(self)
        if not squeeze:
            return self._grid
        if nrows == ncols == 1:
            return self._grid[0, 0]
        return self._grid.reshape(-1) if 1 in (nrows, ncols) else self._grid

    def gca(self) -> Axes:
        """The first axes (one is made if the figure has none)."""
        if self._grid is None:
            self.subplots()
        return self._grid[0, 0]

    @property
    def axes(self) -> List[Axes]:
        return [] if self._grid is None else list(self._grid.reshape(-1))

    def colorbar(self, mappable: ScalarMappable, ax: Axes,
                 label: Optional[str] = None) -> None:
        """A vertical colorbar of ``mappable`` taking the right of
        ``ax``'s box (15 % of it, after a 5 % gap)."""
        self._colorbars[id(ax)] = (mappable, label)

    def tight_layout(self) -> None:
        """Size the grid to its labels at ``savefig``."""
        self._tight = True

    def canvas_size(self, dpi: Optional[float] = None) -> Tuple[int, int]:
        """(height, width) in pixels: matplotlib's ``int(size * dpi)``."""
        dpi = float(dpi or self.dpi)
        return int(self.figsize[1] * dpi), int(self.figsize[0] * dpi)

    def _boxes(self, dpi: float) -> List[Tuple[float, float, float, float]]:
        """Each axes' (x0, y0, x1, y1) in pixels, rows from the top:
        matplotlib's default subplot parameters, or with ``tight_layout``
        margins and gaps sized to the largest labels of each side."""
        wf, hf = self.figsize[0] * dpi, self.figsize[1] * dpi
        nr, nc = self._grid.shape
        p = SUBPLOT_PARS
        cell_w = (p["right"] - p["left"]) * wf / (nc + p["wspace"] * (nc - 1))
        cell_h = (p["top"] - p["bottom"]) * hf / (nr + p["hspace"]
                                                  * (nr - 1))
        left, top = p["left"] * wf, (1.0 - p["top"]) * hf
        gap_w, gap_h = p["wspace"] * cell_w, p["hspace"] * cell_h
        if self._tight:
            boxes = self._grid_boxes(left, top, cell_w, cell_h, gap_w, gap_h)
            dec = np.array([[ax._decorations(boxes[i * nc + j], dpi)
                             for j, ax in enumerate(row)]
                            for i, row in enumerate(self._grid)])
            pad = _px(TIGHT_PAD * FONT_SIZE, dpi)
            L, B, T, R = (dec[..., k] for k in range(4))
            left = pad + L[:, 0].max()
            top = pad + T[0].max()
            right = pad + R[:, -1].max()
            bottom = pad + B[-1].max()
            gap_w = max([R[:, j].max() + L[:, j + 1].max() + pad
                         for j in range(nc - 1)] or [0.0])
            gap_h = max([B[i].max() + T[i + 1].max() + pad
                         for i in range(nr - 1)] or [0.0])
            cell_w = max((wf - left - right - gap_w * (nc - 1)) / nc, 1.0)
            cell_h = max((hf - top - bottom - gap_h * (nr - 1)) / nr, 1.0)
        return self._grid_boxes(left, top, cell_w, cell_h, gap_w, gap_h)

    def _grid_boxes(self, left, top, cell_w, cell_h, gap_w, gap_h):
        nr, nc = self._grid.shape
        return [(left + j * (cell_w + gap_w), top + i * (cell_h + gap_h),
                 left + j * (cell_w + gap_w) + cell_w,
                 top + i * (cell_h + gap_h) + cell_h)
                for i in range(nr) for j in range(nc)]

    def render(self, dpi: Optional[float] = None) -> np.ndarray:
        """The (H, W, 4) uint8 RGBA raster (opaque, white ground)."""
        dpi = float(dpi or self.dpi)
        h, w = self.canvas_size(dpi)
        canvas = np.full((h, w, 3), 255, np.uint8)
        if self._grid is not None:
            for ax, box in zip(self.axes, self._boxes(dpi)):
                ax._draw(canvas, box, dpi)
        return np.concatenate([canvas, np.full((h, w, 1), 255, np.uint8)],
                              axis=-1)

    def savefig(self, path: str, dpi: Optional[float] = None) -> None:
        """Render at ``dpi`` (the figure's) and write an RGBA PNG."""
        write_png(path, self.render(dpi))


def figure(figsize=FIGSIZE, dpi: float = DPI) -> Figure:
    """A figure (``plt.figure``); ``gca()`` gives its one axes."""
    return Figure(figsize, dpi)


def subplots(nrows: int = 1, ncols: int = 1, figsize=FIGSIZE,
             dpi: float = DPI, squeeze: bool = True):
    """(figure, axes) as ``plt.subplots``."""
    fig = Figure(figsize, dpi)
    return fig, fig.subplots(nrows, ncols, squeeze=squeeze)


# -------------------------------------------------------------------- data

# 5 x 7 glyphs of printable ASCII (rows top to bottom, "#" set), with two
# rows below the baseline for descenders
_FONT = {
    " ": "..... ..... ..... ..... ..... ..... .....",
    "!": "..#.. ..#.. ..#.. ..#.. ..#.. ..... ..#..",
    '"': ".#.#. .#.#. ..... ..... ..... ..... .....",
    "#": ".#.#. .#.#. ##### .#.#. ##### .#.#. .#.#.",
    "$": "..#.. .#### #.#.. .###. ..#.# ####. ..#..",
    "%": "##... ##..# ...#. ..#.. .#... #..## ...##",
    "&": ".##.. #..#. #.#.. .#... #.#.# #..#. .##.#",
    "'": "..#.. ..#.. ..... ..... ..... ..... .....",
    "(": "...#. ..#.. .#... .#... .#... ..#.. ...#.",
    ")": ".#... ..#.. ...#. ...#. ...#. ..#.. .#...",
    "*": "..... ..#.. #.#.# .###. #.#.# ..#.. .....",
    "+": "..... ..#.. ..#.. ##### ..#.. ..#.. .....",
    ",": "..... ..... ..... ..... ..... ..#.. ..#.. .#...",
    "-": "..... ..... ..... ##### ..... ..... .....",
    ".": "..... ..... ..... ..... ..... .##.. .##..",
    "/": "..... ....# ...#. ..#.. .#... #.... .....",
    "0": ".###. #...# #..## #.#.# ##..# #...# .###.",
    "1": "..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.",
    "2": ".###. #...# ....# ...#. ..#.. .#... #####",
    "3": "##### ...#. ..#.. ...#. ....# #...# .###.",
    "4": "...#. ..##. .#.#. #..#. ##### ...#. ...#.",
    "5": "##### #.... ####. ....# ....# #...# .###.",
    "6": "..##. .#... #.... ####. #...# #...# .###.",
    "7": "##### ....# ...#. ..#.. .#... .#... .#...",
    "8": ".###. #...# #...# .###. #...# #...# .###.",
    "9": ".###. #...# #...# .#### ....# ...#. .##..",
    ":": "..... .##.. .##.. ..... .##.. .##.. .....",
    ";": "..... .##.. .##.. ..... .##.. .##.. ..#.. .#...",
    "<": "...#. ..#.. .#... #.... .#... ..#.. ...#.",
    "=": "..... ..... ##### ..... ##### ..... .....",
    ">": ".#... ..#.. ...#. ....# ...#. ..#.. .#...",
    "?": ".###. #...# ....# ...#. ..#.. ..... ..#..",
    "@": ".###. #...# ....# .##.# #.#.# #.#.# .###.",
    "A": ".###. #...# #...# ##### #...# #...# #...#",
    "B": "####. #...# #...# ####. #...# #...# ####.",
    "C": ".###. #...# #.... #.... #.... #...# .###.",
    "D": "###.. #..#. #...# #...# #...# #..#. ###..",
    "E": "##### #.... #.... ####. #.... #.... #####",
    "F": "##### #.... #.... ####. #.... #.... #....",
    "G": ".###. #...# #.... #.### #...# #...# .####",
    "H": "#...# #...# #...# ##### #...# #...# #...#",
    "I": ".###. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "J": "..### ...#. ...#. ...#. ...#. #..#. .##..",
    "K": "#...# #..#. #.#.. ##... #.#.. #..#. #...#",
    "L": "#.... #.... #.... #.... #.... #.... #####",
    "M": "#...# ##.## #.#.# #.#.# #...# #...# #...#",
    "N": "#...# #...# ##..# #.#.# #..## #...# #...#",
    "O": ".###. #...# #...# #...# #...# #...# .###.",
    "P": "####. #...# #...# ####. #.... #.... #....",
    "Q": ".###. #...# #...# #...# #.#.# #..#. .##.#",
    "R": "####. #...# #...# ####. #.#.. #..#. #...#",
    "S": ".#### #.... #.... .###. ....# ....# ####.",
    "T": "##### ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "U": "#...# #...# #...# #...# #...# #...# .###.",
    "V": "#...# #...# #...# #...# #...# .#.#. ..#..",
    "W": "#...# #...# #...# #.#.# #.#.# #.#.# .#.#.",
    "X": "#...# #...# .#.#. ..#.. .#.#. #...# #...#",
    "Y": "#...# #...# .#.#. ..#.. ..#.. ..#.. ..#..",
    "Z": "##### ....# ...#. ..#.. .#... #.... #####",
    "[": ".###. .#... .#... .#... .#... .#... .###.",
    "\\": "..... #.... .#... ..#.. ...#. ....# .....",
    "]": ".###. ...#. ...#. ...#. ...#. ...#. .###.",
    "^": "..#.. .#.#. #...# ..... ..... ..... .....",
    "_": "..... ..... ..... ..... ..... ..... ..... #####",
    "`": ".#... ..#.. ..... ..... ..... ..... .....",
    "a": "..... ..... .###. ....# .#### #...# .####",
    "b": "#.... #.... #.##. ##..# #...# #...# ####.",
    "c": "..... ..... .###. #.... #.... #...# .###.",
    "d": "....# ....# .##.# #..## #...# #...# .####",
    "e": "..... ..... .###. #...# ##### #.... .###.",
    "f": "..##. .#..# .#... ###.. .#... .#... .#...",
    "g": "..... ..... .#### #...# #...# #...# .#### ....# .###.",
    "h": "#.... #.... #.##. ##..# #...# #...# #...#",
    "i": "..#.. ..... .##.. ..#.. ..#.. ..#.. .###.",
    "j": "...#. ..... ..##. ...#. ...#. ...#. ...#. #..#. .##..",
    "k": "#.... #.... #..#. #.#.. ##... #.#.. #..#.",
    "l": ".##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "m": "..... ..... ##.#. #.#.# #.#.# #...# #...#",
    "n": "..... ..... #.##. ##..# #...# #...# #...#",
    "o": "..... ..... .###. #...# #...# #...# .###.",
    "p": "..... ..... ####. #...# #...# #...# ####. #.... #....",
    "q": "..... ..... .#### #...# #...# #...# .#### ....# ....#",
    "r": "..... ..... #.##. ##..# #.... #.... #....",
    "s": "..... ..... .###. #.... .###. ....# ####.",
    "t": ".#... .#... ###.. .#... .#... .#..# ..##.",
    "u": "..... ..... #...# #...# #...# #..## .##.#",
    "v": "..... ..... #...# #...# #...# .#.#. ..#..",
    "w": "..... ..... #...# #...# #.#.# #.#.# .#.#.",
    "x": "..... ..... #...# .#.#. ..#.. .#.#. #...#",
    "y": "..... ..... #...# #...# #...# #...# .#### ....# .###.",
    "z": "..... ..... ##### ...#. ..#.. .#... #####",
    "{": "...#. ..#.. ..#.. .#... ..#.. ..#.. ...#.",
    "|": "..#.. ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "}": ".#... ..#.. ..#.. ...#. ..#.. ..#.. .#...",
    "~": "..... ..... .#... #.#.# ...#. ..... .....",
}

# matplotlib's colormaps, 256 RGB entries each (round(255 x))
_CMAPS = {
    "plasma": (
        "0d088710078813078916078a19068c1b068d1d068e20068f220690240691260591280592"
        "2a05932c05942e05952f059631059733059735049837049938049a3a049a3c049b3e049c"
        "3f049c41049d43039e44039e46039f48039f4903a04b03a14c02a14e02a25002a25102a3"
        "5302a35502a45601a45801a45901a55b01a55c01a65e01a66001a66100a76300a76400a7"
        "6600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501a87701a8"
        "7801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a6"
        "8a09a58b0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f"
        "9a169f9c179e9d189d9e199da01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296"
        "aa2395ab2494ac2694ad2793ae2892b02991b12a90b22b8fb32c8eb42e8db52f8cb6308b"
        "b7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c13b82c23c81c33d80"
        "c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
        "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586a"
        "da5a6ada5b69db5c68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660"
        "e3685fe4695ee56a5de56b5de66c5ce76e5be76f5ae87059e97158e97257ea7457eb7556"
        "eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4ff0804ef1814df1834cf2844b"
        "f3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f79342f89441"
        "f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537"
        "fca636fca835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72d"
        "feb82cfeba2cfebb2bfebd2afebe2afec029fdc229fdc328fdc527fdc627fdc827fdca26"
        "fdcb26fccd25fcce25fcd025fcd225fbd324fbd524fbd724fad824fada24f9dc24f9dd25"
        "f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3ee27f3f027f2f227"
        "f1f426f1f525f0f724f0f921"),
    "viridis": (
        "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
        "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
        "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
        "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
        "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
        "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
        "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
        "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
        "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
        "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
        "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
        "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
        "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
        "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
        "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
        "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
        "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
        "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
        "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
        "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
        "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
        "f6e620f8e621fbe723fde725"),
    "coolwarm": (
        "3b4cc03c4ec23d50c33e51c53f53c64055c84257c94358cb445acc455cce465ecf485fd1"
        "4961d24a63d34b64d54c66d64e68d84f69d9506bda516ddb536edd5470de5572df5673e0"
        "5875e15977e35a78e45b7ae55d7ce65e7de75f7fe86180e96282ea6384eb6485ec6687ed"
        "6788ee688aef6a8bef6b8df06c8ff16e90f26f92f37093f37295f47396f57597f67699f6"
        "779af7799cf87a9df87b9ff97da0f97ea1fa80a3fa81a4fb82a6fb84a7fc85a8fc86a9fc"
        "88abfd89acfd8badfd8caffe8db0fe8fb1fe90b2fe92b4fe93b5fe94b6ff96b7ff97b8ff"
        "98b9ff9abbff9bbcff9dbdff9ebeff9fbfffa1c0ffa2c1ffa3c2fea5c3fea6c4fea7c5fe"
        "a9c6fdaac7fdabc8fdadc9fdaec9fcafcafcb1cbfcb2ccfbb3cdfbb5cdfab6cefab7cff9"
        "b9d0f9bad0f8bbd1f8bcd2f7bed2f6bfd3f6c0d4f5c1d4f4c3d5f4c4d5f3c5d6f2c6d6f1"
        "c7d7f0c9d7f0cad8efcbd8eeccd9edcdd9eccedaebcfdaead1dae9d2dbe8d3dbe7d4dbe6"
        "d5dbe5d6dce4d7dce3d8dce2d9dce1dadce0dbdcdedcdddddddcdcdedcdbdfdbd9e0dbd8"
        "e1dad6e2dad5e3d9d3e4d9d2e5d8d1e6d7cfe7d7cee8d6cce9d5cbead5c9ead4c8ebd3c6"
        "ecd3c5edd2c3edd1c2eed0c0efcfbfefcebdf0cdbbf1cdbaf1ccb8f2cbb7f2cab5f2c9b4"
        "f3c8b2f3c7b1f4c6aff4c5adf5c4acf5c2aaf5c1a9f5c0a7f6bfa6f6bea4f6bda2f7bca1"
        "f7ba9ff7b99ef7b89cf7b79bf7b599f7b497f7b396f7b194f7b093f7af91f7ad90f7ac8e"
        "f7aa8cf7a98bf7a889f7a688f6a586f6a385f6a283f5a081f59f80f59d7ef59c7df49a7b"
        "f4987af39778f39577f39475f29274f29072f18f71f18d6ff08b6ef08a6cef886bee8669"
        "ee8468ed8366ec8165ec7f63eb7d62ea7b60e97a5fe9785de8765ce7745be67259e57058"
        "e46e56e36c55e36b54e26952e16751e0654fdf634ede614ddd5f4bdc5d4ada5a49d95847"
        "d85646d75445d65244d55042d44e41d24b40d1493fd0473dcf453ccd423bcc403acb3e38"
        "ca3b37c83836c73635c53334c43032c32e31c12b30c0282fbe242ebd1f2dbb1b2cba162b"
        "b8122ab70d28b50927b40426"),
}

_GLYPHS = _parse_font()
_GLYPHS.setflags(write=False)
