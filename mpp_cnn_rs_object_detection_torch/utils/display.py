"""Box and oriented-rectangle overlays, written without OpenCV or Pillow.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/utils/display.py``, whose
overlays ``cv2.polylines`` and ``cv2.rectangle`` draw. Here OpenCV's
thickness-1 line (``LINE_8``: ``cv2.clipLine`` at the image's edges, then
the 8-connected ``LineIterator`` walked left to right) is written out in
numpy, pixel-equal to OpenCV, and vectorised over every segment of every
shape: a scene's export holds tens of thousands of rectangles. Shapes are
drawn in their order, so where two overlap the later one's colour wins, as
with OpenCV. ``save_image`` writes the RGB array through
``utils/png.py:write_png``. ``make_gif`` writes an animated GIF89a with its
own LZW coder (``write_gif``) where the JAX package uses Pillow: a frame
of at most 256 colours keeps its exact pixels; a frame with more gets its
own median-cut palette of 256 (Pillow's quantizer is not copied; the
difference is in ``ROADMAP.md`` section 3).
"""

from __future__ import annotations

import glob
import os
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from mpp_cnn_rs_object_detection_torch.ops.geometry import rect_to_poly_np
from mpp_cnn_rs_object_detection_torch.utils.png import read_png, write_png


def _to_u8(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _score_colors(scores, max_score: float = 1.0) -> np.ndarray:
    """plasma-like colormap without matplotlib: scores -> (N, 3) RGB ints,
    the JAX package's per-score arithmetic (float64 after the clip)."""
    s = np.asarray(scores).reshape(-1)
    t = np.clip(s / max(max_score, 1e-8), 0, 1).astype(np.float64)
    r = 255 * np.minimum(1.0, 0.05 + 1.5 * t)
    g = 255 * np.maximum(0.0, 1.7 * (t - 0.4))
    b = 255 * np.maximum(0.0, 1.0 - 1.4 * t)
    return np.stack([r, g, b], axis=-1).astype(np.int64)


def _fixed_colors(color, n: int) -> np.ndarray:
    cc = [int(c) for c in np.ravel(color)[:3]]
    if max(cc, default=0) <= 1:
        cc = [int(255 * c) for c in cc]
    return np.tile(np.asarray(cc, np.int64), (n, 1))


def _check_thickness(thickness: int) -> None:
    if thickness != 1:
        raise NotImplementedError(
            f"thickness {thickness}: only OpenCV's thickness-1 line is "
            "written out (ROADMAP.md item 16)")


def _clip_segments(p1: np.ndarray, p2: np.ndarray, h: int, w: int):
    """``cv2.clipLine`` on (N, 2) int64 (x, y) end points: the clipped end
    points and whether any part of each segment lies in the image."""
    x1, y1 = p1[:, 0].copy(), p1[:, 1].copy()
    x2, y2 = p2[:, 0].copy(), p2[:, 1].copy()
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0).astype(np.int64) + (x > right) * 2 + (y < 0) * 4
                + (y > bottom) * 8)

    def code_x(x):
        return (x < 0).astype(np.int64) + (x > right) * 2

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    # OpenCV's int64 += (int64)((double)... / ...) truncates towards zero
    with np.errstate(divide="ignore", invalid="ignore"):
        sel = todo & ((c1 & 12) != 0)
        a = np.where(c1 < 8, 0, bottom)
        step = np.trunc((a - y1).astype(np.float64) * (x2 - x1) / (y2 - y1))
        x1 = np.where(sel, x1 + np.where(sel, step, 0).astype(np.int64), x1)
        y1 = np.where(sel, a, y1)
        c1 = np.where(sel, code_x(x1), c1)

        sel = todo & ((c2 & 12) != 0)
        a = np.where(c2 < 8, 0, bottom)
        step = np.trunc((a - y2).astype(np.float64) * (x2 - x1) / (y2 - y1))
        x2 = np.where(sel, x2 + np.where(sel, step, 0).astype(np.int64), x2)
        y2 = np.where(sel, a, y2)
        c2 = np.where(sel, code_x(x2), c2)

        todo = todo & ((c1 & c2) == 0) & ((c1 | c2) != 0)
        sel = todo & (c1 != 0)
        a = np.where(c1 == 1, 0, right)
        step = np.trunc((a - x1).astype(np.float64) * (y2 - y1) / (x2 - x1))
        y1 = np.where(sel, y1 + np.where(sel, step, 0).astype(np.int64), y1)
        x1 = np.where(sel, a, x1)
        c1 = np.where(sel, 0, c1)

        sel = todo & (c2 != 0)
        a = np.where(c2 == 1, 0, right)
        step = np.trunc((a - x2).astype(np.float64) * (y2 - y1) / (x2 - x1))
        y2 = np.where(sel, y2 + np.where(sel, step, 0).astype(np.int64), y2)
        x2 = np.where(sel, a, x2)
        c2 = np.where(sel, 0, c2)
    return (np.stack([x1, y1], -1), np.stack([x2, y2], -1),
            (c1 | c2) == 0)


def _segment_pixels(p1: np.ndarray, p2: np.ndarray, h: int, w: int):
    """The pixels OpenCV's ``LINE_8`` line sets for each (x, y) segment
    ``p1[i] -> p2[i]``: (segment index, row, col), each segment's pixels
    in their order along it."""
    p1, p2 = p1.astype(np.int64), p2.astype(np.int64)
    outside = ((p1[:, 0] < 0) | (p1[:, 0] >= w) | (p1[:, 1] < 0)
               | (p1[:, 1] >= h) | (p2[:, 0] < 0) | (p2[:, 0] >= w)
               | (p2[:, 1] < 0) | (p2[:, 1] >= h))
    c1, c2, ok = _clip_segments(p1, p2, h, w)
    p1 = np.where(outside[:, None], c1, p1)
    p2 = np.where(outside[:, None], c2, p2)
    ok = ~outside | ok
    # left to right: a segment with dx < 0 is walked from its other end
    swap = (p2[:, 0] - p1[:, 0]) < 0
    a = np.where(swap[:, None], p2, p1)
    b = np.where(swap[:, None], p1, p2)
    dx = b[:, 0] - a[:, 0]
    dy = b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major = np.where(vert, dy, dx)  # steps along the major axis
    minor = np.where(vert, dx, dy)
    count = np.where(ok, major + 1, 0)
    seg = np.repeat(np.arange(len(count)), count)
    j = np.arange(seg.size) - np.repeat(np.cumsum(count) - count, count)
    M, m = major[seg], minor[seg]
    # the error term's minor steps after j major ones: the smallest n with
    # 2 M n >= 2 m j - M (OpenCV's err = M - 2 m, stepping while err < 0)
    num = 2 * m * j - M
    n_minor = np.maximum(0, -((-num) // np.maximum(2 * M, 1)))
    along = np.where(vert[seg], n_minor, j)   # x steps (always +1)
    across = np.where(vert[seg], j, n_minor)  # y steps (sign sy)
    cols = a[seg, 0] + along
    rows = a[seg, 1] + sy[seg] * across
    return seg, rows, cols


def last_writes(flat: np.ndarray) -> np.ndarray:
    """Of writes to flat pixel indices ``flat``, in order, the index of
    the last write of each pixel (the one that wins), by pixel."""
    _, first = np.unique(flat[::-1], return_index=True)
    return flat.size - 1 - first


def _draw_segments(img: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                   colors: np.ndarray) -> np.ndarray:
    """Set each segment's pixels to its colour (saturated into 0-255, as
    OpenCV casts a colour), later segments on top."""
    h, w = img.shape[:2]
    seg, rows, cols = _segment_pixels(p1, p2, h, w)
    if seg.size == 0:
        return img
    flat = rows * w + cols
    keep = last_writes(flat)
    img.reshape(-1, img.shape[-1])[flat[keep]] = np.clip(colors[seg[keep]],
                                                         0, 255)
    return img


def _draw_closed(img: np.ndarray, corners: np.ndarray,
                 colors: np.ndarray) -> np.ndarray:
    """``cv2.polylines(isClosed=True)`` of (N, V, 2) int (x, y) corners:
    edges V-1 -> 0, 0 -> 1, ..., V-2 -> V-1 of each shape."""
    n, v = corners.shape[:2]
    if n == 0:
        return img
    starts = np.concatenate([corners[:, -1:], corners[:, :-1]], axis=1)
    return _draw_segments(img, starts.reshape(-1, 2),
                          corners.reshape(-1, 2),
                          np.repeat(colors, v, axis=0))


def bboxes_over_image(image: np.ndarray, boxes: Sequence,
                      scores: Optional[Sequence] = None,
                      color: Union[str, Tuple] = (0, 255, 0),
                      thickness: int = 1, max_score: float = 1.0
                      ) -> np.ndarray:
    """Axis-aligned (x1, y1, x2, y2) boxes over an image, as
    ``cv2.rectangle`` draws them."""
    _check_thickness(thickness)
    img = _to_u8(image).copy()
    b = np.asarray(boxes, np.float64).reshape(-1, 4).astype(np.int64)
    if isinstance(color, str):
        assert scores is not None
        colors = _score_colors(scores, max_score)
    else:
        colors = _fixed_colors(color, len(b))
    x1, y1, x2, y2 = b.T
    corners = np.stack([np.stack([x1, y1], -1), np.stack([x2, y1], -1),
                        np.stack([x2, y2], -1), np.stack([x1, y2], -1)],
                       axis=1)
    return _draw_closed(img, corners, colors)


def rectangles_over_image(image: np.ndarray, centers: np.ndarray,
                          params: np.ndarray,
                          scores: Optional[Sequence] = None,
                          param_type: str = "wla",
                          color: Union[str, Tuple] = (0, 255, 0),
                          thickness: int = 1, max_score: float = 1.0
                          ) -> np.ndarray:
    """Oriented rectangles over an image. ``params`` is (N, 3): (short,
    long, angle) for ``wla``, else (size, ratio, angle). ``color`` is an
    RGB triple (0-1 or 0-255) or a colormap name, which colours by
    ``scores / max_score``."""
    _check_thickness(thickness)
    img = _to_u8(image).copy()
    centers = np.asarray(centers).reshape(-1, 2)
    params = np.asarray(params).reshape(-1, 3)
    if isinstance(color, str):
        assert scores is not None
        colors = _score_colors(scores, max_score)
    else:
        colors = _fixed_colors(color, len(centers))
    if param_type == "sra":
        b_long = 2.0 * params[:, 0] / (1.0 + params[:, 1])
        wla = np.stack([b_long * params[:, 1], b_long, params[:, 2]], axis=-1)
    else:
        wla = params
    polys = rect_to_poly_np(centers, wla[:, 0], wla[:, 1], wla[:, 2])
    # poly is (4, 2) in (row, col); the line takes (x=col, y=row)
    pts = np.flip(polys, axis=-1).astype(np.int32).astype(np.int64)
    return _draw_closed(img, pts, colors)


def save_image(path: str, image: np.ndarray) -> None:
    """An RGB (or gray, or [0, 1] float) image as an 8-bit RGB PNG."""
    write_png(path, _to_u8(image))


def _rgb_frame(frame: np.ndarray) -> np.ndarray:
    """An image as ``read_png`` gives it, as (H, W, 3) uint8 RGB: gray
    repeated, alpha dropped, 16-bit gray's high byte."""
    f = np.asarray(frame)
    if f.dtype == bool:
        f = f.astype(np.uint8) * 255
    elif f.dtype == np.uint16:
        f = (f >> 8).astype(np.uint8)
    if f.ndim == 2:
        f = f[..., None]
    if f.shape[2] in (1, 2):
        f = np.repeat(f[..., :1], 3, axis=2)
    return np.ascontiguousarray(f[..., :3], dtype=np.uint8)


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int = 256
                ) -> np.ndarray:
    """Boxes of (U, 3) distinct colours with their pixel counts: the box
    with the widest channel range is split at its pixel-weighted median
    until there are ``n``. Returns the box of each colour."""
    boxes = [np.arange(len(colors))]
    spans = [int(np.ptp(colors, axis=0).max())]
    while len(boxes) < n and max(spans) > 0:
        k = int(np.argmax(spans))
        idx = boxes[k]
        c = colors[idx]
        ch = int(np.argmax(np.ptp(c, axis=0)))
        order = idx[np.argsort(c[:, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2) + 1, 1,
                          len(order) - 1))
        boxes[k:k + 1] = [order[:cut], order[cut:]]
        spans[k:k + 1] = [int(np.ptp(colors[b], axis=0).max())
                          for b in boxes[k:k + 2]]
    label = np.empty(len(colors), np.int64)
    for i, b in enumerate(boxes):  # one per palette entry (256)
        label[b] = i
    return label


def _palette_frame(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(palette (P, 3) uint8, (H, W) indices): the frame's own colours
    when it has at most 256; else a median cut of its colours binned to 5
    bits per channel, each entry the mean of its pixels' colours."""
    flat = frame.reshape(-1, 3).astype(np.int64)
    packed = flat[:, 0] << 16 | flat[:, 1] << 8 | flat[:, 2]
    uniq, inverse = np.unique(packed, return_inverse=True)
    if len(uniq) <= 256:
        colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1)
        return colors.astype(np.uint8), inverse.reshape(frame.shape[:2])
    q = flat >> 3
    bins, inverse, counts = np.unique(q[:, 0] << 10 | q[:, 1] << 5
                                      | q[:, 2], return_inverse=True,
                                      return_counts=True)
    centres = np.stack([bins >> 10, (bins >> 5) & 31, bins & 31], -1) * 8 + 4
    index = _median_cut(centres, counts)[inverse]
    n = np.bincount(index)
    palette = np.stack([np.bincount(index, weights=flat[:, c]) / n
                        for c in range(3)], -1)
    return (np.round(palette).astype(np.uint8),
            index.reshape(frame.shape[:2]))


def _lzw(indices: np.ndarray, min_size: int) -> bytes:
    """GIF's variable-width LZW of palette indices (codes of min_size + 1
    to 12 bits, least significant bit first; a clear code first and
    whenever the table is full, the end code last)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes, widths = [clear], [min_size + 1]
    table = {}
    size, nxt = min_size + 1, end + 1
    data = indices.astype(np.uint8).tobytes()
    w = data[0]
    for k in data[1:]:  # LZW is sequential: one step per pixel
        key = (w << 8) | k
        code = table.get(key)
        if code is not None:
            w = code
            continue
        codes.append(w)
        widths.append(size)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            codes.append(clear)
            widths.append(size)
            table.clear()
            size, nxt = min_size + 1, end + 1
        w = k
    codes += [w, end]
    widths += [size, size]
    # pack: each code's bits, least significant first
    codes = np.asarray(codes, np.int64)
    widths = np.asarray(widths, np.int64)
    bit = np.arange(widths.sum()) - np.repeat(np.cumsum(widths) - widths,
                                              widths)
    bits = (np.repeat(codes, widths) >> bit) & 1
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames: List[np.ndarray], duration_ms: int = 400,
              loop: int = 0) -> None:
    """An animated GIF89a of equal-sized frames (any array ``read_png``
    gives), each with its own colour table, ``duration_ms`` per frame
    (in hundredths of a second) and a NETSCAPE2.0 ``loop`` count (0:
    forever). A frame equal to the one before it is merged into it, its
    time added, as Pillow's writer does."""
    rgb = [_rgb_frame(f) for f in frames]
    h, w = rgb[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in rgb):
        raise ValueError("gif: the frames differ in size "
                         f"{sorted({f.shape[:2] for f in rgb})}")
    merged: List[Tuple[np.ndarray, int]] = []
    for f in rgb:
        if merged and np.array_equal(merged[-1][0], f):
            merged[-1] = (f, merged[-1][1] + duration_ms)
        else:
            merged.append((f, duration_ms))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
           + struct.pack("<H", loop) + b"\x00"]
    for f, ms in merged:
        palette, idx = _palette_frame(f)
        bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", ms // 10)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h,
                                         0x80 | (bits - 1)))
        out.append(table.tobytes())
        min_size = max(2, bits)
        out.append(bytes([min_size]) + _sub_blocks(_lzw(idx, min_size)))
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def make_gif(folder: str, pattern: str, output_name: str,
             duration_ms: int = 400) -> Optional[str]:
    """An animated GIF of the PNG frames in ``folder`` matching ``pattern``
    (sorted by name), looping forever, written as ``folder/output_name``;
    returns its path, or None when no file matches."""
    paths = sorted(glob.glob(os.path.join(folder, pattern)))
    if not paths:
        return None
    out = os.path.join(folder, output_name)
    write_gif(out, [read_png(p) for p in paths], duration_ms=duration_ms)
    return out


def detection_comparison_figure(image: np.ndarray, det_centers, det_params,
                                det_scores, gt_centers, gt_params,
                                max_score: float = 1.0) -> np.ndarray:
    """Side-by-side detections (score-coloured) and GT (green)."""
    left = rectangles_over_image(
        image, det_centers, det_params, scores=det_scores, color="plasma",
        max_score=max_score,
    )
    right = rectangles_over_image(image, gt_centers, gt_params,
                                  color=(0, 255, 0))
    return np.concatenate([left, right], axis=1)
