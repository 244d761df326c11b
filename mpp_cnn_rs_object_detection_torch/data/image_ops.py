"""The OpenCV and Pillow calls of the host CNN-training pipeline, written
out in numpy.

The JAX package's augmentation (``data/augmentation.py``) and hard mining
(``models/posnet_model.py:compute_errors``) call OpenCV and Pillow, which
the GPU host does not have. Each call is reproduced here with the
library's own arithmetic, so the same inputs give the same outputs:

  - ``rgb_to_lab`` / ``lab_to_rgb``: ``cv2.cvtColor`` ``COLOR_RGB2LAB`` and
    ``COLOR_LAB2RGB`` on uint8, OpenCV's fixed-point tables (sRGB gamma
    and cube root forward; the L/ab tables and inverse gamma back). Equal
    to OpenCV on all 2^24 inputs of each direction;
  - ``clahe``: ``cv2.createCLAHE(clipLimit, tileGridSize).apply`` on uint8:
    per-tile histograms clipped at ``clip * tile_area / 256`` with the
    excess redistributed (and its residual stepped), the tiles' LUTs
    interpolated bilinearly in float32 between tile centers;
  - ``fill_poly``: ``cv2.fillPoly(mask, [pts], value)`` of one polygon,
    8-connected: the outline drawn edge by edge with OpenCV's line
    iterator, then its even-odd scanline fill in 16.16 fixed point;
  - ``resize_area`` / ``resize_linear``: ``cv2.resize`` of float32 images
    with ``INTER_AREA`` (fractional cell weights, OpenCV's accumulation
    order; at integer factors its fast path: each block summed in OpenCV's
    order, then scaled) and ``INTER_LINEAR`` (half-pixel centers, edge
    replication);
  - ``box_blur3``: ``cv2.blur(img, (3, 3))`` (border ``REFLECT_101``);
  - ``resize_bilinear_u8``: Pillow's ``Image.resize((w, h),
    Image.BILINEAR)`` of an 8-bit ``L`` or ``RGB`` image: a triangle
    filter whose support scales with the reduction, 22-bit fixed-point
    coefficients (the same for every band), a horizontal then a vertical
    pass.

``tests/test_torch_augmentation.py`` holds each to the library.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

F32 = np.float32

# ---------------------------------------------------------- RGB <-> Lab

_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_BASE = 1 << 14
_MIN_AB = -8145
_SRGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
_XYZ2SRGB = np.array([[3.240479, -1.53715, -0.498535],
                      [-0.969256, 1.875991, 0.041556],
                      [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _c_div(a: np.ndarray, b: int) -> np.ndarray:
    """C's integer division (truncation toward zero)."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays


@functools.lru_cache(maxsize=None)
def _lab_tables():
    """OpenCV's 8-bit Lab tables (read-only)."""
    x = np.arange(256) / 255.0
    srgb = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma = np.rint(255.0 * (1 << _GAMMA_SHIFT) * srgb).astype(np.int64)
    # the cube root table over [0, 1.5] in steps of 1 / (255 * 8): the
    # cube root rounded to float32 before scaling, as OpenCV's softfloat
    v = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) / (
        255.0 * (1 << _GAMMA_SHIFT))
    f = np.where(v < 216.0 / 24389.0, v * (841.0 / 108.0) + 16.0 / 116.0,
                 np.cbrt(v).astype(F32).astype(np.float64))
    cbrt = np.rint((1 << _LAB_SHIFT2) * f).astype(np.int64)
    to_xyz = np.rint((1 << _LAB_SHIFT) * _SRGB2XYZ
                     / _D65[:, None]).astype(np.int64)

    # back: L -> (y, f(y)) in units of 2^14, f(x|z) -> x|z, linear -> sRGB
    lum = np.arange(256) * 100.0 / 255.0
    low = lum <= 8.0
    fy = np.where(low, lum / 903.3 * 7.787 + 16.0 / 116.0, (lum + 16) / 116)
    y = np.where(low, lum / 903.3, ((lum + 16) / 116) ** 3)
    yf = np.rint(np.stack([y, fy], -1) * _LAB_BASE).astype(np.int64)
    i = np.arange(_MIN_AB, 2 * _LAB_BASE + 1, dtype=np.int64)
    xz = np.where(i <= 3390,
                  _c_div(i * 108, 841)
                  - (_LAB_BASE * 16 // 116) * 108 // 841,
                  ((i * i) // _LAB_BASE) * i // _LAB_BASE)
    lin = np.arange(4096) / 4096.0
    inv = np.where(lin <= 0.0031308, lin * 12.92,
                   1.055 * lin ** (1 / 2.4) - 0.055)
    inv_gamma = np.rint(255.0 * inv).astype(np.int64)
    to_rgb = np.rint((1 << _LAB_SHIFT) * _XYZ2SRGB
                     * _D65[None, :]).astype(np.int64)
    return _frozen(gamma, cbrt, to_xyz, yf, xz, inv_gamma, to_rgb)


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 Lab (L * 255 / 100, a + 128, b +
    128)."""
    gamma, cbrt, to_xyz = _lab_tables()[:3]
    lin = gamma[np.asarray(rgb, np.uint8).astype(np.int64)]
    f = cbrt[_descale(lin @ to_xyz.T, _LAB_SHIFT)]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    one = 1 << _LAB_SHIFT2
    lum = _descale((116 * 255 + 50) // 100 * fy
                   - (16 * 255 * one + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * one, _LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * one, _LAB_SHIFT2)
    return np.clip(np.stack([lum, a, b], -1), 0, 255).astype(np.uint8)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 Lab -> uint8 RGB (the inverse of ``rgb_to_lab``'s
    encoding)."""
    yf, xz, inv_gamma, to_rgb = _lab_tables()[3:]
    lab = np.asarray(lab, np.uint8).astype(np.int64)
    y, fy = yf[lab[..., 0], 0], yf[lab[..., 0], 1]
    adiv = ((5 * lab[..., 1] * 53687 + (1 << 7)) >> 13) \
        - 128 * _LAB_BASE // 500
    bdiv = ((lab[..., 2] * 41943 + (1 << 4)) >> 9) \
        - 128 * _LAB_BASE // 200 + 1
    xyz = np.stack([xz[fy + adiv - _MIN_AB], y, xz[fy - bdiv - _MIN_AB]], -1)
    rgb = np.clip(_descale(xyz @ to_rgb.T, 14), 0, 4095)
    return inv_gamma[rgb].astype(np.uint8)


# ----------------------------------------------------------------- CLAHE


def clahe(gray: np.ndarray, clip_limit: float = 2.0,
          tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation of an (H, W)
    uint8 image over ``tiles`` = (columns, rows) tiles."""
    gray = np.asarray(gray, np.uint8)
    nx, ny = tiles
    h, w = gray.shape
    src = gray
    if h % ny or w % nx:
        # OpenCV pads both sides whenever either is not divisible
        src = np.pad(gray, ((0, ny - h % ny), (0, nx - w % nx)),
                     mode="reflect")
    th, tw = src.shape[0] // ny, src.shape[1] // nx
    area = th * tw
    tile_px = src.reshape(ny, th, nx, tw).transpose(0, 2, 1, 3).reshape(
        ny * nx, area).astype(np.int64)
    hist = np.bincount((tile_px + 256 * np.arange(ny * nx)[:, None]).ravel(),
                       minlength=256 * ny * nx).reshape(ny * nx, 256)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        excess = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (excess // 256)[:, None]
        # the residual: one more at every step-th bin from 0, r of them
        r = (excess % 256)[:, None]
        step = np.maximum(256 // np.maximum(r, 1), 1)
        k = np.arange(256)[None, :]
        hist += (r > 0) & (k % step == 0) & (k // step < r)
    lut = np.rint(np.cumsum(hist, 1).astype(F32) * (F32(255) / F32(area)))
    lut = np.clip(lut, 0, 255).astype(F32).reshape(ny, nx, 256)

    def axis(n, size, count):
        f = np.arange(n).astype(F32) * (F32(1.0) / F32(size)) - F32(0.5)
        lo = np.floor(f)
        frac = (f - lo).astype(F32)
        lo = lo.astype(np.int64)
        return (np.maximum(lo, 0), np.minimum(lo + 1, count - 1), frac,
                (F32(1.0) - frac).astype(F32))

    x1, x2, xa, xa1 = axis(w, tw, nx)
    y1, y2, ya, ya1 = axis(h, th, ny)
    v = gray.astype(np.int64)
    r1, r2 = y1[:, None], y2[:, None]
    res = (lut[r1, x1, v] * xa1 + lut[r1, x2, v] * xa) * ya1[:, None] \
        + (lut[r2, x1, v] * xa1 + lut[r2, x2, v] * xa) * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# -------------------------------------------------------------- polygons

_XY_SHIFT = 16


def _line8(mask: np.ndarray, p0, p1, value) -> None:
    """OpenCV's 8-connected line from ``p0`` to ``p1`` ((x, y), inside
    the image), drawn left to right."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        mask[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def fill_poly(mask: np.ndarray, pts: Sequence, value=1) -> np.ndarray:
    """Fill the polygon ``pts`` ((N, 2) integer (x, y) vertices inside the
    image) into ``mask`` in place, as ``cv2.fillPoly(mask, [pts],
    value)``: its outline, then the spans between pairs of edges on each
    row (even-odd), each edge's x stepped in 16.16 fixed point."""
    h, w = mask.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    for p0, p1 in zip(pts[-1:] + pts[:-1], pts):
        _line8(mask, p0, p1, value)
        if p0[1] == p1[1]:
            continue
        x0, x1 = p0[0] << _XY_SHIFT, p1[0] << _XY_SHIFT
        # C's division: truncation toward zero
        step = int((x1 - x0) / (p1[1] - p0[1]))
        top, bottom = (p0, p1) if p0[1] < p1[1] else (p1, p0)
        edges.append([top[1], bottom[1], top[0] << _XY_SHIFT, step])
    if len(edges) < 2:
        return mask
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    active, nxt = [], 0
    for y in range(edges[0][0], min(max(e[1] for e in edges), h)):
        active = [e for e in active if e[1] != y]
        while nxt < len(edges) and edges[nxt][0] == y:
            active.append(edges[nxt])
            nxt += 1
        active.sort(key=lambda e: e[2])
        for left, right in zip(active[0::2], active[1::2]):
            xl, xr = sorted((left[2], right[2]))
            c0 = (xl + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
            c1 = xr >> _XY_SHIFT
            if c0 < w and c1 >= 0:
                mask[y, max(c0, 0):min(c1, w - 1) + 1] = value
        for e in active:
            e[2] += e[3]
    return mask


# ------------------------------------------------------ resizes and blur


@functools.lru_cache(maxsize=64)
def _area_tab(src: int, dst: int):
    """``INTER_AREA``'s (source index, weight) terms of each output
    pixel, as (K, dst) arrays padded with zero weights; the terms keep
    OpenCV's order, in which it sums them."""
    scale = src / dst
    terms = [[] for _ in range(dst)]
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            terms[d].append((s1 - 1, (s1 - f1) / cell))
        for s in range(s1, s2):
            terms[d].append((s, 1.0 / cell))
        if f2 - s2 > 1e-3:
            terms[d].append((s2, min(min(f2 - s2, 1.0), cell) / cell))
    k = max(len(t) for t in terms)
    idx = np.zeros((k, dst), np.int64)
    wgt = np.zeros((k, dst), F32)
    for d, t in enumerate(terms):
        for j, (s, a) in enumerate(t):
            idx[j, d], wgt[j, d] = s, a
    return _frozen(idx, wgt)


# OpenCV's 128-bit vectors of float32: the fast path's vector branch
# handles whole groups of this many outputs of a 1-channel row
_SIMD_LANES = 4


def _resize_area_fast(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """``INTER_AREA`` at integer factors (OpenCV's ``resizeAreaFast``):
    each ky x kx block summed in row-major order, four terms at a time
    (``sum += a + b + c + d``), times 1 / (kx * ky). At factor 2 its
    vector branch sums ``(r00 + r01) + (r10 + r11)`` instead: for 4
    channels everywhere, for 1 channel on whole groups of lanes."""
    h, w, cn = img.shape
    oh, ow = h // ky, w // kx
    x = img[:oh * ky, :ow * kx].reshape(oh, ky, ow, kx, cn)
    terms = [x[:, sy, :, sx] for sy in range(ky) for sx in range(kx)]
    total = np.zeros((oh, ow, cn), img.dtype)
    k = 0
    while k <= len(terms) - 4:
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2])
                         + terms[k + 3])
        k += 4
    for t in terms[k:]:
        total = total + t
    out = total * img.dtype.type(1.0 / (kx * ky))
    if kx == ky == 2 and cn in (1, 4):
        vec = ((terms[0] + terms[1]) + (terms[2] + terms[3])) * img.dtype.type(
            0.25)
        n = ow if cn == 4 else ow // _SIMD_LANES * _SIMD_LANES
        out[:, :n] = vec[:, :n]
    return out


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_AREA)`` of an
    (H, W[, C]) float image to a smaller size: at integer factors
    OpenCV's fast path, else each source row's weighted column sums,
    then the weighted sum of those rows, in the image's dtype (float32
    weights) and OpenCV's order."""
    img = np.asarray(img)
    if img.ndim == 2:
        return resize_area(img[..., None], size)[..., 0]
    if tuple(size) == (img.shape[1], img.shape[0]):
        return img.copy()
    if img.shape[1] % size[0] == 0 and img.shape[0] % size[1] == 0:
        return _resize_area_fast(img, img.shape[1] // size[0],
                                 img.shape[0] // size[1])
    xi, xw = _area_tab(img.shape[1], size[0])
    yi, yw = _area_tab(img.shape[0], size[1])
    rows = img[:, xi[0]] * xw[0][None, :, None]
    for j in range(1, len(xi)):
        rows = rows + img[:, xi[j]] * xw[j][None, :, None]
    out = rows[yi[0]] * yw[0][:, None, None]
    for j in range(1, len(yi)):
        out = out + rows[yi[j]] * yw[j][:, None, None]
    return out


@functools.lru_cache(maxsize=64)
def _linear_tab(src: int, dst: int):
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(F32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(F32)
    frac = np.where(s < 0, F32(0), frac)
    s = np.maximum(s, 0)
    frac = np.where(s >= src - 1, F32(0), frac)
    s = np.minimum(s, src - 1)
    return _frozen(s, np.minimum(s + 1, src - 1),
                   (F32(1) - frac).astype(F32), frac)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` of an
    (H, W, C) float image: two taps per axis at half-pixel centers (float32
    weights), edges replicated."""
    img = np.asarray(img)
    x0, x1, ax0, ax1 = _linear_tab(img.shape[1], size[0])
    y0, y1, ay0, ay1 = _linear_tab(img.shape[0], size[1])
    rows = img[:, x0] * ax0[None, :, None] + img[:, x1] * ax1[None, :, None]
    return rows[y0] * ay0[:, None, None] + rows[y1] * ay1[:, None, None]


def box_blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.blur(img, (3, 3))`` of an (H, W, C) float image: the 3 x 3
    mean with ``REFLECT_101`` borders, summed in float64, in the image's
    dtype."""
    img = np.asarray(img)
    p = np.pad(img.astype(np.float64), ((1, 1), (1, 1), (0, 0)),
               mode="reflect")
    rows = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    return ((rows[:-2] + rows[1:-1] + rows[2:]) * (1.0 / 9.0)).astype(
        img.dtype)


_PIL_PRECISION = 22


def _pil_coeffs(src: int, dst: int):
    scale = src / dst
    fscale = max(scale, 1.0)
    support = fscale  # the triangle filter's support is 1
    bounds, kernels = [], []
    for i in range(dst):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), src) - lo
        x = (np.arange(n) + lo - center + 0.5) / fscale
        k = np.maximum(0.0, 1.0 - np.abs(x))
        total = k.sum()
        if total != 0.0:
            k = k / total
        one = 1 << _PIL_PRECISION
        kernels.append(np.where(k < 0, np.trunc(-0.5 + k * one),
                                np.trunc(0.5 + k * one)).astype(np.int64))
        bounds.append(lo)
    return bounds, kernels


def _pil_pass(img: np.ndarray, dst: int) -> np.ndarray:
    """One of Pillow's separable passes, along axis 1 of ``img``."""
    out = np.full((img.shape[0], dst), 1 << (_PIL_PRECISION - 1), np.int64)
    for i, (lo, k) in enumerate(zip(*_pil_coeffs(img.shape[1], dst))):
        out[:, i] += img[:, lo:lo + len(k)] @ k
    top = 1 << _PIL_PRECISION << 8
    return np.where(out >= top, 255,
                    np.where(out <= 0, 0, out >> _PIL_PRECISION))


def resize_bilinear_u8(img: np.ndarray, size: Tuple[int, int]
                       ) -> np.ndarray:
    """Pillow's ``Image.fromarray(img).resize((w, h), Image.BILINEAR)``
    of an (H, W) or (H, W, 3) uint8 image, band by band."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3:
        return np.stack([resize_bilinear_u8(img[..., c], size)
                         for c in range(img.shape[2])], axis=-1)
    out = img.astype(np.int64)
    w, h = size
    if w != out.shape[1]:
        out = _pil_pass(out, w)
    if h != out.shape[0]:
        out = _pil_pass(out.T, h).T
    return np.ascontiguousarray(out).astype(np.uint8)
