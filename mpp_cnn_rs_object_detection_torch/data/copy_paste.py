"""Copy-paste augmentation of training patches (host numpy).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/copy_paste.py``:
real GT object crops of the train split are pasted into training patches
at fresh, non-overlapping poses, with matching annotations appended. The
numpy generator is consumed in the JAX package's order.

The JAX module uses OpenCV for two steps, which the GPU host does not
have; both are written out here:
  - ``_rotate_crop``: ``cv2.warpAffine(crop, getRotationMatrix2D(...),
    INTER_LINEAR, BORDER_REFLECT)`` as an inverse-mapped bilinear sample
    (the matrix inverted as ``cv2.invertAffineTransform`` does) with
    ``fedcba|abcd`` reflection at the borders;
  - ``_gaussian_blur``: ``cv2.GaussianBlur(alpha, (k, k), sigma)`` as a
    separable ``k``-tap Gaussian over numpy ``'reflect'`` padding (cv2's
    default ``BORDER_REFLECT_101``).
Both agree with OpenCV to float32 rounding of the interpolation
(``tests/test_torch_device_pipeline.py``).

Geometry lives in the ``rect_mask`` frame: an object is (center=(y, x),
a=short, b=long, angle), and its pixels are ``|R(angle)^T (p - c)| <= (a/2,
b/2)``.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from mpp_cnn_rs_object_detection_torch.data.label_processing import rect_mask

_CORNER_SIGNS = np.array(
    [[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]]
)  # (4, 2) in (u=a-axis, v=b-axis) units


def _abw_polys(centers: np.ndarray, a, b, angle) -> np.ndarray:
    """(N, 2) centers + per-object (or scalar) a/b/angle -> (N, 4, 2)
    corners in (y, x)."""
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    n = centers.shape[0]
    a = np.broadcast_to(np.asarray(a, np.float64), (n,))
    b = np.broadcast_to(np.asarray(b, np.float64), (n,))
    angle = np.broadcast_to(np.asarray(angle, np.float64), (n,))
    half = _CORNER_SIGNS[None] * np.stack([a, b], -1)[:, None, :]  # (N,4,2)
    cos, sin = np.cos(angle), np.sin(angle)
    rot = np.stack([np.stack([cos, -sin], -1),
                    np.stack([sin, cos], -1)], -2)  # (N, 2, 2): u,v -> dy,dx
    return centers[:, None, :] + np.einsum("nij,nkj->nki", rot, half)


def _quads_intersect_any(ps: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """For each candidate quad in ``ps`` (T, 4, 2): does it overlap ANY quad
    in ``qs`` (N, 4, 2)? (T,) bool, by separating axes over all T x N pairs
    at once, with strict comparisons (touching quads overlap)."""
    ps = np.asarray(ps, np.float64).reshape(-1, 4, 2)
    qs = np.asarray(qs, np.float64).reshape(-1, 4, 2)
    if qs.shape[0] == 0 or ps.shape[0] == 0:
        return np.zeros((ps.shape[0],), bool)
    ep = np.roll(ps, -1, axis=1) - ps
    ap = np.stack([-ep[..., 1], ep[..., 0]], axis=-1)      # (T, 4, 2)
    eq = np.roll(qs, -1, axis=1) - qs
    aq = np.stack([-eq[..., 1], eq[..., 0]], axis=-1)      # (N, 4, 2)

    # separation of pair (t, n) on t's axes
    pp = np.einsum("tpk,tak->tpa", ps, ap)                 # (T, 4 pts, 4 ax)
    qp = np.einsum("nqk,tak->tnqa", qs, ap)                # (T, N, 4, 4)
    sep_p = (qp.max(2) < pp.min(1)[:, None]) \
        | (pp.max(1)[:, None] < qp.min(2))                 # (T, N, 4)
    # separation of pair (t, n) on n's axes
    pq = np.einsum("tpk,nak->tnpa", ps, aq)                # (T, N, 4, 4)
    qq = np.einsum("nqk,nak->nqa", qs, aq)                 # (N, 4, 4)
    sep_q = (pq.max(2) < qq.min(1)[None]) \
        | (qq.max(1)[None] < pq.min(2))                    # (T, N, 4)

    separated = sep_p.any(-1) | sep_q.any(-1)              # (T, N)
    return (~separated).any(axis=1)


@dataclass
class PasteObject:
    crop: np.ndarray      # (S, S, 3) float image chip centred on the object
    a: float              # short side (px)
    b: float              # long side (px)
    angle: float          # rect_mask-frame angle in the crop
    category: object      # opaque label (string in DOTA pickles, int in synth)


def build_paste_bank(image_paths: Sequence[str],
                     annotation_paths: Sequence[str],
                     margin: float = 1.8,
                     max_side: float = 64.0) -> List[PasteObject]:
    """Every non-difficult GT object as a square crop whose side covers the
    object under any rotation (``margin * b``, rounded up to even)."""
    from mpp_cnn_rs_object_detection_torch.data.dataset import load_image

    bank: List[PasteObject] = []
    for img_path, ann_path in zip(image_paths, annotation_paths):
        image = load_image(img_path)
        with open(ann_path, "rb") as f:
            labels = pickle.load(f)
        centers = np.asarray(labels["centers"], np.float64).reshape(-1, 2)
        params = np.asarray(labels["parameters"], np.float64).reshape(-1, 3)
        cats = np.asarray(labels["categories"]).reshape(-1)
        diff = np.asarray(labels["difficult"]).reshape(-1)
        h, w = image.shape[:2]
        for c, (a, b, angle), cat, d in zip(centers, params, cats, diff):
            if d or b <= 0 or b > max_side:
                continue
            s = int(np.ceil(margin * b))
            s += s % 2  # even side: integer half-extent
            y, x = int(round(c[0])), int(round(c[1]))
            if y - s // 2 < 0 or x - s // 2 < 0 or y + s // 2 > h \
                    or x + s // 2 > w:
                continue
            crop = image[y - s // 2: y + s // 2, x - s // 2: x + s // 2]
            bank.append(PasteObject(
                crop=np.ascontiguousarray(crop, np.float32), a=float(a),
                b=float(b), angle=float(angle), category=cat))
    return bank


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's ``BORDER_REFLECT`` (``fedcba|abcdefgh|hgfedcb``) for
    indices less than ``n`` outside the range."""
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= n, 2 * n - i - 1, i)


def _rotate_crop(crop: np.ndarray, delta: float, scale: float) -> np.ndarray:
    """Rotate the (y, x)-frame content by ``delta`` and resize by ``scale``
    about the crop centre: ``cv2.warpAffine`` of
    ``cv2.getRotationMatrix2D(centre, degrees(delta), scale)``, bilinear,
    with reflected borders. Each output pixel samples the source at the
    inverse map of its coordinates."""
    s = crop.shape[0]
    c = s / 2 - 0.5
    ang = np.deg2rad(np.degrees(delta))
    alpha, beta = scale * np.cos(ang), scale * np.sin(ang)
    # getRotationMatrix2D, then invertAffineTransform
    m = np.array([[alpha, beta, (1 - alpha) * c - beta * c],
                  [-beta, alpha, beta * c + (1 - alpha) * c]])
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    inv_det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * inv_det, m[0, 0] * inv_det
    a12, a21 = -m[0, 1] * inv_det, -m[1, 0] * inv_det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64)
    sx = a11 * xx + a12 * yy + b1
    sy = a21 * xx + a22 * yy + b2
    x0, y0 = np.floor(sx), np.floor(sy)
    ax = (sx - x0).astype(np.float32)[..., None]
    ay = (sy - y0).astype(np.float32)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = _reflect(x0, s), _reflect(x0 + 1, s)
    ya, yb = _reflect(y0, s), _reflect(y0 + 1, s)
    crop = np.asarray(crop, np.float32)
    top = crop[ya, xa] + ax * (crop[ya, xb] - crop[ya, xa])
    bot = crop[yb, xa] + ax * (crop[yb, xb] - crop[yb, xa])
    return top + ay * (bot - top)


def _gaussian_blur(img: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigma)`` of a 2-D float32 array:
    cv2's float32 kernel ``exp(-x^2 / (2 sigma^2))`` normalised to sum 1,
    applied along rows then columns over reflect-101 padding."""
    x = np.arange(k) - (k - 1) * 0.5
    t = np.exp(-0.5 / sigma ** 2 * x * x).astype(np.float32)
    kern = (t * (1.0 / t.astype(np.float64).sum())).astype(np.float32)
    r = k // 2
    p = np.pad(np.asarray(img, np.float32), r, mode="reflect")
    h, w = img.shape
    rows = sum(kern[i] * p[:, i:i + w] for i in range(k))
    return sum(kern[i] * rows[i:i + h] for i in range(k)).astype(np.float32)


def paste_objects(patch: np.ndarray, centers: np.ndarray, params: np.ndarray,
                  cats: np.ndarray, diff: np.ndarray,
                  bank: Sequence[PasteObject], rng: np.random.Generator,
                  n_paste: int, scale_range=(0.9, 1.15), feather: float = 1.5,
                  max_tries: int = 12):
    """Paste up to ``n_paste`` bank objects into ``patch`` at fresh,
    non-overlapping poses; returns the updated (patch, centers, params,
    cats, diff). Labels keep the dataset pickle conventions."""
    if len(bank) == 0 or n_paste <= 0:
        return patch, centers, params, cats, diff
    h, w = patch.shape[:2]
    patch = patch.copy()
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    params = np.asarray(params, np.float64).reshape(-1, 3)
    cats = np.asarray(cats).reshape(-1)
    diff = np.asarray(diff, bool).reshape(-1)
    # occupied polys: existing GT slightly inflated so pastes keep a gap
    occupied = _abw_polys(centers, 1.25 * params[:, 0], 1.25 * params[:, 1],
                          params[:, 2]) if len(centers) \
        else np.zeros((0, 4, 2))
    new_c, new_p, new_k = [], [], []
    for idx in rng.choice(len(bank), size=n_paste):
        obj = bank[int(idx)]
        s = obj.crop.shape[0]
        if s >= min(h, w):
            continue
        scale = float(rng.uniform(*scale_range))
        delta = float(rng.uniform(0.0, np.pi))
        new_angle = float(np.mod(obj.angle + delta, np.pi))
        a, b = obj.a * scale, obj.b * scale
        # all candidate positions tested in one batched separating-axis pass
        cys = rng.uniform(s / 2, h - s / 2, size=max_tries)
        cxs = rng.uniform(s / 2, w - s / 2, size=max_tries)
        cand = _abw_polys(np.stack([cys, cxs], -1), 1.25 * a, 1.25 * b,
                          new_angle)
        free = np.flatnonzero(~_quads_intersect_any(cand, occupied))
        for t in free[:1]:
            cy, cx = float(cys[t]), float(cxs[t])
            poly = cand[t]
            chip = _rotate_crop(obj.crop, delta, scale)
            y0, x0 = int(round(cy - s / 2)), int(round(cx - s / 2))
            ccy, ccx = cy - y0, cx - x0
            # feathered alpha: rectangle mask dilated then blurred
            alpha = rect_mask((s, s), (ccy, ccx), a + 2 * feather,
                              b + 2 * feather, new_angle).astype(np.float32)
            alpha = _gaussian_blur(alpha, max(3, 2 * int(feather) + 1),
                                   feather)
            region = patch[y0:y0 + s, x0:x0 + s]
            patch[y0:y0 + s, x0:x0 + s] = (
                alpha[..., None] * chip[:region.shape[0], :region.shape[1]]
                + (1.0 - alpha[..., None]) * region
            )
            occupied = np.concatenate([occupied, poly[None]], axis=0)
            new_c.append((cy, cx))
            new_p.append((a, b, new_angle))
            new_k.append(obj.category)
    if new_c:
        centers = np.concatenate([centers, np.asarray(new_c)], axis=0) \
            if len(centers) else np.asarray(new_c)
        params = np.concatenate([params, np.asarray(new_p)], axis=0) \
            if len(params) else np.asarray(new_p)
        cats = (np.concatenate([cats, np.asarray(new_k)])
                if len(cats) else np.asarray(new_k))
        diff = np.concatenate([diff, np.zeros(len(new_k), bool)])
    return patch, centers, params, cats, diff
