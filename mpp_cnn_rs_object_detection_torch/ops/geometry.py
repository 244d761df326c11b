"""Oriented-rectangle geometry on torch tensors.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/ops/geometry.py``. A
rectangle is numbers ``(x, y, size, ratio, angle)``; marks map to polygons
through the reference's ``Rectangle.poly_coord`` construction, including its
``angle + pi/2`` quirk. The intersection of two convex quads is the convex
hull of {A's vertices inside B} u {B's vertices inside A} u {edge-edge
crossings}: all 24 candidates are collected with a validity mask, ordered by
angle around their mean and summed with the shoelace formula. One
candidate-major body (candidates on dim 0, everything else broadcast) serves
both the element-wise and the all-pairs form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-9
# all-pairs pairs per chunk (over every lane): bounds the (24, pairs)
# transients; one superstep of 3 lanes of 289 cells against K = 1024 slots
# (888k pairs) is one chunk
_PAIR_CHUNK = 1 << 22


def rect_to_poly(center, short, long, angle, dilation: float = 0.0
                 ) -> torch.Tensor:
    """Rectangle parameters -> (..., 4, 2) corners (reference ordering)."""
    hx = short / 2.0 + dilation
    hy = long / 2.0 + dilation
    sx = torch.stack([hx, hx, -hx, -hx], dim=-1)
    sy = torch.stack([hy, -hy, -hy, hy], dim=-1)
    cos, sin = torch.cos(angle), torch.sin(angle)
    px = sx * cos[..., None] - sy * sin[..., None]
    py = sx * sin[..., None] + sy * cos[..., None]
    return torch.stack([px, py], dim=-1) + center[..., None, :]


def marks_to_poly(xy, size, ratio, angle) -> torch.Tensor:
    """Marks -> polygon via ``rect_to_poly(xy, length, width, angle+pi/2)``
    with ``length = 2*size/(1+ratio)``, ``width = ratio*length``."""
    length = (2.0 * size) / (1.0 + ratio)
    width = ratio * length
    return rect_to_poly(xy, length, width, angle + math.pi / 2)


def rect_to_poly_np(centers, short, long, angle, dilation: float = 0.0
                    ) -> np.ndarray:
    """Host/numpy batched ``rect_to_poly``: (N,2)+(N,)x3 -> (N,4,2)."""
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    short = np.broadcast_to(np.asarray(short, np.float64), (len(centers),))
    long = np.broadcast_to(np.asarray(long, np.float64), (len(centers),))
    angle = np.broadcast_to(np.asarray(angle, np.float64), (len(centers),))
    hx = short / 2.0 + dilation
    hy = long / 2.0 + dilation
    sx = np.stack([hx, hx, -hx, -hx], axis=-1)
    sy = np.stack([hy, -hy, -hy, hy], axis=-1)
    cos, sin = np.cos(angle), np.sin(angle)
    px = sx * cos[:, None] - sy * sin[:, None]
    py = sx * sin[:, None] + sy * cos[:, None]
    return np.stack([px, py], axis=-1) + centers[:, None, :]


def wla_to_sra(a, b, angle):
    """(short, long, angle) -> (size, ratio, angle)."""
    return (a + b) / 2.0, a / b, angle


def sra_to_wla(s, r, angle):
    """(size, ratio, angle) -> (short, long, angle)."""
    b = (2.0 * s) / (1.0 + r)
    return b * r, b, angle


def rect_area(size, ratio):
    """length * width = 4*size^2*ratio/(1+ratio)^2."""
    length = (2.0 * size) / (1.0 + ratio)
    return length * (ratio * length)


def polygon_to_abw(poly: np.ndarray):
    """DOTA 4-corner polygon -> (a, b, angle); host-side numpy."""
    poly = np.asarray(poly, dtype=np.float64)
    assert poly.shape == (4, 2)
    norm_axis_1 = np.mean(
        [np.linalg.norm(poly[0] - poly[1]), np.linalg.norm(poly[2] - poly[3])]
    )
    norm_axis_2 = np.mean(
        [np.linalg.norm(poly[1] - poly[2]), np.linalg.norm(poly[3] - poly[0])]
    )
    if norm_axis_1 < norm_axis_2:
        a, b = norm_axis_1, norm_axis_2
        axis_vector = np.mean([poly[2], poly[1]], axis=0) - np.mean(
            [poly[0], poly[3]], axis=0
        )
    else:
        a, b = norm_axis_2, norm_axis_1
        axis_vector = np.mean([poly[1], poly[0]], axis=0) - np.mean(
            [poly[3], poly[2]], axis=0
        )
    angle = np.arctan2(axis_vector[1], axis_vector[0]) % np.pi
    return a, b, angle


def quad_area(quad: torch.Tensor) -> torch.Tensor:
    """Absolute shoelace area of a (..., 4, 2) quad."""
    x, y = quad[..., 0], quad[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y, dim=-1))


def _intersection_area(ax, ay, bx, by) -> torch.Tensor:
    """Intersection area from candidate-major vertex arrays: ``ax``/``ay``
    are (4, *A), ``bx``/``by`` (4, *B) with broadcastable trailing shapes."""
    axn, ayn = torch.roll(ax, -1, 0), torch.roll(ay, -1, 0)
    bxn, byn = torch.roll(bx, -1, 0), torch.roll(by, -1, 0)
    sgn_a = torch.sign(0.5 * torch.sum(ax * ayn - axn * ay, dim=0))
    sgn_b = torch.sign(0.5 * torch.sum(bx * byn - bxn * by, dim=0))

    def in_quad(px, py, qx, qy, qxn, qyn, sgn):
        inside = None
        for e in range(4):
            ex0, ey0, ex1, ey1 = qx[e], qy[e], qxn[e], qyn[e]
            cross = (ex1 - ex0) * (py - ey0) - (ey1 - ey0) * (px - ex0)
            elen = torch.sqrt((ex1 - ex0) ** 2 + (ey1 - ey0) ** 2)
            pdist = torch.sqrt((px - ex0) ** 2 + (py - ey0) ** 2)
            ok = cross * sgn >= -(1e-6 * (elen * pdist + 1.0))
            inside = ok if inside is None else (inside & ok)
        return inside

    zb, za = 0 * bx, 0 * ax
    in_b = in_quad(ax + zb, ay + 0 * by, bx, by, bxn, byn, sgn_b)
    in_a = in_quad(za + bx, 0 * ay + by, ax, ay, axn, ayn, sgn_a)

    seg_x, seg_y, seg_ok = [], [], []
    for i in range(4):
        d1x, d1y = axn[i] - ax[i], ayn[i] - ay[i]
        for j in range(4):
            d2x, d2y = bxn[j] - bx[j], byn[j] - by[j]
            denom = d1x * d2y - d1y * d2x
            wx, wy = bx[j] - ax[i], by[j] - ay[i]
            t_num = wx * d2y - wy * d2x
            s_num = wx * d1y - wy * d1x
            nonpar = torch.abs(denom) > _EPS
            safe = torch.where(nonpar, denom, 1.0)
            t = t_num / safe
            s = s_num / safe
            tol = 1e-7
            seg_ok.append(nonpar & (t >= -tol) & (t <= 1 + tol)
                          & (s >= -tol) & (s <= 1 + tol))
            seg_x.append(ax[i] + t * d1x)
            seg_y.append(ay[i] + t * d1y)

    cx = torch.stack([ax[i] + zb[0] for i in range(4)]
                     + [za[0] + bx[j] for j in range(4)] + seg_x)
    cy = torch.stack([ay[i] + 0 * by[0] for i in range(4)]
                     + [0 * ay[0] + by[j] for j in range(4)] + seg_y)
    valid = torch.cat([in_b, in_a, torch.stack(seg_ok)])  # (24, ...)

    vf = valid.to(cx.dtype)
    n_valid = vf.sum(dim=0)
    denom_c = torch.clamp(n_valid, min=1.0)
    cx0 = (cx * vf).sum(dim=0) / denom_c
    cy0 = (cy * vf).sum(dim=0) / denom_c
    ang = torch.where(valid, torch.atan2(cy - cy0, cx - cx0), math.inf)
    _, order = torch.sort(ang, dim=0)  # invalid slots sort last
    sx = torch.gather(cx, 0, order)
    sy = torch.gather(cy, 0, order)
    sv = torch.gather(vf, 0, order)
    # pad the invalid tail with the first (valid) vertex: zero added area
    px = torch.where(sv > 0.5, sx, sx[0])
    py = torch.where(sv > 0.5, sy, sy[0])
    pxn, pyn = torch.roll(px, -1, 0), torch.roll(py, -1, 0)
    area = 0.5 * torch.abs(torch.sum(px * pyn - pxn * py, dim=0))
    return torch.where(n_valid >= 3, area, 0.0)


def convex_quad_intersection_area(quad_a, quad_b) -> torch.Tensor:
    """Intersection area of convex quads (..., 4, 2), broadcast pairwise."""
    qa = torch.movedim(quad_a, -2, 0)  # (4, ..., 2)
    qb = torch.movedim(quad_b, -2, 0)
    return _intersection_area(qa[..., 0], qa[..., 1], qb[..., 0], qb[..., 1])


def quad_overlap_ratio(quad_a, quad_b) -> torch.Tensor:
    """``intersection / (min(area_a, area_b) + 1e-6)``."""
    inter = convex_quad_intersection_area(quad_a, quad_b)
    min_area = torch.minimum(quad_area(quad_a), quad_area(quad_b))
    return inter / (min_area + 1e-6)


def quad_intersection_area_matrix(polys_a, polys_b) -> torch.Tensor:
    """All-pairs intersection areas: ``(..., Ka, 4, 2)`` against
    ``(..., Kb, 4, 2)`` gives ``(..., Ka, Kb)``, leading (lane) axes
    broadcast, candidates on the major axis. Rows go in chunks of every
    lane's rows together, within ``_PAIR_CHUNK`` pairs per chunk."""
    bx = torch.movedim(polys_b[..., 0], -1, 0)[..., None, :]
    by = torch.movedim(polys_b[..., 1], -1, 0)[..., None, :]
    ka, kb = polys_a.shape[-3], polys_b.shape[-3]
    n_lanes = math.prod(torch.broadcast_shapes(polys_a.shape[:-3],
                                               polys_b.shape[:-3]))
    rows = max(1, _PAIR_CHUNK // max(1, n_lanes * kb))
    out = []
    for r in range(0, ka, rows):
        pa = polys_a[..., r:r + rows, :, :]
        out.append(_intersection_area(
            torch.movedim(pa[..., 0], -1, 0)[..., None],
            torch.movedim(pa[..., 1], -1, 0)[..., None], bx, by))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-2)
