"""CNN-free data energies: contrast measures and gradient alignment.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/classic_energies.py``,
written over points with any leading axes: lane b's points ``xy`` (B, ...,
2) and ``marks`` (B, ..., 3) read lane b's image (B, H, W, C), as the
chain's other unary terms read their lane's maps. The JAX package maps one
point at a time; here every point gathers its fixed WINDOW x WINDOW window
around its center in one indexing call, clamped into the image as JAX's
``dynamic_slice`` clamps it, and the interior and rim masks are analytic
point-in-rotated-rectangle tests on the window grid.

Two places can part from the JAX package by float noise: the masked
variance is ``E[x^2] - mean^2`` in float32, which cancels on flat patches
where the reduction order shows, and a pixel whose distance to a
rectangle's edge ties the half-extent can flip under another float32
cosine. The gradient term reads the two leading channels of its field,
(d/dy, d/dx): the contrast setup's field carries a third, zero channel so
that it stacks like an image.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

EPS = 1e-8
CONTRAST_WINDOW = 48  # covers the largest rectangle (size 32) + dilation
# points per window gather: 4,096 windows of 48 x 48 x 3 float32 are 113 MB
CHUNK = 4096


@dataclass(frozen=True)
class ContrastConfig:
    measure: str = "craciun2"  # lafarge | craciun | craciun2 | mean | t-test
    dilation: int = 2
    gap: int = 1
    erode: int = 1
    rgb: bool = True
    thresh: float = 0.0
    window: int = CONTRAST_WINDOW


def _in_rect(u, v, a, b, pad: float = 0.0):
    """|local| within half-extents (a = long side along u, b = short)."""
    return (torch.abs(u) <= a / 2 + pad) & (torch.abs(v) <= b / 2 + pad)


def _masked_stats(values, mask):
    """(mean, var, count) of ``values`` (n, W, W) where ``mask``."""
    m = mask.to(torch.float32)
    cnt = m.sum(dim=(-2, -1)) + EPS
    mean = (values * m).sum(dim=(-2, -1)) / cnt
    var = (values * values * m).sum(dim=(-2, -1)) / cnt - mean * mean
    return mean, torch.clamp(var, min=0.0), cnt


def _measure(kind: str, mean_in, var_in, cnt_in, mean_out, var_out, cnt_out):
    """The contrast measures; the caller applies the sign (lafarge +,
    the others -)."""
    if kind == "lafarge":
        return torch.sqrt((var_out + var_in)
                          / ((cnt_in + cnt_out)
                             * torch.square(mean_in - mean_out) + EPS))
    if kind == "craciun":
        p1 = torch.square(mean_in - mean_out) / (
            4 * torch.sqrt(var_in + var_out) + EPS)
        p2 = -0.5 * torch.log((2 * torch.sqrt(var_in * var_out) + EPS)
                              / (var_in + var_out + EPS))
        return p1 + p2
    if kind == "craciun2":
        return torch.square(mean_in - mean_out) / (
            4 * torch.sqrt(var_in + var_out) + EPS)
    if kind == "mean":
        return torch.square(mean_in - mean_out)
    if kind == "t-test":
        return torch.abs(mean_in - mean_out) / torch.sqrt(
            var_in / cnt_in + var_out / cnt_out + EPS)
    raise ValueError(kind)


def _rect_frame(marks):
    """(long side, short side, cos, sin) of rectangles with marks (size,
    ratio, angle): the polygon is built at angle + pi/2."""
    size, ratio, angle = marks[..., 0], marks[..., 1], marks[..., 2]
    length = 2 * size / (1 + ratio)
    width = ratio * length
    a = angle + math.pi / 2
    return length, width, torch.cos(a), torch.sin(a)


def _contrast_flat(image, lanes, xy, marks, cfg: ContrastConfig):
    """Contrast energies of n points (``lanes`` (n,) their image lanes)."""
    h, w = image.shape[1:3]
    win = cfg.window
    if h < win or w < win:
        raise ValueError(f"contrast energy: image {h}x{w} is smaller than "
                         f"its {win}x{win} window")
    ar = torch.arange(win, device=xy.device)
    cy, cx = xy[:, 0], xy[:, 1]
    yi = torch.clamp(torch.round(cy).to(torch.int64) - win // 2, 0, h - win)
    xi = torch.clamp(torch.round(cx).to(torch.int64) - win // 2, 0, w - win)
    rows, cols = yi[:, None] + ar, xi[:, None] + ar
    patch = image[lanes[:, None, None], rows[:, :, None], cols[:, None, :]]
    # offsets of each window pixel from the true center, rotated into the
    # rectangle's frame
    arf = ar.to(torch.float32)
    py = ((yi.to(torch.float32)[:, None] + arf) - cy[:, None])[:, :, None]
    px = ((xi.to(torch.float32)[:, None] + arf) - cx[:, None])[:, None, :]
    length, width, cos, sin = (t[:, None, None] for t in _rect_frame(marks))
    u = cos * py + sin * px
    v = -sin * py + cos * px
    interior = _in_rect(u, v, length, width, pad=-float(cfg.erode))
    rim = (_in_rect(u, v, length, width, pad=float(cfg.gap + cfg.dilation))
           & ~_in_rect(u, v, length, width, pad=float(cfg.gap)))

    def per_channel(ch):
        mean_in, var_in, cnt_in = _masked_stats(ch, interior)
        mean_out, var_out, cnt_out = _masked_stats(ch, rim)
        return _measure(cfg.measure, mean_in, var_in, cnt_in, mean_out,
                        var_out, cnt_out)

    fac = 1.0 if cfg.measure == "lafarge" else -1.0
    if cfg.rgb:
        val = sum(per_channel(patch[..., c]) for c in range(3))
    else:
        val = per_channel(patch[..., :3].mean(dim=-1))
    default = 10.0 if cfg.measure == "lafarge" else 0.0
    ok = interior.sum(dim=(-2, -1)) > 0
    return torch.where(ok, fac * val - cfg.thresh, default)


def _gradient_flat(grad, lanes, xy, marks, n_samples: int = 16,
                   thresh: float = 0.0):
    """Edge-normal gradient alignment of n points: ``n_samples`` points
    along each edge, the field's (d/dy, d/dx) dotted with the outward
    normal, -|mean|."""
    h, w = grad.shape[1:3]
    length, width, cos, sin = (t[:, None] for t in _rect_frame(marks))
    t = (torch.arange(n_samples, device=xy.device).to(torch.float32) + 0.5
         ) / n_samples - 0.5
    hu, hv = (length / 2).expand(-1, n_samples), (width / 2).expand(
        -1, n_samples)
    # the four edges in the local frame, in the JAX package's order
    u = torch.cat([hu, -hu, t * length, t * length], dim=-1)
    v = torch.cat([t * width, t * width, hv, -hv], dim=-1)
    # outward normals rotated: (cos, sin), (-cos, -sin), (-sin, cos),
    # (sin, -cos), n_samples each
    one = torch.ones_like(t)
    ny = torch.cat([cos * one, -cos * one, -sin * one, sin * one], dim=-1)
    nx = torch.cat([sin * one, -sin * one, cos * one, -cos * one], dim=-1)
    py = u * cos + v * -sin + xy[:, 0:1]
    px = u * sin + v * cos + xy[:, 1:2]
    yi = torch.clamp(torch.round(py).to(torch.int64), 0, h - 1)
    xi = torch.clamp(torch.round(px).to(torch.int64), 0, w - 1)
    g = grad[lanes[:, None], yi, xi]
    val = (g[..., 0] * ny + g[..., 1] * nx).mean(dim=-1)
    return -torch.abs(val) - thresh


def _over_points(fn, field, xy, marks, *args):
    """``fn`` over every point of lanes (B, ..., 2), ``CHUNK`` points per
    call: (B, ...)."""
    lead = xy.shape[:-1]
    lanes = torch.arange(lead[0], device=xy.device).reshape(
        (lead[0],) + (1,) * (len(lead) - 1)).expand(lead).reshape(-1)
    pts, mk = xy.reshape(-1, 2), marks.reshape(-1, 3)
    out = [fn(field, lanes[i:i + CHUNK], pts[i:i + CHUNK], mk[i:i + CHUNK],
              *args) for i in range(0, max(len(pts), 1), CHUNK)]
    return torch.cat(out).reshape(lead)


def contrast_energies(image, xy, marks, cfg: ContrastConfig) -> torch.Tensor:
    """Contrast energy of each rectangle: lane b's points (B, ..., 2) and
    marks (B, ..., 3) in lane b's image (B, H, W, 3); lower is a better
    contrast between the rectangle's interior and its rim."""
    return _over_points(_contrast_flat, image, xy, marks, cfg)


def gradient_energies(grad, xy, marks, thresh: float = 0.0) -> torch.Tensor:
    """Gradient alignment energy of each rectangle in lane b's gradient
    field (B, H, W, C >= 2, channels (d/dy, d/dx, ...))."""
    return _over_points(_gradient_flat, grad, xy, marks, 16, thresh)


def data_energies(data_term: str, cfg, image, xy, marks) -> torch.Tensor:
    """The CNN-free data column ``data_term`` ('contrast' or 'gradient')."""
    if data_term == "contrast":
        return contrast_energies(image, xy, marks, cfg or ContrastConfig())
    if data_term == "gradient":
        return gradient_energies(image, xy, marks)
    raise ValueError(data_term)
