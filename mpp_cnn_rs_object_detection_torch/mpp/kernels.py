"""RJMCMC proposal kernels: the 10-kernel mixture, laned over samples.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/kernels.py``:
``KernelData`` (normalised birth density, mark distributions, mixture
probabilities, scales), the value/class helpers the cell-parallel superstep
uses, and the sequential mixture -- uniform and data-driven birth and death,
gaussian and data-driven translation and mark transform, split and merge --
with ``sample_proposal`` and ``apply_proposal``.

The mixture is laned: a state carries (B, S) leading axes -- S samples of
each of B images -- and kernel data the B images' (B, ...) fields, which
each lane reads through its image index (no per-lane copy of the maps).
One call proposes for every lane, each lane with its own kernel: every
branch is evaluated for all lanes and each lane's proposal is selected by
its kernel index, as ``lax.switch`` under ``vmap`` does. A move is thus one
fixed launch sequence whatever the number of lanes.

A proposal is built in two steps: ``draw_variates`` draws every random
number of a move (``Variates``) and ``build_proposal`` turns them into the
proposal and its forward and backward log-densities, deterministically,
so the densities of a given draw can be evaluated on their own. Random
numbers come from one ``torch.Generator`` per call (Philox on CUDA), so
moves match the JAX package's in law, not draw for draw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    mapping_tensors,
    stack_param_dists,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import PointsState

EPS = 1e-16
MAX_DELTA = 8  # data-translation window half-size
WINDOW = 2 * MAX_DELTA + 1

# proposal kinds
NOOP, BIRTH, DEATH, MOVE, SPLIT, MERGE = 0, 1, 2, 3, 4, 5

# kernel indices in the mixture
K_UNIF_BIRTH, K_UNIF_DEATH, K_DATA_BIRTH, K_DATA_DEATH = 0, 1, 2, 3
K_GAUSS_TRL, K_DATA_TRL, K_GAUSS_TRF, K_DATA_TRF = 4, 5, 6, 7
K_SPLIT, K_MERGE = 8, 9

MERGE_RADIUS = 16.0
SPLIT_SHAPE_SIGMA = 0.1

BASE_KERNEL_WEIGHTS = {
    "bd_weight": 1.0,
    "uniform_bd_weight": 1.0,
    "data_bd_weight": 2.0,
    "ms_weight": 1.0,
    "translation_weight": 1.0,
    "gaussian_translation_weight": 1.0,
    "data_translation_weight": 2.0,
    "transformation_weight": 1.0,
    "gaussian_transformation_weight": 1.0,
    "data_transformation_weight": 2.0,
}


@dataclass
class KernelData:
    """Device-resident sampling inputs for one scene (the chain and the
    perturbations stack them on a leading axis, ``mpp/state.py``)."""

    birth_cdf: torch.Tensor          # (H*W,) cumsum of the normalised map
    log_birth_density: torch.Tensor  # (H, W)
    mark_dists: torch.Tensor         # (3, H, W, C) normalised
    padded_density: torch.Tensor     # (H + 2*MAX_DELTA, W + 2*MAX_DELTA)
    map_vmin: torch.Tensor           # (3,)
    map_vmax: torch.Tensor           # (3,)
    map_cyclic: torch.Tensor         # (3,) bool
    p_kernels: torch.Tensor          # (8,), or (10,) with split/merge
    log_norm_const: torch.Tensor     # log(H * W * C^3)
    intensity: torch.Tensor          # scalar
    sigma_trl: torch.Tensor          # scalar (2.0)
    sigma_trf: torch.Tensor          # (3,) = 0.1 * mark range


@dataclass
class Proposal:
    """A standardised move of every lane ((B, S, ...) fields). ``slot2``,
    ``xy2`` and ``marks2`` are active for SPLIT (the second new point's
    free slot) and MERGE (the second removed slot); other kinds set them
    to the first."""

    kind: torch.Tensor      # long: NOOP/BIRTH/DEATH/MOVE/SPLIT/MERGE
    slot: torch.Tensor      # long
    xy: torch.Tensor        # (..., 2)
    marks: torch.Tensor     # (..., 3)
    slot2: torch.Tensor     # long
    xy2: torch.Tensor       # (..., 2)
    marks2: torch.Tensor    # (..., 3)
    log_fwd: torch.Tensor
    log_back: torch.Tensor


@dataclass
class Variates:
    """Every random number of one move, per lane ((B, S, ...) fields);
    each kernel reads its own."""

    kernel: torch.Tensor    # long: the kernel of the mixture
    slot: torch.Tensor      # long: a uniform alive slot, -1 if none
    nb_slot: torch.Tensor   # long: merge's neighbour of ``slot``, -1 if none
    pixel_u: torch.Tensor   # (..., 2) long: the uniform birth's pixel
    marks_u: torch.Tensor   # (..., 3): the uniform birth's marks
    pixel_d: torch.Tensor   # (..., 2) long: the data birth's pixel
    cls_d: torch.Tensor     # (..., 3) long: the data birth's mark classes
    jitter: torch.Tensor    # (..., 5) in [0, 1): in-pixel (2), in-bin (3)
    z_trl: torch.Tensor     # (..., 2) standard normal: translation
    cell: torch.Tensor      # long: the data translation's window cell
    sub_trl: torch.Tensor   # (..., 2) in [0, 1): its in-pixel jitter
    pid: torch.Tensor       # long: the mark a transform changes
    z_trf: torch.Tensor     # standard normal: gaussian transform
    cls_trf: torch.Tensor   # long: the data transform's class
    sub_trf: torch.Tensor   # in [0, 1): its in-bin jitter
    u_rad: torch.Tensor     # in [0, 1): split radius
    u_ang: torch.Tensor     # in [0, 1): split angle
    z_shape: torch.Tensor   # (..., 3) standard normal: split marks


def kernel_probabilities(weights=None, use_split_merge: bool = False
                         ) -> np.ndarray:
    """The kernel mixture from the reference's decision tree: 8 kernels,
    or 10 with the split/merge pair."""
    w = dict(BASE_KERNEL_WEIGHTS, **(weights or {}))
    if use_split_merge:
        top = np.array([w["bd_weight"], w["ms_weight"],
                        w["translation_weight"], w["transformation_weight"]])
        p_bd, p_ms, p_trl, p_trf = top / top.sum()
    else:
        top = np.array([w["bd_weight"], w["translation_weight"],
                        w["transformation_weight"]])
        p_bd, p_trl, p_trf = top / top.sum()
        p_ms = 0.0
    bd = np.array([w["uniform_bd_weight"], w["data_bd_weight"]])
    p_bd_unif, p_bd_data = bd / bd.sum()
    trl = np.array([w["gaussian_translation_weight"],
                    w["data_translation_weight"]])
    p_trl_g, p_trl_d = trl / trl.sum()
    trf = np.array([w["gaussian_transformation_weight"],
                    w["data_transformation_weight"]])
    p_trf_g, p_trf_d = trf / trf.sum()
    p = [0.5 * p_bd * p_bd_unif, 0.5 * p_bd * p_bd_unif,
         0.5 * p_bd * p_bd_data, 0.5 * p_bd * p_bd_data,
         p_trl * p_trl_g, p_trl * p_trl_d, p_trf * p_trf_g, p_trf * p_trf_d]
    if use_split_merge:
        p += [0.5 * p_ms, 0.5 * p_ms]
    p = np.array(p)
    assert abs(p.sum() - 1.0) < 1e-8
    return p


def make_kernel_data(detection_map, mark_dist_maps, mappings,
                     intensity: float, kernel_weights=None,
                     use_split_merge: bool = False) -> KernelData:
    """Normalise the detection map and the mark distributions (device
    passes); ``mark_dist_maps`` is a list of 3 (H, W, C) maps or a stacked
    (3, H, W, C) tensor, whose device the outputs share."""
    dists = stack_param_dists(mark_dist_maps)
    dev = dists.device
    det = torch.clamp(torch.as_tensor(detection_map, dtype=torch.float32,
                                      device=dev), min=0.0)
    norm = det / torch.clamp(det.sum(), min=1e-30)
    dists = dists / torch.clamp(dists.sum(dim=-1, keepdim=True), min=1e-30)
    h, w = det.shape
    c = dists.shape[-1]
    vmin, vmax, cyclic = mapping_tensors(mappings, dev)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    return KernelData(
        birth_cdf=torch.cumsum(norm.reshape(-1), dim=0),
        log_birth_density=torch.log(norm + EPS),
        mark_dists=dists,
        padded_density=F.pad(norm, (MAX_DELTA,) * 4),
        map_vmin=vmin, map_vmax=vmax, map_cyclic=cyclic,
        p_kernels=torch.as_tensor(
            kernel_probabilities(kernel_weights, use_split_merge),
            dtype=torch.float32, device=dev),
        log_norm_const=scalar(np.log(float(h * w * c ** 3))),
        intensity=scalar(intensity),
        sigma_trl=scalar(2.0),
        sigma_trf=torch.tensor([0.1 * (m.v_max - m.v_min) for m in mappings],
                               dtype=torch.float32, device=dev),
    )


# ------------------------------------------------------------------ helpers


def _log(x):
    return torch.log(x + EPS)


def _class_to_value(vmin, vmax, n_cls: int, cls) -> torch.Tensor:
    """Bin left edge of ``cls`` for ranges ``vmin``/``vmax`` broadcast
    against it."""
    return vmin + cls.float() * ((vmax - vmin) / n_cls)


def _value_to_class(vmin, vmax, cyclic, n_cls: int, value) -> torch.Tensor:
    rng = vmax - vmin
    val = torch.where(cyclic, ((value - vmin) % rng) + vmin, value)
    cls = torch.floor((val - vmin) / (rng / n_cls)).long()
    return torch.clamp(cls, 0, n_cls - 1)


def _normal_logpdf(x, sigma):
    return -0.5 * (x / sigma) ** 2 - torch.log(sigma * math.sqrt(2.0 * math.pi))


def _categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Draw along the last dim with weights ``probs + EPS`` -- the law of
    ``jax.random.categorical(key, log(probs + EPS))`` -- by inverting the
    CDF at ``u`` in (0, 1]."""
    cdf = torch.cumsum(probs + EPS, dim=-1)
    idx = (cdf < u[..., None] * cdf[..., -1:]).sum(dim=-1)
    return torch.clamp(idx, max=probs.shape[-1] - 1)


def _windows(img: torch.Tensor, lead: tuple, r0: torch.Tensor,
             c0: torch.Tensor, ar: torch.Tensor) -> torch.Tensor:
    """(B, m, size, size) windows, ``size = len(ar)`` (``ar`` its arange),
    starting at (r0, c0) (each (B, m)) of ``img``, whose leading axes
    ``lead`` indexes: the lane of a (B, H, W) image, or the lane and the
    cell of a (B, m, H, W) one. Starts are clamped into range as
    ``lax.dynamic_slice`` does."""
    hh, ww = img.shape[-2], img.shape[-1]
    size = ar.shape[0]
    r0 = torch.clamp(r0, 0, hh - size)
    c0 = torch.clamp(c0, 0, ww - size)
    rows = (r0[..., None] + ar)[..., :, None]
    cols = (c0[..., None] + ar)[..., None, :]
    return img[lead + (rows, cols)]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last dim (idx broadcast over trailing dims)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _slot_rows(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each lane's row ``slot`` of x (B, S, K, F): (B, S, F)."""
    idx = slot[..., None, None].expand(slot.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, idx)[..., 0, :]


class _Lanes:
    """Per-lane views of (B, ...) kernel data for (B, S) lanes: image
    index, ranges, scales and the kernels' log-probabilities."""

    def __init__(self, state: PointsState, kd: KernelData):
        b = state.xy.shape[0]
        dev = state.xy.device
        self.img = torch.arange(b, device=dev)[:, None]  # (B, 1)
        self.mark3 = torch.arange(3, device=dev)
        self.ar_window = torch.arange(WINDOW, device=dev)
        self.h, self.w = kd.log_birth_density.shape[-2:]
        self.n_cls = kd.mark_dists.shape[-1]
        self.vmin = kd.map_vmin[:, None, :]   # (B, 1, 3)
        self.vmax = kd.map_vmax[:, None, :]
        self.cyclic = kd.map_cyclic[:, None, :]
        self.log_p = _log(kd.p_kernels)[:, None, :]  # (B, 1, n_k)
        self.log_intensity = _log(kd.intensity)[:, None]
        self.hw_max = torch.tensor([self.h - 1, self.w - 1],
                                   dtype=torch.float32, device=dev)

    def at(self, v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Lane values of per-image (B, 3) ``v`` at mark index ``idx``."""
        return v[self.img, idx]

    def pixel_of(self, xy: torch.Tensor):
        xi = torch.clamp(xy[..., 0].long(), 0, self.h - 1)
        yi = torch.clamp(xy[..., 1].long(), 0, self.w - 1)
        return xi, yi

    def mark_rows(self, kd: KernelData, xi, yi) -> torch.Tensor:
        """The (B, S, 3, C) mark distributions at each lane's pixel."""
        return kd.mark_dists[self.img[..., None], self.mark3,
                             xi[..., None], yi[..., None]]

    def window_probs(self, kd: KernelData, xi, yi) -> torch.Tensor:
        """(B, S, WINDOW, WINDOW) renormalised local density windows
        centred at (xi, yi) of the zero-padded density (starts clamped
        into range, as ``lax.dynamic_slice`` clamps them)."""
        win = _windows(kd.padded_density, (self.img[..., None, None],), xi,
                       yi, self.ar_window)
        return win / (win.sum(dim=(-2, -1)) + EPS)[..., None, None]

    def clip_marks(self, marks: torch.Tensor) -> torch.Tensor:
        """Cyclic wrap for the angle, min/max clamp otherwise."""
        wrapped = ((marks - self.vmin) % (self.vmax - self.vmin)) + self.vmin
        clamped = torch.minimum(torch.maximum(marks, self.vmin), self.vmax)
        return torch.where(self.cyclic, wrapped, clamped)

    def clip_xy(self, xy: torch.Tensor) -> torch.Tensor:
        return torch.minimum(torch.clamp(xy, min=0.0), self.hw_max)


def _log_q_data(kd: KernelData, ln: _Lanes, xi, yi, cls) -> torch.Tensor:
    """Data-driven birth density of a point at pixel (xi, yi) with mark
    classes ``cls`` (..., 3): det_norm * prod_m dist_m * H W C^3."""
    rows = ln.mark_rows(kd, xi, yi)
    return (kd.log_birth_density[ln.img, xi, yi]
            + _log(_take(rows, cls)).sum(dim=-1)
            + kd.log_norm_const[:, None])


def _split_logpdf(ln: _Lanes, shape_delta: torch.Tensor) -> torch.Tensor:
    """Log-density of a split displacement: uniform on the disk times
    per-mark gaussians."""
    sigmas = SPLIT_SHAPE_SIGMA * (ln.vmax - ln.vmin)
    return (-math.log(math.pi * MERGE_RADIUS ** 2)
            + _normal_logpdf(shape_delta, sigmas).sum(dim=-1))


def _neighbours(state: PointsState, xy: torch.Tensor, exclude: torch.Tensor
                ) -> torch.Tensor:
    """(B, S, K) alive points within MERGE_RADIUS of each lane's ``xy``,
    slot ``exclude`` left out."""
    d = torch.linalg.vector_norm(state.xy - xy[..., None, :], dim=-1)
    k = torch.arange(state.capacity, device=xy.device)
    return state.alive & (d <= MERGE_RADIUS) & (k != exclude[..., None])


# ------------------------------------------------------------------ drawing


def draw_variates(gen: torch.Generator, state: PointsState, kd: KernelData
                  ) -> Variates:
    """Every random number of one move of every lane (three draws of the
    generator): the kernel from ``p_kernels``, a uniform alive slot and
    merge's uniform neighbour of it, and each kernel's own variates --
    pixel and classes from the data densities, window cells, uniforms and
    normals."""
    return variates_from(draw_raw(gen, state.alive.shape, state.xy.device),
                         state, kd)


def draw_raw(gen: torch.Generator, lead, device):
    """``draw_variates``' three draws for states of alive-mask shape
    ``lead``: (uniforms (..., 23), noise (2, ...lead), normals (..., 6));
    the lanes lead the uniforms and normals, and follow the noise's 2."""
    return (torch.rand(tuple(lead[:-1]) + (23,), generator=gen,
                       device=device),
            torch.rand((2,) + tuple(lead), generator=gen, device=device),
            torch.randn(tuple(lead[:-1]) + (6,), generator=gen,
                        device=device))


def variates_from(raw, state: PointsState, kd: KernelData) -> Variates:
    """The variates of ``draw_variates`` built from its raw draws."""
    u, noise, z = raw
    ln = _Lanes(state, kd)
    lead = state.alive.shape
    dev = state.xy.device
    n_k = kd.p_kernels.shape[-1]

    kernel = _categorical(kd.p_kernels[:, None, :].expand(
        lead[:-1] + (n_k,)), 1.0 - u[..., 0])
    slot = torch.argmax(torch.where(state.alive, noise[0], -1.0), dim=-1)
    slot = torch.where(state.alive.any(dim=-1), slot, -1)
    safe = torch.clamp(slot, min=0)
    sxy = _slot_rows(state.xy, safe)
    nb_slot = torch.full_like(slot, -1)
    if n_k == 10:  # merge: a uniform neighbour of the slot
        nb = _neighbours(state, sxy, safe)
        nb_slot = torch.where(nb.any(dim=-1), torch.argmax(
            torch.where(nb, noise[1], -1.0), dim=-1), -1)

    hw = torch.tensor([ln.h, ln.w], device=dev)
    pixel_u = torch.minimum((u[..., 1:3] * hw).long(), hw - 1)
    marks_u = ln.vmin + u[..., 3:6] * (ln.vmax - ln.vmin)
    cdf = kd.birth_cdf
    if cdf.stride(0) == 0:  # lanes that share one image's maps
        cdf = cdf[0]
    idx = torch.searchsorted(cdf, u[..., 6].contiguous())
    idx = torch.clamp(idx, 0, ln.h * ln.w - 1)
    pixel_d = torch.stack([idx // ln.w, idx % ln.w], dim=-1)
    cls_d = _categorical(ln.mark_rows(kd, pixel_d[..., 0], pixel_d[..., 1]),
                         1.0 - u[..., 7:10])
    xi, yi = ln.pixel_of(sxy)
    wprob = ln.window_probs(kd, xi, yi).flatten(-2)
    cell = _categorical(wprob, 1.0 - u[..., 10])
    pid = torch.clamp((u[..., 11] * 3).long(), max=2)
    row = ln.mark_rows(kd, xi, yi)
    row = torch.gather(row, -2, pid[..., None, None].expand(
        pid.shape + (1, row.shape[-1])))[..., 0, :]
    cls_trf = _categorical(row, 1.0 - u[..., 12])
    return Variates(
        kernel=kernel, slot=slot, nb_slot=nb_slot, pixel_u=pixel_u,
        marks_u=marks_u, pixel_d=pixel_d, cls_d=cls_d, jitter=u[..., 13:18],
        z_trl=z[..., 0:2], cell=cell, sub_trl=u[..., 18:20], pid=pid,
        z_trf=z[..., 2], cls_trf=cls_trf, sub_trf=u[..., 20],
        u_rad=u[..., 21], u_ang=u[..., 22], z_shape=z[..., 3:6])


# ----------------------------------------------------------------- building


def _branch(kind, slot, xy, marks, log_fwd, log_back, invalid,
            slot2=None, xy2=None, marks2=None):
    return (Proposal(kind=torch.full_like(slot, kind), slot=slot, xy=xy,
                     marks=marks, slot2=slot if slot2 is None else slot2,
                     xy2=xy if xy2 is None else xy2,
                     marks2=marks if marks2 is None else marks2,
                     log_fwd=log_fwd, log_back=log_back), invalid)


def build_proposal(v: Variates, state: PointsState, kd: KernelData
                   ) -> Proposal:
    """Each lane's proposal of kernel ``v.kernel`` from its variates, with
    its forward and backward log-densities (the Green ratio's): every
    kernel's branch is built for every lane, and each lane takes its own.
    A move that cannot apply (no point to pick, a full state, no merge
    neighbour) is a no-op carrying its kernel's log-probability."""
    ln = _Lanes(state, kd)
    n_k = kd.p_kernels.shape[-1]
    lp = [ln.log_p[..., i] for i in range(n_k)]
    nf = state.n_points.float()
    log_n = _log(nf)
    none = v.slot < 0
    safe = torch.clamp(v.slot, min=0)
    sxy = _slot_rows(state.xy, safe)
    smk = _slot_rows(state.marks, safe)
    full = state.alive.all(dim=-1)
    free = torch.argmax((~state.alive).to(torch.uint8), dim=-1)
    steps = (ln.vmax - ln.vmin) / ln.n_cls
    branches = []

    # ---- births (uniform, data) and deaths (uniform, data)
    back_birth = [lp[k] - _log(nf + 1.0) for k in (0, 2)]
    xy_b = v.pixel_u.float() + v.jitter[..., :2]
    branches.append(_branch(BIRTH, free, xy_b, v.marks_u,
                            lp[0] - ln.log_intensity, back_birth[0], full))
    branches.append(_branch(DEATH, safe, sxy, smk, lp[1] - log_n,
                            lp[1] - ln.log_intensity, none))
    xd, yd = v.pixel_d[..., 0], v.pixel_d[..., 1]
    marks_d = (_class_to_value(ln.vmin, ln.vmax, ln.n_cls, v.cls_d)
               + v.jitter[..., 2:5] * steps)
    log_q = _log_q_data(kd, ln, xd, yd, v.cls_d)
    branches.append(_branch(
        BIRTH, free, v.pixel_d.float() + v.jitter[..., :2], marks_d,
        lp[2] + log_q - ln.log_intensity, back_birth[1], full))
    xi, yi = ln.pixel_of(sxy)
    scls = _value_to_class(ln.vmin, ln.vmax, ln.cyclic, ln.n_cls, smk)
    branches.append(_branch(
        DEATH, safe, sxy, smk, lp[3] - log_n,
        lp[3] + _log_q_data(kd, ln, xi, yi, scls) - ln.log_intensity, none))

    # ---- translations: gaussian (clipped), data window
    sigma_trl = kd.sigma_trl[:, None, None]
    delta = sigma_trl * v.z_trl
    g_logp = (lp[4] + _normal_logpdf(delta, sigma_trl).sum(dim=-1)
              - log_n)
    branches.append(_branch(MOVE, safe, ln.clip_xy(sxy + delta), smk,
                            g_logp, g_logp, none))
    wprob = ln.window_probs(kd, xi, yi)
    di, dj = v.cell // WINDOW, v.cell % WINDOW
    new_x, new_y = xi + di - MAX_DELTA, yi + dj - MAX_DELTA
    wprob_b = ln.window_probs(kd, new_x, new_y)
    fwd = lp[5] + _log(wprob.flatten(-2).gather(-1, v.cell[..., None])[
        ..., 0]) - log_n
    back_cell = (xi - new_x + MAX_DELTA) * WINDOW + (yi - new_y + MAX_DELTA)
    back = lp[5] + _log(wprob_b.flatten(-2).gather(
        -1, back_cell[..., None])[..., 0]) - log_n
    xy_trl = torch.stack([new_x, new_y], dim=-1).float() + v.sub_trl
    branches.append(_branch(MOVE, safe, xy_trl, smk, fwd, back, none))

    # ---- mark transforms of one mark: gaussian (wrap / clamp), data row
    pid = v.pid
    vmin, vmax = ln.at(kd.map_vmin, pid), ln.at(kd.map_vmax, pid)
    sigma = ln.at(kd.sigma_trf, pid)
    mdelta = sigma * v.z_trf
    old = _take(smk, pid)
    new_val = torch.where(
        ln.at(kd.map_cyclic, pid), ((old + mdelta) % (vmax - vmin)) + vmin,
        torch.minimum(torch.maximum(old + mdelta, vmin), vmax))
    g_logp = lp[6] + _normal_logpdf(mdelta, sigma) - log_n
    branches.append(_branch(
        MOVE, safe, sxy, smk.scatter(-1, pid[..., None], new_val[..., None]),
        g_logp, g_logp, none))
    row = ln.mark_rows(kd, xi, yi)
    row = torch.gather(row, -2, pid[..., None, None].expand(
        pid.shape + (1, row.shape[-1])))[..., 0, :]
    step = (vmax - vmin) / ln.n_cls
    d_val = (_class_to_value(vmin, vmax, ln.n_cls, v.cls_trf)
             + v.sub_trf * step)
    branches.append(_branch(
        MOVE, safe, sxy, smk.scatter(-1, pid[..., None], d_val[..., None]),
        lp[7] + _log(_take(row, v.cls_trf)) - log_n,
        lp[7] + _log(_take(row, _take(scls, pid))) - log_n, none))

    if n_k == 10:
        # ---- split into two at +-delta; merge with a neighbour
        rho = MERGE_RADIUS * torch.sqrt(v.u_rad)
        theta = v.u_ang * float(np.float32(np.pi / 2))
        pos_delta = rho[..., None] * torch.stack(
            [torch.cos(theta), torch.sin(theta)], dim=-1)
        shape_delta = SPLIT_SHAPE_SIGMA * (ln.vmax - ln.vmin) * v.z_shape
        xy_a, xy_b = ln.clip_xy(sxy - pos_delta), ln.clip_xy(sxy + pos_delta)
        fwd = (lp[8] - log_n + _split_logpdf(ln, shape_delta)
               - ln.log_intensity)
        nn_a = _neighbours(state, xy_a, safe).sum(dim=-1) + 1
        nn_b = _neighbours(state, xy_b, safe).sum(dim=-1) + 1
        back = lp[9] + _log((1.0 / (nf + 1.0)) * (1.0 / nn_a + 1.0 / nn_b))
        branches.append(_branch(
            SPLIT, safe, xy_a, ln.clip_marks(smk - shape_delta), fwd, back,
            none | full, slot2=free, xy2=xy_b,
            marks2=ln.clip_marks(smk + shape_delta)))
        n_nb = _neighbours(state, sxy, safe).sum(dim=-1)
        nb = torch.where(n_nb > 0, torch.clamp(v.nb_slot, min=0), safe)
        nxy, nmk = _slot_rows(state.xy, nb), _slot_rows(state.marks, nb)
        fwd = lp[9] - log_n - _log(n_nb.float())
        back = (lp[8] - _log(nf - 1.0)
                + _split_logpdf(ln, (smk - nmk) / 2.0) - ln.log_intensity)
        branches.append(_branch(
            MERGE, safe, ln.clip_xy((sxy + nxy) / 2.0),
            ln.clip_marks((smk + nmk) / 2.0), fwd, back,
            none | (nf < 2) | (n_nb == 0), slot2=nb, xy2=nxy, marks2=nmk))

    return _select(v.kernel, branches, _take(ln.log_p.expand(
        v.kernel.shape + (n_k,)), v.kernel))


def _select(kernel: torch.Tensor, branches, log_p_kernel: torch.Tensor
            ) -> Proposal:
    """Each lane's branch by its kernel index; a lane whose branch is
    invalid gets the no-op (slot 0, xy 0, marks 1) with its kernel's
    log-probability as both densities."""
    props = [p for p, _ in branches]
    invalid = torch.stack([iv.expand(kernel.shape) for _, iv in branches])
    invalid = invalid.gather(0, kernel[None])[0]
    out = {}
    for f in fields(Proposal):
        parts = [getattr(p, f.name) for p in props]
        tail = parts[0].shape[kernel.ndim:]
        stacked = torch.stack([x.expand(kernel.shape + tail) for x in parts])
        idx = kernel.reshape((1,) + kernel.shape + (1,) * len(tail))
        out[f.name] = stacked.gather(0, idx.expand(
            (1,) + kernel.shape + tail))[0]
    inv = invalid
    return Proposal(
        kind=torch.where(inv, NOOP, out["kind"]),
        slot=torch.where(inv, 0, out["slot"]),
        xy=torch.where(inv[..., None], 0.0, out["xy"]),
        marks=torch.where(inv[..., None], 1.0, out["marks"]),
        slot2=torch.where(inv, 0, out["slot2"]),
        xy2=torch.where(inv[..., None], 0.0, out["xy2"]),
        marks2=torch.where(inv[..., None], 1.0, out["marks2"]),
        log_fwd=torch.where(inv, log_p_kernel, out["log_fwd"]),
        log_back=torch.where(inv, log_p_kernel, out["log_back"]))


def sample_proposal(gen: torch.Generator, state: PointsState,
                    kd: KernelData) -> Proposal:
    """One proposal per lane, each lane's kernel drawn from the mixture."""
    return build_proposal(draw_variates(gen, state, kd), state, kd)


def _set_rows(x: torch.Tensor, slot: torch.Tensor, value: torch.Tensor,
              write: torch.Tensor) -> torch.Tensor:
    """x (B, S, K, F) with each lane's row ``slot`` set to ``value`` where
    ``write``."""
    idx = slot[..., None, None].expand(slot.shape + (1, x.shape[-1]))
    keep = torch.gather(x, -2, idx)[..., 0, :]
    return x.scatter(-2, idx, torch.where(write[..., None], value,
                                          keep)[..., None, :])


def apply_proposal(state: PointsState, prop: Proposal) -> PointsState:
    """Apply each lane's proposal; a NOOP leaves its lane intact."""
    cap = state.capacity
    slot = torch.clamp(prop.slot, 0, cap - 1)
    slot2 = torch.clamp(prop.slot2, 0, cap - 1)
    kind = prop.kind
    write1 = ((kind == BIRTH) | (kind == MOVE) | (kind == SPLIT)
              | (kind == MERGE))
    write2 = kind == SPLIT
    xy = _set_rows(_set_rows(state.xy, slot, prop.xy, write1), slot2,
                   prop.xy2, write2)
    marks = _set_rows(_set_rows(state.marks, slot, prop.marks, write1),
                      slot2, prop.marks2, write2)
    alive = state.alive
    a1 = torch.where((kind == BIRTH) | (kind == SPLIT), True,
                     torch.where(kind == DEATH, False,
                                 alive.gather(-1, slot[..., None])[..., 0]))
    alive = alive.scatter(-1, slot[..., None], a1[..., None])
    a2 = torch.where(kind == SPLIT, True,
                     torch.where(kind == MERGE, False,
                                 alive.gather(-1, slot2[..., None])[..., 0]))
    alive = alive.scatter(-1, slot2[..., None], a2[..., None])
    return state.replace(xy=xy, marks=marks, alive=alive)
