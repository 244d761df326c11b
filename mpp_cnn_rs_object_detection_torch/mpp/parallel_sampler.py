"""Cell-parallel RJMCMC: many non-interacting MH moves per superstep.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/parallel_sampler.py``
(data moves on by default; the split/merge pair and the switched move type
as options).
Each superstep jitters a grid of CELL x CELL cells spaced 2*CELL apart; every
active cell proposes one birth / death / translation / mark transform
confined to the cell, all proposals are scored exactly against the same base
state (top-2 leave-one-out statistics of the cached pair rows), accepted
independently and applied in one batched scatter.

The chain runs B lanes at once -- the scenes of a batch, or the restarts
of one scene -- on a leading axis of the state, the cache and the maps
(``mpp/state.py``): the lanes' m cells fold into one (B, m) batch of
proposals, so a superstep is one launch sequence whatever B is. Lane b
draws its numbers from its own ``torch.Generator`` in the order a one-lane
chain draws them, so lane b of a batch is, draw for draw, the one-lane
chain with that generator (the JAX batched run's contract, where the lanes
are vmapped).

Every superstep is a fixed sequence of tensor operations on fixed shapes:
the masks of the JAX version are kept, no value is read back to the host,
and rejected proposals scatter into their lane's scratch row that is
dropped afterwards (a scatter is unordered when indices repeat).
Random numbers come from Philox on CUDA, so chains match the JAX package's
statistically, not draw for draw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
    EnergyCombiner,
    combine,
)
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
    unary_terms,
)
from mpp_cnn_rs_object_detection_torch.mpp.kernels import (
    EPS,
    MAX_DELTA,
    MERGE_RADIUS,
    SPLIT_SHAPE_SIGMA,
    WINDOW,
    KernelData,
    _categorical,
    _class_to_value,
    _log,
    _normal_logpdf,
    _take,
    _value_to_class,
    _windows,
)
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    ChainStats,
    EnergyCache,
    build_cache,
    energy_from_cache,
    pair_masks,
    pair_rows,
    vec_cols,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    expand_lanes,
    lane,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import (
    convex_quad_intersection_area,
    marks_to_poly,
    rect_area,
)

# Active cells are CELL x CELL squares spaced 2*CELL apart, so concurrent
# proposals are > CELL apart: CELL must cover the max interaction radius.
CELL = 32

# per-cell move mixture; within translations / mark transforms the data
# moves take 2/3 (the reference mixture's 1:2 gaussian:data weighting)
P_BIRTH, P_DEATH, P_TRL, P_TRF = 0.25, 0.25, 0.25, 0.25
P_DATA_SUB = 2.0 / 3.0
# with the split/merge pair: each base family, and split and merge
P_SM_BASE, P_SM = 0.2, 0.1


@dataclass
class MapView:
    """Sampling maps as seen by the superstep (the whole scene here), with
    the lane axis leading.

    ``cell_density`` is the normalised detection map zero-padded by CELL on
    every side (rows start at ``row0_cd = -CELL``)."""

    cell_density: torch.Tensor  # (B, H + 2 CELL, W + 2 CELL)
    mark_dists: torch.Tensor    # (B, 3, H, W, C)
    position: torch.Tensor
    mark_maps: torch.Tensor
    row0_cd: int
    row0_md: int


def make_local_view(kd: KernelData, maps: EnergyMaps) -> MapView:
    return MapView(
        cell_density=F.pad(torch.exp(kd.log_birth_density), (CELL,) * 4),
        mark_dists=kd.mark_dists, position=maps.position,
        mark_maps=maps.mark_maps, row0_cd=-CELL, row0_md=0,
    )


@dataclass
class _Index:
    """Index tensors of a superstep over B lanes of m cells, made once per
    chain: a superstep reuses them instead of launching its own aranges."""

    lane: torch.Tensor    # (B, 1)
    cell: torch.Tensor    # (1, m)
    mark3: torch.Tensor   # (1, 1, 3)
    ar_cell: torch.Tensor    # (CELL,)
    ar_window: torch.Tensor  # (WINDOW,)

    @classmethod
    def make(cls, n_lanes: int, m: int, device) -> "_Index":
        return cls(lane=torch.arange(n_lanes, device=device)[:, None],
                   cell=torch.arange(m, device=device)[None, :],
                   mark3=torch.arange(3, device=device)[None, None, :],
                   ar_cell=torch.arange(CELL, device=device),
                   ar_window=torch.arange(WINDOW, device=device))


def _draw(gens, fn, *shape, device, **kw) -> torch.Tensor:
    """Lane b's numbers from lane b's generator, stacked: (B, *shape). Each
    lane draws what a one-lane chain with its generator draws."""
    if len(gens) == 1:
        return fn(*shape, generator=gens[0], device=device, **kw)[None]
    return torch.stack([fn(*shape, generator=g, device=device, **kw)
                        for g in gens])


def _rand(gens, *shape, device):
    return _draw(gens, torch.rand, shape, device=device)


def _randn(gens, *shape, device):
    return _draw(gens, torch.randn, shape, device=device)


def _randint(gens, low: int, high: int, *shape, device):
    return _draw(gens, torch.randint, low, high, shape, device=device)


def _lane_rows(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Row indices ``idx`` (B, m) broadcast over the trailing axes of
    ``like`` (B, K, ...): a gather / scatter index along axis 1."""
    tail = tuple(like.shape[2:])
    return idx.reshape(idx.shape + (1,) * len(tail)).expand(
        tuple(idx.shape) + tail)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane rows: x (B, K, ...) at idx (B, m) -> (B, m, ...)."""
    return torch.gather(x, 1, _lane_rows(idx, x))


@dataclass
class _Cells:
    """What every move family of a superstep's cells reads: the cells'
    extents, the points in them, the picked point (uniform among the
    cell's points) and the cell's window of the birth density, over the
    (B, m) lanes and cells."""

    h: int
    w: int
    view: MapView
    kd: KernelData
    ix: _Index
    y0: torch.Tensor
    x0: torch.Tensor
    free_slot: torch.Tensor
    free_ok: torch.Tensor
    lo: torch.Tensor        # (B, m, 2) the cell's first pixel
    hi: torch.Tensor        # (B, m, 2) the cell's last pixel
    area: torch.Tensor
    cell_ok: torch.Tensor
    in_cell: torch.Tensor   # (B, m, K)
    n_cell: torch.Tensor
    pick_ok: torch.Tensor
    safe_slot: torch.Tensor  # the picked point (0 where the cell is empty)
    sxy: torch.Tensor
    smk: torch.Tensor
    lam_cell: torch.Tensor
    win: torch.Tensor       # (B, m, CELL, CELL) birth density
    win_sum: torch.Tensor
    win_prob: torch.Tensor

    @classmethod
    def make(cls, state: PointsState, kd: KernelData, view: MapView,
             ix: _Index, h: int, w: int, y0, x0, free_slot, free_ok,
             u_pick: torch.Tensor) -> "_Cells":
        """``u_pick`` (B, m, K): the uniforms that pick a cell's point."""
        ylo, xlo = torch.clamp(y0, 0, h), torch.clamp(x0, 0, w)
        yhi, xhi = torch.clamp(y0 + CELL, 0, h), torch.clamp(x0 + CELL, 0, w)
        area = torch.clamp((yhi - ylo) * (xhi - xlo), min=0).float()
        px_all = state.xy[:, None, :, 0]
        py_all = state.xy[:, None, :, 1]
        in_cell = (state.alive[:, None, :]
                   & (px_all >= ylo[..., None]) & (px_all < yhi[..., None])
                   & (py_all >= xlo[..., None]) & (py_all < xhi[..., None]))
        n_cell = in_cell.sum(dim=-1).float()
        # uniform among the cell's points: argmax of masked uniform noise
        pick = torch.argmax(torch.where(in_cell, u_pick, -1.0), dim=-1)
        pick_ok = n_cell > 0
        safe_slot = torch.where(pick_ok, pick, 0)
        win = _windows(view.cell_density, (ix.lane[..., None, None],),
                       y0 - view.row0_cd, x0 + CELL, ix.ar_cell)
        win_sum = win.sum(dim=(-2, -1))
        return cls(
            h=h, w=w, view=view, kd=kd, ix=ix, y0=y0, x0=x0,
            free_slot=free_slot, free_ok=free_ok,
            lo=torch.stack([ylo, xlo], dim=-1).float(),
            hi=torch.stack([yhi - 1, xhi - 1], dim=-1).float(),
            area=area, cell_ok=area > 0, in_cell=in_cell, n_cell=n_cell,
            pick_ok=pick_ok, safe_slot=safe_slot,
            sxy=_rows(state.xy, safe_slot), smk=_rows(state.marks, safe_slot),
            lam_cell=kd.intensity[:, None] * area / float(h * w),
            win=win, win_sum=win_sum,
            win_prob=win / (win_sum + EPS)[..., None, None])

    @property
    def n_classes(self) -> int:
        return self.view.mark_dists.shape[-1]

    def mark_rows(self, yi, xi) -> torch.Tensor:
        """The three marks' class distributions at pixels (yi, xi):
        (B, m, 3, C)."""
        yi_l = torch.clamp(yi - self.view.row0_md, 0,
                           self.view.mark_dists.shape[-3] - 1)
        return self.view.mark_dists[self.ix.lane[..., None], self.ix.mark3,
                                    yi_l[..., None], xi[..., None]]


@dataclass
class _Picked:
    """The picked point's pixel, its marks' class rows and classes, and
    its place in the cell's window."""

    rows: torch.Tensor   # (B, m, 3, C)
    cls: torch.Tensor    # (B, m, 3)
    win_y: torch.Tensor
    win_x: torch.Tensor

    @classmethod
    def make(cls, c: _Cells) -> "_Picked":
        yi = torch.clamp(c.sxy[..., 0].long(), 0, c.h - 1)
        xi = torch.clamp(c.sxy[..., 1].long(), 0, c.w - 1)
        kd = c.kd
        return cls(rows=c.mark_rows(yi, xi),
                   cls=_value_to_class(kd.map_vmin[:, None, :],
                                       kd.map_vmax[:, None, :],
                                       kd.map_cyclic[:, None, :],
                                       c.n_classes, c.smk),
                   win_y=torch.clamp(yi - c.y0, 0, CELL - 1),
                   win_x=torch.clamp(xi - c.x0, 0, CELL - 1))


def _birth(c: _Cells, u_pos, u_jit, u_cls, u_mjit):
    """Birth: a pixel of the cell's window of the detection density
    (``u_pos`` (B, m)) with a uniform jitter in it (``u_jit`` (B, m, 2)),
    each mark's class from its pixel distribution (``u_cls`` (B, m, 3)) with
    a uniform jitter in the class (``u_mjit``). Returns (ok, xy, marks,
    log_fwd, log_back)."""
    b, m = c.y0.shape
    vmin_l, vmax_l = c.kd.map_vmin[:, None, :], c.kd.map_vmax[:, None, :]
    flat = c.win_prob.reshape(b, m, -1)
    cell_idx = _categorical(flat, 1.0 - u_pos)
    py = (c.y0 + cell_idx // CELL).float() + u_jit[..., 0]
    px = (c.x0 + cell_idx % CELL).float() + u_jit[..., 1]
    rows = c.mark_rows(torch.clamp(py.long(), 0, c.h - 1),
                       torch.clamp(px.long(), 0, c.w - 1))
    n_classes = c.n_classes
    cls = _categorical(rows, 1.0 - u_cls)
    steps = (vmax_l - vmin_l) / n_classes
    marks = vmin_l + cls.float() * steps + u_mjit * steps
    log_q = (_log(_take(flat, cell_idx)) + _log(c.area)
             + _log(_take(rows, cls)).sum(dim=-1)
             + 3 * math.log(float(n_classes)))
    ok = c.cell_ok & c.free_ok & (c.win_sum > 1e-12)
    return (ok, torch.stack([py, px], dim=-1), marks,
            math.log(P_BIRTH) + log_q - _log(c.lam_cell),
            math.log(P_DEATH) - _log(c.n_cell + 1.0))


def _death(c: _Cells, p: _Picked):
    """Death of the picked point: (log_fwd, log_back), the reverse being
    the birth of that point."""
    log_q = (_log(c.win_prob[c.ix.lane, c.ix.cell, p.win_y, p.win_x])
             + _log(c.area) + _log(_take(p.rows, p.cls)).sum(dim=-1)
             + 3 * math.log(float(c.n_classes)))
    return (math.log(P_DEATH) - _log(c.n_cell),
            math.log(P_BIRTH) + log_q - _log(c.lam_cell))


def _gauss_translation(c: _Cells, z):
    """The picked point moved by ``sigma_trl * z`` (``z`` (B, m, 2)) and
    clipped to the cell: (xy, log_q), the same both ways."""
    sigma = c.kd.sigma_trl[:, None, None]
    delta = sigma * z
    xy = torch.minimum(torch.maximum(c.sxy + delta, c.lo), c.hi)
    return xy, (math.log(P_TRL) + _normal_logpdf(delta, sigma).sum(dim=-1)
                - _log(c.n_cell))


def _gauss_transform(c: _Cells, pid, z):
    """Mark ``pid`` of the picked point moved by ``sigma_trf * z``
    (wrapped where cyclic, else clamped): (marks, log_q), the same both
    ways."""
    kd, lane = c.kd, c.ix.lane
    sigma = kd.sigma_trf[lane, pid]
    delta = sigma * z
    old = _take(c.smk, pid)
    vmin, vmax = kd.map_vmin[lane, pid], kd.map_vmax[lane, pid]
    new = torch.where(kd.map_cyclic[lane, pid],
                      ((old + delta) % (vmax - vmin)) + vmin,
                      torch.minimum(torch.maximum(old + delta, vmin), vmax))
    return (c.smk.scatter(-1, pid[..., None], new[..., None]),
            math.log(P_TRF) + _normal_logpdf(delta, sigma) - _log(c.n_cell))


def _data_translation(c: _Cells, p: _Picked, u_idx, u_jit):
    """The picked point's pixel resampled from the WINDOW patch of the
    cell's density around it (zero outside the cell; ``u_idx`` (B, m)),
    with a uniform jitter (``u_jit`` (B, m, 2)). Returns (valid, xy,
    log_fwd, log_back)."""
    b, m = c.y0.shape
    by_cell = (c.ix.lane[..., None, None], c.ix.cell[..., None, None])
    win_pad = F.pad(c.win, (MAX_DELTA,) * 4)
    wloc = _windows(win_pad, by_cell, p.win_y, p.win_x, c.ix.ar_window)
    wsum = wloc.sum(dim=(-2, -1))
    wprob = (wloc / (wsum + EPS)[..., None, None]).reshape(b, m, -1)
    widx = _categorical(wprob, 1.0 - u_idx)
    new_wy = torch.clamp(p.win_y + widx // WINDOW - MAX_DELTA, 0, CELL - 1)
    new_wx = torch.clamp(p.win_x + widx % WINDOW - MAX_DELTA, 0, CELL - 1)
    xy = torch.stack([(c.y0 + new_wy).float() + u_jit[..., 0],
                      (c.x0 + new_wx).float() + u_jit[..., 1]], dim=-1)
    wloc_b = _windows(win_pad, by_cell, new_wy, new_wx, c.ix.ar_window)
    wprob_b = wloc_b / (wloc_b.sum(dim=(-2, -1)) + EPS)[..., None, None]
    back = (_log(wprob_b[c.ix.lane, c.ix.cell, p.win_y - new_wy + MAX_DELTA,
                         p.win_x - new_wx + MAX_DELTA]) - _log(c.n_cell))
    return (wsum > 1e-12, xy, _log(_take(wprob, widx)) - _log(c.n_cell),
            back)


def _data_transform(c: _Cells, p: _Picked, pid, u_cls, u_jit):
    """Mark ``pid`` of the picked point resampled from its pixel
    distribution (``u_cls`` (B, m)) with a uniform jitter in the class
    (``u_jit``): (marks, log_fwd, log_back)."""
    kd, lane = c.kd, c.ix.lane
    row = p.rows[lane, c.ix.cell, pid]  # (B, m, C)
    new_cls = _categorical(row, 1.0 - u_cls)
    vmin, vmax = kd.map_vmin[lane, pid], kd.map_vmax[lane, pid]
    value = (_class_to_value(vmin, vmax, c.n_classes, new_cls)
             + u_jit * ((vmax - vmin) / c.n_classes))
    return (c.smk.scatter(-1, pid[..., None], value[..., None]),
            _log(_take(row, new_cls)) - _log(c.n_cell),
            _log(_take(row, _take(p.cls, pid))) - _log(c.n_cell))


def _cell_proposal(gens, state: PointsState, kd: KernelData,
                   view: MapView, ix: _Index, h: int, w: int,
                   y0: torch.Tensor, x0: torch.Tensor, free_slot: torch.Tensor,
                   free_ok: torch.Tensor, data_moves: bool = True,
                   split_merge: bool = False):
    """One MH proposal per cell [y0, y0+CELL) x [x0, x0+CELL), batched over
    the B lanes (lane b draws from ``gens[b]``) and their m cells (y0, x0,
    free_slot, free_ok: (B, m)). Returns (kind, slot, xy, marks, log_fwd,
    log_back, slot2, xy2, marks2), each (B, m, ...), with kinds 0 = no-op,
    1 = birth, 2 = death, 3 = single-slot move, and with ``split_merge``
    4 = split (``slot`` moves, ``slot2`` is born) and 5 = merge (``slot``
    moves, ``slot2`` dies; ``slot2`` is -1 for the other kinds). Without
    ``split_merge`` the last three are None, and the draws are those of a
    chain that never had the pair: its variates are drawn after all
    others, and only when it is on."""
    m = y0.shape[1]
    dev = state.xy.device
    k = state.capacity
    vmin_l, vmax_l = kd.map_vmin[:, None, :], kd.map_vmax[:, None, :]
    cyc_l = kd.map_cyclic[:, None, :]
    # the variates, in the order the chain has always drawn them
    u_pick = _rand(gens, m, k, device=dev)
    move_t = _rand(gens, m, device=dev)
    u_pos = _rand(gens, m, device=dev)
    u_jit = _rand(gens, m, 2, device=dev)
    u_cls = _rand(gens, m, 3, device=dev)
    u_mjit = _rand(gens, m, 3, device=dev)
    z_trl = _randn(gens, m, 2, device=dev)
    pid = _randint(gens, 0, 3, m, device=dev)
    z_trf = _randn(gens, m, device=dev)
    if data_moves:
        sub_u = _rand(gens, m, 2, device=dev)
        u_widx = _rand(gens, m, device=dev)
        djit = _rand(gens, m, 3, device=dev)
        u_dcls = _rand(gens, m, device=dev)

    c = _Cells.make(state, kd, view, ix, h, w, y0, x0, free_slot, free_ok,
                    u_pick)
    p = _Picked.make(c)
    # with the split/merge pair the four base families take 0.2 each and
    # split and merge 0.1 each; only ratios of paired families enter the
    # Green ratios, so the base families' terms are unchanged
    pb = P_SM_BASE if split_merge else P_BIRTH
    is_birth = move_t < pb
    is_death = (move_t >= pb) & (move_t < 2 * pb)
    is_trl = (move_t >= 2 * pb) & (move_t < 3 * pb)

    birth_ok, birth_xy, birth_marks, birth_fwd, birth_back = _birth(
        c, u_pos, u_jit, u_cls, u_mjit)
    death_fwd, death_back = _death(c, p)
    g_trl_xy, g_trl_logp = _gauss_translation(c, z_trl)
    g_trf_marks, g_trf_logp = _gauss_transform(c, pid, z_trf)
    if data_moves:
        use_data_trl = sub_u[..., 0] < P_DATA_SUB
        use_data_trf = sub_u[..., 1] < P_DATA_SUB
        d_trl_valid, d_trl_xy, d_trl_fwd, d_trl_back = _data_translation(
            c, p, u_widx, djit[..., :2])
        d_trf_marks, d_trf_fwd, d_trf_back = _data_transform(
            c, p, pid, u_dcls, djit[..., 2])
        pick_data_trl = use_data_trl & d_trl_valid
        trl_xy = torch.where(pick_data_trl[..., None], d_trl_xy, g_trl_xy)
        trl_fwd = torch.where(pick_data_trl, d_trl_fwd, g_trl_logp)
        trl_back = torch.where(pick_data_trl, d_trl_back, g_trl_logp)
        trl_ok = ~use_data_trl | d_trl_valid
        trf_marks = torch.where(use_data_trf[..., None], d_trf_marks,
                                g_trf_marks)
        trf_fwd = torch.where(use_data_trf, d_trf_fwd, g_trf_logp)
        trf_back = torch.where(use_data_trf, d_trf_back, g_trf_logp)
    else:
        trl_xy, trl_fwd, trl_back = g_trl_xy, g_trl_logp, g_trl_logp
        trf_marks, trf_fwd, trf_back = g_trf_marks, g_trf_logp, g_trf_logp
        trl_ok = torch.ones_like(is_trl)

    # ---- assemble
    sxy, smk, safe_slot = c.sxy, c.smk, c.safe_slot
    pick_ok = c.pick_ok
    zero = torch.zeros_like(safe_slot)
    kind = torch.where(
        is_birth, torch.where(birth_ok, 1, zero),
        torch.where(pick_ok,
                    torch.where(is_death, 2,
                                torch.where(is_trl & ~trl_ok, 0, 3 + zero)),
                    zero))
    slot = torch.where(is_birth, free_slot, safe_slot)
    xy = torch.where(is_birth[..., None], birth_xy,
                     torch.where((is_trl & ~is_death)[..., None], trl_xy,
                                 sxy))
    marks = torch.where(is_birth[..., None], birth_marks,
                        torch.where((is_trl | is_death)[..., None], smk,
                                    trf_marks))
    log_fwd = torch.where(is_birth, birth_fwd,
                          torch.where(is_death, death_fwd,
                                      torch.where(is_trl, trl_fwd, trf_fwd)))
    log_back = torch.where(is_birth, birth_back,
                           torch.where(is_death, death_back,
                                       torch.where(is_trl, trl_back,
                                                   trf_back)))
    if not split_merge:
        return kind, slot, xy, marks, log_fwd, log_back, None, None, None

    # ---- split / merge, confined to the cell: the sequential kernels'
    # displacement density with the cell's counts for the global ones,
    # both children (and the merged point) clipped into the cell
    u_rad = _rand(gens, m, device=dev)
    u_ang = _rand(gens, m, device=dev)
    z_shape = _randn(gens, m, 3, device=dev)
    nb_noise = _rand(gens, m, k, device=dev)
    n_cell, lam_cell, lo, hi = c.n_cell, c.lam_cell, c.lo, c.hi

    def clip_marks(mk):
        wrapped = ((mk - vmin_l) % (vmax_l - vmin_l)) + vmin_l
        return torch.where(cyc_l, wrapped,
                           torch.minimum(torch.maximum(mk, vmin_l), vmax_l))

    sm_sigmas = SPLIT_SHAPE_SIGMA * (vmax_l - vmin_l)

    def split_logpdf(shape_delta):
        return (-math.log(math.pi * MERGE_RADIUS ** 2)
                + _normal_logpdf(shape_delta, sm_sigmas).sum(dim=-1))

    log_sm = math.log(P_SM)
    rho = MERGE_RADIUS * torch.sqrt(u_rad)
    theta = u_ang * float(np.float32(np.pi / 2))
    pos_delta = rho[..., None] * torch.stack(
        [torch.cos(theta), torch.sin(theta)], dim=-1)
    shape_delta = sm_sigmas * z_shape
    sp_xy_a = torch.minimum(torch.maximum(sxy - pos_delta, lo), hi)
    sp_xy_b = torch.minimum(torch.maximum(sxy + pos_delta, lo), hi)
    sp_fwd = (log_sm - _log(n_cell) + split_logpdf(shape_delta)
              - _log(lam_cell))
    # the reverse merge picks either child, then its sibling among the
    # cell's points within the merge radius (the parent left out)
    others = c.in_cell & (torch.arange(k, device=dev)
                          != safe_slot[..., None])
    nn_a = (others & (torch.linalg.vector_norm(
        state.xy[:, None] - sp_xy_a[..., None, :], dim=-1)
        <= MERGE_RADIUS)).sum(dim=-1) + 1
    nn_b = (others & (torch.linalg.vector_norm(
        state.xy[:, None] - sp_xy_b[..., None, :], dim=-1)
        <= MERGE_RADIUS)).sum(dim=-1) + 1
    sp_back = log_sm + _log((1.0 / (n_cell + 1.0))
                            * (1.0 / nn_a + 1.0 / nn_b))
    split_ok = pick_ok & free_ok & c.cell_ok

    nb_mask = others & (torch.linalg.vector_norm(
        state.xy[:, None] - sxy[..., None, :], dim=-1) <= MERGE_RADIUS)
    n_nb = nb_mask.sum(dim=-1)
    nb_slot = torch.where(n_nb > 0, torch.argmax(
        torch.where(nb_mask, nb_noise, -1.0), dim=-1), safe_slot)
    nxy, nmk = _rows(state.xy, nb_slot), _rows(state.marks, nb_slot)
    mg_xy = torch.minimum(torch.maximum((sxy + nxy) / 2.0, lo), hi)
    mg_fwd = log_sm - _log(n_cell) - _log(n_nb.float())
    mg_back = (log_sm - _log(n_cell - 1.0) + split_logpdf((smk - nmk) / 2.0)
               - _log(lam_cell))
    merge_ok = pick_ok & (n_nb > 0) & (n_cell >= 2)

    is_split = (move_t >= 4 * pb) & (move_t < 4 * pb + P_SM)
    is_merge = move_t >= 4 * pb + P_SM
    sm = is_split | is_merge
    kind = torch.where(is_split, torch.where(split_ok, 4, zero),
                       torch.where(is_merge, torch.where(merge_ok, 5, zero),
                                   kind))
    slot = torch.where(sm, safe_slot, slot)
    xy = torch.where(is_split[..., None], sp_xy_a,
                     torch.where(is_merge[..., None], mg_xy, xy))
    marks = torch.where(is_split[..., None], clip_marks(smk - shape_delta),
                        torch.where(is_merge[..., None],
                                    clip_marks((smk + nmk) / 2.0), marks))
    log_fwd = torch.where(is_split, sp_fwd,
                          torch.where(is_merge, mg_fwd, log_fwd))
    log_back = torch.where(is_split, sp_back,
                           torch.where(is_merge, mg_back, log_back))
    slot2 = torch.where(is_split, free_slot,
                        torch.where(is_merge, nb_slot, zero - 1))
    xy2 = torch.where(is_split[..., None], sp_xy_b, 0.0)
    marks2 = torch.where(is_split[..., None], clip_marks(smk + shape_delta),
                         0.0)
    return kind, slot, xy, marks, log_fwd, log_back, slot2, xy2, marks2


def _type_probs(data_moves: bool) -> np.ndarray:
    """The switched superstep's move types: birth, death, gaussian and
    data translation, gaussian and data transform, with the per-cell
    draws' marginals."""
    if data_moves:
        return np.array([P_BIRTH, P_DEATH, P_TRL * (1 - P_DATA_SUB),
                         P_TRL * P_DATA_SUB, P_TRF * (1 - P_DATA_SUB),
                         P_TRF * P_DATA_SUB])
    return np.array([P_BIRTH, P_DEATH, P_TRL, 0.0, P_TRF, 0.0])


def _cell_proposal_switched(gens, types, state: PointsState, kd: KernelData,
                            view: MapView, ix: _Index, h: int, w: int,
                            y0: torch.Tensor, x0: torch.Tensor,
                            free_slot: torch.Tensor, free_ok: torch.Tensor):
    """One MH proposal per cell with ONE move type per superstep and lane:
    ``types`` holds lane b's type (an index of ``_type_probs``), drawn on
    the host. Each lane's superstep is then one of six composite kernels
    (all cells birth, all death, ...), each a product of non-interacting
    cell kernels in detailed balance with its reverse type; the factor
    P(type) cancels from the cells' Green ratios. Only the branches of the
    lanes' types are built (their union over the lanes), which is the
    point: fewer launches per superstep. Every branch reads one shared set
    of variates, so lane b draws the same numbers whatever the other
    lanes' types. Returns the 9 fields of ``_cell_proposal`` (no
    split/merge: the last three are None)."""
    m = y0.shape[1]
    dev = state.xy.device
    u_pick = _rand(gens, m, state.capacity, device=dev)
    # the shared variates: at most 9 uniforms, 2 normals and a mark index
    u = _rand(gens, m, 9, device=dev)
    z = _randn(gens, m, 2, device=dev)
    pid = _randint(gens, 0, 3, m, device=dev)
    c = _Cells.make(state, kd, view, ix, h, w, y0, x0, free_slot, free_ok,
                    u_pick)
    picked = []

    def point() -> _Picked:  # built once, and only for the types needing it
        if not picked:
            picked.append(_Picked.make(c))
        return picked[0]

    zero = torch.zeros_like(c.safe_slot)
    slot, sxy, smk = c.safe_slot, c.sxy, c.smk

    def moved(ok):
        return torch.where(c.pick_ok & ok, 3, zero)

    def birth():
        ok, xy, marks, fwd, back = _birth(c, u[..., 0], u[..., 1:3],
                                          u[..., 6:9], u[..., 3:6])
        return torch.where(ok, 1, zero), free_slot, xy, marks, fwd, back

    def death():
        fwd, back = _death(c, point())
        return torch.where(c.pick_ok, 2, zero), slot, sxy, smk, fwd, back

    def gauss_trl():
        xy, logp = _gauss_translation(c, z)
        return moved(True), slot, xy, smk, logp, logp

    def data_trl():
        ok, xy, fwd, back = _data_translation(c, point(), u[..., 0],
                                              u[..., 1:3])
        return moved(ok), slot, xy, smk, fwd, back

    def gauss_trf():
        marks, logp = _gauss_transform(c, pid, z[..., 0])
        return moved(True), slot, sxy, marks, logp, logp

    def data_trf():
        marks, fwd, back = _data_transform(c, point(), pid, u[..., 0],
                                           u[..., 1])
        return moved(True), slot, sxy, marks, fwd, back

    branches = (birth, death, gauss_trl, data_trl, gauss_trf, data_trf)
    built = {t: branches[t]() for t in sorted(set(types))}
    if len(built) == 1:
        out = next(iter(built.values()))
    else:  # each lane's own branch: lane views, one cat per field
        out = tuple(torch.cat([built[t][f][i:i + 1]
                               for i, t in enumerate(types)])
                    for f in range(6))
    kind = torch.where(c.cell_ok, out[0], 0)
    return (kind,) + tuple(out[1:]) + (None, None, None)


def _unary_at(maps: EnergyMaps, spec: EnergySpec, xy, marks):
    """Unary data columns (position (...,), marks (..., 3)) at candidates."""
    return unary_terms(maps, xy, marks)


def _tops(values, mask, sign: float, n: int):
    """The n largest entries of each masked row of ``sign * values``
    (-inf where there are fewer), with the args of all but the last:
    ``[t1, a1, t2, ..., tn]``."""
    v = torch.where(mask, sign * values, -torch.inf)
    out = []
    for i in range(n):
        out.append(v.amax(dim=-1))
        if i < n - 1:
            a = torch.argmax(v, dim=-1)
            out.append(a)
            v = v.scatter(-1, a[..., None], -torch.inf)
    return out


def _column(mask: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """``mask[b, j, at[b, i]]`` for every row j: (B, m, K)."""
    return torch.gather(mask.transpose(-1, -2), 1,
                        at[..., None].expand(-1, -1, mask.shape[-1]))


def superstep_deltas(state: PointsState, cache: EnergyCache, maps: EnergyMaps,
                     spec: EnergySpec, comb: EnergyCombiner, kinds, slots,
                     xys, markss, slots2=None, xys2=None, markss2=None):
    """Exact dU of m single-slot proposals per lane (birth 1 / death 2 /
    move 3; each (B, m, ...)) against the SAME base state of their lane
    (B, K), in O(m*K): per-row top-2 statistics of the masked overlap/align
    rows give every neighbour's leave-one-out reduced term, into which the
    candidate's fresh pair row is inserted. Returns the (B, m) deltas and
    the candidates' unary terms ``(pos, mark)``, which the apply caches.

    With ``slots2`` (the split/merge pair: split 4 moves ``slot`` and
    births ``slot2``, merge 5 moves ``slot`` and kills ``slot2``) the
    two-slot form of ``_two_slot_deltas`` runs instead, and the unary terms
    are ``(pos, mark, pos2, mark2)``."""
    if slots2 is not None:
        return _two_slot_deltas(state, cache, maps, spec, comb, kinds, slots,
                                xys, markss, slots2, xys2, markss2)
    k = state.capacity
    dev = state.xy.device
    alive = state.alive
    ov_mask, al_mask = pair_masks(state, cache.dist, spec)
    idx = torch.arange(k, device=dev)

    ov_sign = 1.0
    al_sign = -1.0 if spec.rewarding_align else 1.0
    ov1, ov_a, ov2 = _tops(cache.overlap, ov_mask, ov_sign, 2)
    al1, al_a, al2 = _tops(cache.align, al_mask, al_sign, 2)
    ov_n = ov_mask.sum(dim=-1)
    al_n = al_mask.sum(dim=-1)
    ov_red = torch.where(ov_n > 0, ov_sign * ov1, 0.0)
    al_red = torch.where(al_n > 0, al_sign * al1, 0.0)
    base_vec = vec_cols(spec, maps, cache.pos_e, cache.mark_e, ov_red, al_red,
                        cache.areas, state.marks[..., 1])
    pp_raw = combine(comb, base_vec)  # (B, K), valid where alive
    n_data = 2 if spec.shape_mode == "mean" else 4
    ov_col, al_col = n_data, n_data + 1

    s = torch.clamp(slots, 0, k - 1)
    alive_s_new = kinds != 2  # death clears; birth / move leave s alive
    poly_s = marks_to_poly(xys, markss[..., 0], markss[..., 1],
                           markss[..., 2])
    area_s = rect_area(markss[..., 0], markss[..., 1])
    dist_row, ov_row, al_row = pair_rows(xys, markss, poly_s, area_s, state,
                                         cache.polys, cache.areas, spec)
    others = alive[:, None, :] & (idx != s[..., None])  # (B, m, K)
    ov_new = alive_s_new[..., None] & others & (
        dist_row <= spec.overlap_max_dist)
    al_new = alive_s_new[..., None] & others & (
        dist_row <= spec.align_max_dist)

    def neighbour_red(t1, a1, t2, n, old_col, new_mask, new_vals, sign):
        ext_wo = torch.where((a1[:, None, :] == s[..., None]) & old_col,
                             t2[:, None, :], t1[:, None, :])
        n_wo = n[:, None, :] - old_col.long()
        ext_new = torch.maximum(
            ext_wo, torch.where(new_mask, sign * new_vals, -torch.inf))
        n_new = n_wo + new_mask.long()
        return torch.where(n_new > 0, sign * ext_new, 0.0)

    ov_red_new = neighbour_red(ov1, ov_a, ov2, ov_n, _column(ov_mask, s),
                               ov_new, ov_row, ov_sign)
    al_red_new = neighbour_red(al1, al_a, al2, al_n, _column(al_mask, s),
                               al_new, al_row, al_sign)
    b, m = kinds.shape
    vec_new = base_vec[:, None].expand(b, m, -1, -1).clone()
    vec_new[..., ov_col] = ov_red_new
    vec_new[..., al_col] = al_red_new
    pp_new = combine(comb, vec_new)  # (B, m, K)
    d_others = torch.where(others, pp_new - pp_raw[:, None, :],
                           0.0).sum(dim=-1)

    # the candidate slot itself
    ov_s = torch.where(
        ov_new.any(dim=-1),
        ov_sign * torch.where(ov_new, ov_sign * ov_row,
                              -torch.inf).amax(dim=-1), 0.0)
    al_s = torch.where(
        al_new.any(dim=-1),
        al_sign * torch.where(al_new, al_sign * al_row,
                              -torch.inf).amax(dim=-1), 0.0)
    pos_s, mark_s = _unary_at(maps, spec, xys, markss)
    vec_s = vec_cols(spec, maps, pos_s, mark_s, ov_s, al_s, area_s,
                     markss[..., 1])
    pp_s_new = torch.where(alive_s_new, combine(comb, vec_s), 0.0)
    pp_s_old = torch.where(torch.gather(alive, 1, s),
                           torch.gather(pp_raw, 1, s), 0.0)
    deltas = pp_s_new - pp_s_old + d_others
    return torch.where(kinds == 0, 0.0, deltas), (pos_s, mark_s)


def _two_slot_deltas(state: PointsState, cache: EnergyCache,
                     maps: EnergyMaps, spec: EnergySpec,
                     comb: EnergyCombiner, kinds, slots, xys, markss,
                     slots2, xys2, markss2):
    """Exact dU of proposals touching up to two slots, in O(m*K): removing
    up to two columns of a neighbour's masked row falls through its top-3
    statistics, then both candidates' fresh values are inserted, and the
    candidates' own reduced terms include their mutual pair term (split).
    Lanes with one slot (``slot2 < 0``, kinds 1-3) get the single-slot
    delta."""
    k = state.capacity
    alive = state.alive
    ov_mask, al_mask = pair_masks(state, cache.dist, spec)
    idx = torch.arange(k, device=state.xy.device)
    ov_sign = 1.0
    al_sign = -1.0 if spec.rewarding_align else 1.0
    ov_t = _tops(cache.overlap, ov_mask, ov_sign, 3)
    al_t = _tops(cache.align, al_mask, al_sign, 3)
    ov_n, al_n = ov_mask.sum(dim=-1), al_mask.sum(dim=-1)
    ov_red = torch.where(ov_n > 0, ov_sign * ov_t[0], 0.0)
    al_red = torch.where(al_n > 0, al_sign * al_t[0], 0.0)
    base_vec = vec_cols(spec, maps, cache.pos_e, cache.mark_e, ov_red, al_red,
                        cache.areas, state.marks[..., 1])
    pp_raw = combine(comb, base_vec)
    n_data = 2 if spec.shape_mode == "mean" else 4
    ov_col, al_col = n_data, n_data + 1

    s = torch.clamp(slots, 0, k - 1)
    has2 = (kinds == 4) | (kinds == 5)
    s2 = torch.clamp(slots2, 0, k - 1)
    alive_s_new = kinds != 2
    alive_s2_new = kinds == 4

    # both candidates' geometry, pair rows and unary terms in one pass
    b, m = kinds.shape
    xy_c = torch.cat([xys, xys2], dim=1)
    mk_c = torch.cat([markss, markss2], dim=1)
    poly_c = marks_to_poly(xy_c, mk_c[..., 0], mk_c[..., 1], mk_c[..., 2])
    area_c = rect_area(mk_c[..., 0], mk_c[..., 1])
    rows_c = pair_rows(xy_c, mk_c, poly_c, area_c, state, cache.polys,
                       cache.areas, spec)
    unary_c = _unary_at(maps, spec, xy_c, mk_c)
    poly_a, poly_b = poly_c[:, :m], poly_c[:, m:]
    area_s, area_s2 = area_c[:, :m], area_c[:, m:]
    dist_s, ovr_s, alr_s = (r[:, :m] for r in rows_c)
    dist_s2, ovr_s2, alr_s2 = (r[:, m:] for r in rows_c)
    pos_s, pos_s2 = unary_c[0][:, :m], unary_c[0][:, m:]
    mark_s, mark_s2 = unary_c[1][:, :m], unary_c[1][:, m:]
    others = (alive[:, None, :] & (idx != s[..., None])
              & ~(has2[..., None] & (idx == s2[..., None])))

    def new_masks(alive_new, dist):
        on = alive_new[..., None] & others
        return (on & (dist <= spec.overlap_max_dist),
                on & (dist <= spec.align_max_dist))

    ovm_s, alm_s = new_masks(alive_s_new, dist_s)
    ovm_s2, alm_s2 = new_masks(alive_s2_new, dist_s2)

    def red2(tops, n, mask, new_s, val_s, new_s2, val_s2, sign):
        t1, a1, t2, a2, t3 = (x[:, None, :] for x in tops)
        col_s = _column(mask, s)
        col_s2 = has2[..., None] & _column(mask, s2)

        def removed(a):
            return (((a == s[..., None]) & col_s)
                    | ((a == s2[..., None]) & col_s2))

        ext = torch.where(removed(a1), torch.where(removed(a2), t3, t2), t1)
        ext = torch.maximum(ext, torch.where(new_s, sign * val_s,
                                             -torch.inf))
        ext = torch.maximum(ext, torch.where(new_s2, sign * val_s2,
                                             -torch.inf))
        n_new = (n[:, None, :] - col_s.long() - col_s2.long()
                 + new_s.long() + new_s2.long())
        return torch.where(n_new > 0, sign * ext, 0.0)

    vec_new = base_vec[:, None].expand(b, m, -1, -1).clone()
    vec_new[..., ov_col] = red2(ov_t, ov_n, ov_mask, ovm_s, ovr_s, ovm_s2,
                                ovr_s2, ov_sign)
    vec_new[..., al_col] = red2(al_t, al_n, al_mask, alm_s, alr_s, alm_s2,
                                alr_s2, al_sign)
    d_others = torch.where(others, combine(comb, vec_new)
                           - pp_raw[:, None, :], 0.0).sum(dim=-1)

    # the children's mutual pair term (split only)
    d_ab = torch.linalg.vector_norm(xys - xys2, dim=-1)
    ov_ab = (convex_quad_intersection_area(poly_a, poly_b)
             / (torch.minimum(area_s, area_s2) + 1e-6))
    al_ab = (1.0 - torch.abs(torch.cos(markss[..., 2] - markss2[..., 2]))
             - float(spec.rewarding_align))
    mut = alive_s_new & alive_s2_new
    mut_ov = mut & (d_ab <= spec.overlap_max_dist)
    mut_al = mut & (d_ab <= spec.align_max_dist)

    def cand_red(new_mask, vals, mut_ok, mut_val, sign):
        ext = torch.where(new_mask, sign * vals, -torch.inf).amax(dim=-1)
        ext = torch.maximum(ext, torch.where(mut_ok, sign * mut_val,
                                             -torch.inf))
        n_c = new_mask.sum(dim=-1) + mut_ok.long()
        return torch.where(n_c > 0, sign * ext, 0.0)

    def cand_energy(pos, mark, mk, area, ovm, ovr, alm, alr, alive_new):
        vec = vec_cols(spec, maps, pos, mark,
                       cand_red(ovm, ovr, mut_ov, ov_ab, ov_sign),
                       cand_red(alm, alr, mut_al, al_ab, al_sign), area,
                       mk[..., 1])
        return torch.where(alive_new, combine(comb, vec), 0.0)

    pp_s = cand_energy(pos_s, mark_s, markss, area_s, ovm_s, ovr_s, alm_s,
                       alr_s, alive_s_new)
    pp_s2 = cand_energy(pos_s2, mark_s2, markss2, area_s2, ovm_s2, ovr_s2,
                        alm_s2, alr_s2, alive_s2_new)
    pp_old = (torch.where(torch.gather(alive, 1, s),
                          torch.gather(pp_raw, 1, s), 0.0)
              + torch.where(has2 & torch.gather(alive, 1, s2),
                            torch.gather(pp_raw, 1, s2), 0.0))
    deltas = pp_s + pp_s2 - pp_old + d_others
    return (torch.where(kinds == 0, 0.0, deltas),
            (pos_s, mark_s, pos_s2, mark_s2))


def _apply_one(state: PointsState, kind: int, slot: int, xy, marks
               ) -> PointsState:
    """Apply one proposal to one configuration (the brute-force reference
    of the batched apply)."""
    xy_new, marks_new, alive = (state.xy.clone(), state.marks.clone(),
                                state.alive.clone())
    if kind in (1, 3):
        xy_new[slot] = xy
        marks_new[slot] = marks
    if kind == 1:
        alive[slot] = True
    elif kind == 2:
        alive[slot] = False
    return PointsState(xy=xy_new, marks=marks_new, alive=alive)


def _scatter(base: torch.Tensor, at: torch.Tensor, values) -> torch.Tensor:
    """``base`` (B, K, ...) with lane b's rows ``at[b]`` set to
    ``values[b]`` (a tensor (B, m, ...) or one scalar); index K is the
    lane's scratch row, so dropped proposals may repeat it and are
    discarded."""
    ext = torch.cat([base, base[:, :1]], dim=1)
    ext.scatter_(1, _lane_rows(at, ext), values)
    return ext[:, :-1]


def _set_row_col(mat: torch.Tensor, rows: torch.Tensor, at: torch.Tensor
                 ) -> torch.Tensor:
    """``mat`` (B, K, K) with row and column ``at[b, i]`` of lane b set to
    ``rows[b, i]`` (row K + 1 and column K + 1 are the scratch)."""
    b, k = mat.shape[:2]
    m = at.shape[1]
    ext = F.pad(mat, (0, 1, 0, 1))
    ext.scatter_(1, at[..., None].expand(b, m, k), rows)
    ext.scatter_(2, at[:, None, :].expand(b, k, m), rows.transpose(1, 2))
    return ext[:, :k, :k].contiguous()


def _apply_batch(state: PointsState, cache: EnergyCache, spec: EnergySpec,
                 kinds, slots, xys, markss, pos_us, mark_us, accept,
                 slots2=None, xys2=None, markss2=None, pos_us2=None,
                 mark_us2=None) -> Tuple[PointsState, EnergyCache]:
    """Apply ALL accepted proposals of a superstep, every lane, in one
    batched scatter per field; with ``slots2`` also their second slots
    (split 4: ``slot2`` is born at ``xys2``; merge 5: ``slot2`` dies).

    Within a lane, accepted proposals touch pairwise-distinct slots and do
    not interact, so the batched write equals the sequential application:
    every refreshed cache row is computed against the post-update state."""
    k = state.capacity
    safe = torch.clamp(slots, 0, k - 1)
    tgt = torch.where(accept, safe, k)  # k = the dropped scratch row
    geom = (kinds == 1) | (kinds == 3)
    if slots2 is not None:
        geom = geom | (kinds == 4) | (kinds == 5)
    tgt_geom = torch.where(accept & geom, safe, k)

    new_xy = _scatter(state.xy, tgt_geom, xys)
    new_marks = _scatter(state.marks, tgt_geom, markss)
    tgt_birth = torch.where(accept & (kinds == 1), safe, k)
    tgt_death = torch.where(accept & (kinds == 2), safe, k)
    new_alive = _scatter(_scatter(state.alive, tgt_birth, True), tgt_death,
                         False)
    polys = _scatter(cache.polys, tgt_geom,
                     marks_to_poly(xys, markss[..., 0], markss[..., 1],
                                   markss[..., 2]))
    areas = _scatter(cache.areas, tgt_geom, rect_area(markss[..., 0],
                                                      markss[..., 1]))
    if slots2 is not None:
        safe2 = torch.clamp(slots2, 0, k - 1)
        tgt2 = torch.where(accept & (kinds == 4), safe2, k)
        new_xy = _scatter(new_xy, tgt2, xys2)
        new_marks = _scatter(new_marks, tgt2, markss2)
        new_alive = _scatter(_scatter(new_alive, tgt2, True), torch.where(
            accept & (kinds == 5), safe2, k), False)
        polys = _scatter(polys, tgt2, marks_to_poly(
            xys2, markss2[..., 0], markss2[..., 1], markss2[..., 2]))
        areas = _scatter(areas, tgt2, rect_area(markss2[..., 0],
                                                markss2[..., 1]))
    state2 = PointsState(xy=new_xy, marks=new_marks, alive=new_alive)
    if slots2 is not None:
        # a split's second child's rows too, in the same pass (a
        # merged-away slot needs none: its entries are dead-masked)
        safe = torch.cat([safe, safe2], dim=1)
        tgt = torch.cat([tgt, tgt2], dim=1)
        pos_us = torch.cat([pos_us, pos_us2], dim=1)
        mark_us = torch.cat([mark_us, mark_us2], dim=1)

    # pair rows of every touched slot vs the FINAL state: (B, m, K)
    rows = pair_rows(_rows(state2.xy, safe), _rows(state2.marks, safe),
                     _rows(polys, safe), _rows(areas, safe), state2, polys,
                     areas, spec)
    mats = [_set_row_col(mat, row, tgt) for mat, row in
            zip((cache.dist, cache.overlap, cache.align), rows)]
    return state2, EnergyCache(dist=mats[0], overlap=mats[1], align=mats[2],
                               pos_e=_scatter(cache.pos_e, tgt, pos_us),
                               mark_e=_scatter(cache.mark_e, tgt, mark_us),
                               polys=polys, areas=areas)


def make_parallel_step(maps: EnergyMaps, spec: EnergySpec,
                       comb: EnergyCombiner, kd: KernelData, alpha_t: float,
                       t_target: float, n_cells: int,
                       data_moves: bool = True, move_switch: bool = False,
                       split_merge: bool = False):
    """Superstep over ``n_cells`` x ``n_cells`` jittered active cells in
    each of the B lanes of ``maps`` and ``kd`` (one launch sequence for all
    lanes): ``step((state, cache, energy, temp), gens, type_gens=None)``
    takes one generator per lane and returns the new carry, the per-lane
    (accepted, proposed) counts as (B,) device tensors and the (B, m)
    kinds of the accepted proposals (0 where rejected). The temperature is
    one float for every lane.

    ``split_merge`` adds the cell-confined split/merge pair (two-slot
    proposals); ``move_switch`` draws one move type per superstep and lane
    from ``type_gens`` (one CPU generator per lane, see ``run_steps``) and
    builds only the drawn types' branches. With both off the superstep
    draws what it always drew."""
    assert CELL >= max(spec.overlap_max_dist, spec.align_max_dist), (
        f"CELL={CELL} < interaction radius "
        f"{max(spec.overlap_max_dist, spec.align_max_dist)}: concurrent cell "
        "proposals would interact"
    )
    h, w = kd.log_birth_density.shape[-2:]
    view = make_local_view(kd, maps)
    dev = maps.position.device
    ids = torch.arange(n_cells, device=dev)
    grid_y = (2 * CELL * ids[:, None].expand(n_cells, n_cells)).reshape(-1)
    grid_x = (2 * CELL * ids[None, :].expand(n_cells, n_cells)).reshape(-1)
    m = grid_y.shape[0]
    ix = _Index.make(maps.position.shape[0], m, dev)
    cells = ix.cell[0]
    type_p = torch.from_numpy(_type_probs(data_moves))

    def step(carry, gens, type_gens=None):
        state, cache, energy, temp = carry
        off = _randint(gens, -CELL, CELL, 2, device=dev)  # (B, 2)
        y0s = off[:, :1] + grid_y
        x0s = off[:, 1:] + grid_x

        # distinct free slots for births: the r-th cell gets the r-th dead
        # slot of its lane (a stable sort puts dead slots first, in order)
        _, order = torch.sort(state.alive.to(torch.int8), dim=-1,
                              stable=True)
        n_dead = (~state.alive).sum(dim=-1, keepdim=True)
        free_oks = cells < n_dead
        free_slots = torch.where(
            free_oks, order[:, torch.clamp(cells, max=state.capacity - 1)],
            0)

        if move_switch:
            assert type_gens is not None, "move_switch needs type_gens"
            types = [int(torch.multinomial(type_p, 1, generator=g))
                     for g in type_gens]
            prop = _cell_proposal_switched(gens, types, state, kd, view, ix,
                                           h, w, y0s, x0s, free_slots,
                                           free_oks)
        else:
            prop = _cell_proposal(gens, state, kd, view, ix, h, w, y0s, x0s,
                                  free_slots, free_oks, data_moves=data_moves,
                                  split_merge=split_merge)
        kinds, slots, xys, markss, log_fwds, log_backs = prop[:6]
        second = prop[6:] if prop[6] is not None else (None,) * 3
        deltas, unary = superstep_deltas(state, cache, maps, spec, comb,
                                         kinds, slots, xys, markss, *second)
        log_alpha = -deltas / temp + log_backs - log_fwds
        accept = ((torch.log(_rand(gens, m, device=dev) + EPS) < log_alpha)
                  & (kinds != 0))
        state, cache = _apply_batch(state, cache, spec, kinds, slots, xys,
                                    markss, *unary[:2], accept, *second,
                                    *unary[2:])
        energy = energy + torch.where(accept, deltas, 0.0).sum(dim=-1)
        temp = temp * alpha_t if temp > t_target else temp
        return (state, cache, energy, temp), (accept.sum(dim=-1),
                                              (kinds != 0).sum(dim=-1),
                                              torch.where(accept, kinds, 0))

    return step


N_KINDS = 6  # no-op, birth, death, move, split, merge


def run_steps(step, state: PointsState, cache: EnergyCache,
              energy: torch.Tensor, temp: float, n_supersteps: int, gens,
              by_kind: Optional[torch.Tensor] = None):
    """Run ``n_supersteps`` of ``step``; returns the final carry and the
    summed per-lane (accepted, proposed) counts (device tensors, no host
    sync). ``by_kind``, a (B, N_KINDS) long tensor, gathers the accepted
    proposals by kind in place (the no-op column counts the rejected). A
    switched superstep's move types come from one CPU generator per lane,
    seeded with its lane generator's seed, so a lane's types follow its
    seed alone."""
    carry = (state, cache, energy, temp)
    type_gens = [torch.Generator().manual_seed(g.initial_seed())
                 for g in gens]
    acc = prop = torch.zeros(energy.shape, dtype=torch.long,
                             device=energy.device)
    for _ in range(n_supersteps):
        carry, (a, p, kinds) = step(carry, gens, type_gens)
        acc, prop = acc + a, prop + p
        if by_kind is not None:
            by_kind.scatter_add_(1, kinds, torch.ones_like(kinds))
    return carry, acc, prop


def chain_stats(kd: KernelData, acc, prop, energy, state, temp,
                by_kind=None) -> ChainStats:
    """Per-lane superstep totals in slot 0 of the per-kernel counts (and
    the accepted proposals by kind, where counted)."""
    n_kernels = kd.p_kernels.shape[-1]
    accepted = torch.zeros(acc.shape + (n_kernels,), device=energy.device)
    proposed = torch.zeros(prop.shape + (n_kernels,), device=energy.device)
    accepted[..., 0] = acc
    proposed[..., 0] = prop
    return ChainStats(accepted=accepted, proposed=proposed,
                      final_energy=energy, final_n_points=state.n_points,
                      final_temperature=temp, accepted_by_kind=by_kind)


def run_parallel_chain(gen: torch.Generator, init_state: PointsState,
                       maps: EnergyMaps, spec: EnergySpec,
                       comb: EnergyCombiner, kd: KernelData,
                       n_supersteps: int, t0: float = 1.0,
                       alpha_t: float = 0.999, t_target: float = 0.0,
                       data_moves: bool = True, move_switch: bool = False,
                       split_merge: bool = False
                       ) -> Tuple[PointsState, ChainStats]:
    """Anneal one configuration with cell-parallel supersteps over the
    whole map (one lane; unlaned inputs and outputs)."""
    h, w = kd.log_birth_density.shape
    n_cells = max(h, w) // (2 * CELL) + 1
    state, maps, kd = (expand_lanes(x, 1) for x in (init_state, maps, kd))
    step = make_parallel_step(maps, spec, comb, kd, alpha_t, t_target,
                              n_cells, data_moves=data_moves,
                              move_switch=move_switch,
                              split_merge=split_merge)
    cache0 = build_cache(state, maps, spec)
    u0 = energy_from_cache(state, maps, spec, comb, cache0)
    (state, _, energy, temp), acc, prop = run_steps(
        step, state, cache0, u0, t0, n_supersteps, [gen])
    stats = chain_stats(kd, acc, prop, energy, state, temp)
    return lane(state, 0), ChainStats(
        accepted=stats.accepted[0], proposed=stats.proposed[0],
        final_energy=stats.final_energy[0],
        final_n_points=stats.final_n_points[0], final_temperature=temp)
