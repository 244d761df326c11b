"""Cell-parallel RJMCMC: many non-interacting MH moves per superstep.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/parallel_sampler.py``
(default flags: data moves on, split/merge and the switched move type off).
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
from typing import Tuple

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
    WINDOW,
    KernelData,
    _class_to_value,
    _log,
    _normal_logpdf,
    _value_to_class,
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


def _lane_rows(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Row indices ``idx`` (B, m) broadcast over the trailing axes of
    ``like`` (B, K, ...): a gather / scatter index along axis 1."""
    tail = tuple(like.shape[2:])
    return idx.reshape(idx.shape + (1,) * len(tail)).expand(
        tuple(idx.shape) + tail)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane rows: x (B, K, ...) at idx (B, m) -> (B, m, ...)."""
    return torch.gather(x, 1, _lane_rows(idx, x))


def _cell_proposal(gens, state: PointsState, kd: KernelData,
                   view: MapView, ix: _Index, h: int, w: int,
                   y0: torch.Tensor, x0: torch.Tensor, free_slot: torch.Tensor,
                   free_ok: torch.Tensor, data_moves: bool = True):
    """One MH proposal per cell [y0, y0+CELL) x [x0, x0+CELL), batched over
    the B lanes (lane b draws from ``gens[b]``) and their m cells (y0, x0,
    free_slot, free_ok: (B, m)). Returns (kind, slot, xy, marks, log_fwd,
    log_back), each (B, m, ...), with kinds 0 = no-op, 1 = birth, 2 =
    death, 3 = single-slot move."""
    b, m = y0.shape
    dev = state.xy.device
    k = state.capacity
    lane, cell, mark3 = ix.lane, ix.cell, ix.mark3
    by_cell = (lane[..., None, None], cell[..., None, None])
    vmin_l, vmax_l = kd.map_vmin[:, None, :], kd.map_vmax[:, None, :]
    cyc_l = kd.map_cyclic[:, None, :]

    ylo, xlo = torch.clamp(y0, 0, h), torch.clamp(x0, 0, w)
    yhi, xhi = torch.clamp(y0 + CELL, 0, h), torch.clamp(x0 + CELL, 0, w)
    area = torch.clamp((yhi - ylo) * (xhi - xlo), min=0).float()
    cell_ok = area > 0

    px_all = state.xy[:, None, :, 0]
    py_all = state.xy[:, None, :, 1]
    in_cell = (state.alive[:, None, :]
               & (px_all >= ylo[..., None]) & (px_all < yhi[..., None])
               & (py_all >= xlo[..., None]) & (py_all < xhi[..., None]))
    n_cell = in_cell.sum(dim=-1).float()
    # uniform among the cell's points: argmax of masked uniform noise
    pick = torch.argmax(torch.where(in_cell, _rand(gens, m, k, device=dev),
                                    -1.0), dim=-1)
    cell_slot = torch.where(n_cell > 0, pick, -1)
    safe_slot = torch.clamp(cell_slot, min=0)
    lam_cell = kd.intensity[:, None] * area / float(h * w)

    move_t = _rand(gens, m, device=dev)
    is_birth = move_t < P_BIRTH
    is_death = (move_t >= P_BIRTH) & (move_t < 2 * P_BIRTH)
    is_trl = (move_t >= 2 * P_BIRTH) & (move_t < 3 * P_BIRTH)

    # ---- birth: position ~ cell window of the detection density
    win = _windows(view.cell_density, by_cell[:1], y0 - view.row0_cd,
                   x0 + CELL, ix.ar_cell)
    win_sum = win.sum(dim=(-2, -1))
    win_prob = win / (win_sum + EPS)[..., None, None]
    flat_prob = win_prob.reshape(b, m, -1)
    cell_idx = _categorical(flat_prob, 1.0 - _rand(gens, m, device=dev))
    jitter = _rand(gens, m, 2, device=dev)
    py = (y0 + cell_idx // CELL).float() + jitter[..., 0]
    px = (x0 + cell_idx % CELL).float() + jitter[..., 1]
    byi = torch.clamp(py.long(), 0, h - 1)
    bxi = torch.clamp(px.long(), 0, w - 1)
    n_rows_md = view.mark_dists.shape[-3]
    byi_l = torch.clamp(byi - view.row0_md, 0, n_rows_md - 1)
    log_q_pos = _log(_take(flat_prob, cell_idx)) + _log(area)
    rows = view.mark_dists[lane[..., None], mark3, byi_l[..., None],
                           bxi[..., None]]  # (B, m, 3, C)
    n_classes = view.mark_dists.shape[-1]
    cls = _categorical(rows, 1.0 - _rand(gens, m, 3, device=dev))
    steps_b = (vmax_l - vmin_l) / n_classes
    mjit = _rand(gens, m, 3, device=dev)
    birth_marks = vmin_l + cls.float() * steps_b + mjit * steps_b
    log_q_marks = _log(_take(rows, cls)).sum(dim=-1)
    log_q_birth = log_q_pos + log_q_marks + 3 * math.log(float(n_classes))
    birth_fwd = math.log(P_BIRTH) + log_q_birth - _log(lam_cell)
    birth_back = math.log(P_DEATH) - _log(n_cell + 1.0)
    birth_valid = win_sum > 1e-12

    # ---- death: uniform among the cell's points
    sxy = _rows(state.xy, safe_slot)
    smk = _rows(state.marks, safe_slot)
    death_fwd = math.log(P_DEATH) - _log(n_cell)
    dyi = torch.clamp(sxy[..., 0].long(), 0, h - 1)
    dxi = torch.clamp(sxy[..., 1].long(), 0, w - 1)
    dyi_l = torch.clamp(dyi - view.row0_md, 0, n_rows_md - 1)
    drows = view.mark_dists[lane[..., None], mark3, dyi_l[..., None],
                            dxi[..., None]]  # (B, m, 3, C)
    dcls = _value_to_class(vmin_l, vmax_l, cyc_l, n_classes, smk)
    dwin_y = torch.clamp(dyi - y0, 0, CELL - 1)
    dwin_x = torch.clamp(dxi - x0, 0, CELL - 1)
    log_q_death = (_log(win_prob[lane, cell, dwin_y, dwin_x]) + _log(area)
                   + _log(_take(drows, dcls)).sum(dim=-1)
                   + 3 * math.log(float(n_classes)))
    death_back = math.log(P_BIRTH) + log_q_death - _log(lam_cell)

    # ---- gaussian translation, clipped to the cell
    sigma_trl = kd.sigma_trl[:, None, None]
    delta = sigma_trl * _randn(gens, m, 2, device=dev)
    lo = torch.stack([ylo, xlo], dim=-1).float()
    hi = torch.stack([yhi - 1, xhi - 1], dim=-1).float()
    g_trl_xy = torch.minimum(torch.maximum(sxy + delta, lo), hi)
    g_trl_logp = (math.log(P_TRL)
                  + _normal_logpdf(delta, sigma_trl).sum(dim=-1)
                  - _log(n_cell))

    # ---- gaussian transform of one mark (cyclic wrap / clamp)
    pid = _randint(gens, 0, 3, m, device=dev)
    sigma = kd.sigma_trf[lane, pid]
    mdelta = sigma * _randn(gens, m, device=dev)
    old = _take(smk, pid)
    vmin, vmax = kd.map_vmin[lane, pid], kd.map_vmax[lane, pid]
    new_val = torch.where(
        kd.map_cyclic[lane, pid], ((old + mdelta) % (vmax - vmin)) + vmin,
        torch.minimum(torch.maximum(old + mdelta, vmin), vmax))
    g_trf_marks = smk.scatter(-1, pid[..., None], new_val[..., None])
    g_trf_logp = (math.log(P_TRF) + _normal_logpdf(mdelta, sigma)
                  - _log(n_cell))

    if data_moves:
        sub_u = _rand(gens, m, 2, device=dev)
        use_data_trl = sub_u[..., 0] < P_DATA_SUB
        use_data_trf = sub_u[..., 1] < P_DATA_SUB

        # ---- data translation: resample the pixel from the WINDOW patch
        # of the cell's density around the point (zero outside the cell)
        win_pad = F.pad(win, (MAX_DELTA,) * 4)
        wloc = _windows(win_pad, by_cell, dwin_y, dwin_x, ix.ar_window)
        wsum = wloc.sum(dim=(-2, -1))
        wprob = (wloc / (wsum + EPS)[..., None, None]).reshape(b, m, -1)
        widx = _categorical(wprob, 1.0 - _rand(gens, m, device=dev))
        new_wy = torch.clamp(dwin_y + widx // WINDOW - MAX_DELTA, 0, CELL - 1)
        new_wx = torch.clamp(dwin_x + widx % WINDOW - MAX_DELTA, 0, CELL - 1)
        djit = _rand(gens, m, 3, device=dev)
        d_trl_xy = torch.stack([(y0 + new_wy).float() + djit[..., 0],
                                (x0 + new_wx).float() + djit[..., 1]], dim=-1)
        d_trl_fwd = _log(_take(wprob, widx)) - _log(n_cell)
        wloc_b = _windows(win_pad, by_cell, new_wy, new_wx, ix.ar_window)
        wprob_b = wloc_b / (wloc_b.sum(dim=(-2, -1)) + EPS)[..., None, None]
        d_trl_back = (_log(wprob_b[lane, cell, dwin_y - new_wy + MAX_DELTA,
                                   dwin_x - new_wx + MAX_DELTA])
                      - _log(n_cell))
        d_trl_valid = wsum > 1e-12

        # ---- data transform: resample ONE mark from its pixel distribution
        row_d = drows[lane, cell, pid]  # (B, m, C)
        new_cls_d = _categorical(row_d, 1.0 - _rand(gens, m, device=dev))
        step_d = (vmax - vmin) / n_classes
        d_val = (_class_to_value(vmin, vmax, n_classes, new_cls_d)
                 + djit[..., 2] * step_d)
        d_trf_marks = smk.scatter(-1, pid[..., None], d_val[..., None])
        d_trf_fwd = _log(_take(row_d, new_cls_d)) - _log(n_cell)
        d_trf_back = _log(_take(row_d, _take(dcls, pid))) - _log(n_cell)

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
    birth_ok = cell_ok & free_ok & birth_valid
    pick_ok = cell_slot >= 0
    zero = torch.zeros_like(cell_slot)
    kind = torch.where(
        is_birth, torch.where(birth_ok, 1, zero),
        torch.where(pick_ok,
                    torch.where(is_death, 2,
                                torch.where(is_trl & ~trl_ok, 0, 3 + zero)),
                    zero))
    slot = torch.where(is_birth, free_slot, safe_slot)
    xy = torch.where(is_birth[..., None], torch.stack([py, px], dim=-1),
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
    return kind, slot, xy, marks, log_fwd, log_back


def _unary_at(maps: EnergyMaps, spec: EnergySpec, xy, marks):
    """Unary data columns (position (...,), marks (..., 3)) at candidates."""
    return unary_terms(maps, xy, marks)


def superstep_deltas(state: PointsState, cache: EnergyCache, maps: EnergyMaps,
                     spec: EnergySpec, comb: EnergyCombiner, kinds, slots,
                     xys, markss):
    """Exact dU of m single-slot proposals per lane (birth 1 / death 2 /
    move 3; each (B, m, ...)) against the SAME base state of their lane
    (B, K), in O(m*K): per-row top-2 statistics of the masked overlap/align
    rows give every neighbour's leave-one-out reduced term, into which the
    candidate's fresh pair row is inserted. Returns the (B, m) deltas and
    the candidates' unary terms ``(pos, mark)``, which the apply caches."""
    k = state.capacity
    dev = state.xy.device
    alive = state.alive
    ov_mask, al_mask = pair_masks(state, cache.dist, spec)
    idx = torch.arange(k, device=dev)

    def top2s(values, mask, sign):
        v = torch.where(mask, sign * values, -torch.inf)
        t1 = v.amax(dim=-1)
        a1 = torch.argmax(v, dim=-1)
        v2 = v.scatter(-1, a1[..., None], -torch.inf)
        return t1, a1, v2.amax(dim=-1)  # sign domain; -inf where none

    ov_sign = 1.0
    al_sign = -1.0 if spec.rewarding_align else 1.0
    ov1, ov_a, ov2 = top2s(cache.overlap, ov_mask, ov_sign)
    al1, al_a, al2 = top2s(cache.align, al_mask, al_sign)
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

    def column(mask):
        # mask[b, j, s[b, i]] for every row j: (B, m, K)
        return torch.gather(mask.transpose(-1, -2), 1,
                            s[..., None].expand(-1, -1, k))

    def neighbour_red(t1, a1, t2, n, old_col, new_mask, new_vals, sign):
        ext_wo = torch.where((a1[:, None, :] == s[..., None]) & old_col,
                             t2[:, None, :], t1[:, None, :])
        n_wo = n[:, None, :] - old_col.long()
        ext_new = torch.maximum(
            ext_wo, torch.where(new_mask, sign * new_vals, -torch.inf))
        n_new = n_wo + new_mask.long()
        return torch.where(n_new > 0, sign * ext_new, 0.0)

    ov_red_new = neighbour_red(ov1, ov_a, ov2, ov_n, column(ov_mask), ov_new,
                               ov_row, ov_sign)
    al_red_new = neighbour_red(al1, al_a, al2, al_n, column(al_mask), al_new,
                               al_row, al_sign)
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
                 kinds, slots, xys, markss, pos_us, mark_us, accept
                 ) -> Tuple[PointsState, EnergyCache]:
    """Apply ALL accepted proposals of a superstep, every lane, in one
    batched scatter per field.

    Within a lane, accepted proposals touch pairwise-distinct slots and do
    not interact, so the batched write equals the sequential application:
    every refreshed cache row is computed against the post-update state."""
    k = state.capacity
    safe = torch.clamp(slots, 0, k - 1)
    tgt = torch.where(accept, safe, k)  # k = the dropped scratch row
    write_geom = accept & ((kinds == 1) | (kinds == 3))
    tgt_geom = torch.where(write_geom, safe, k)

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
    state2 = PointsState(xy=new_xy, marks=new_marks, alive=new_alive)

    # pair rows of every touched slot vs the FINAL state: (B, m, K)
    dist_rows, overlap_rows, align_rows = pair_rows(
        _rows(state2.xy, safe), _rows(state2.marks, safe),
        _rows(polys, safe), _rows(areas, safe), state2, polys, areas, spec)
    cache2 = EnergyCache(
        dist=_set_row_col(cache.dist, dist_rows, tgt),
        overlap=_set_row_col(cache.overlap, overlap_rows, tgt),
        align=_set_row_col(cache.align, align_rows, tgt),
        pos_e=_scatter(cache.pos_e, tgt, pos_us),
        mark_e=_scatter(cache.mark_e, tgt, mark_us),
        polys=polys, areas=areas,
    )
    return state2, cache2


def make_parallel_step(maps: EnergyMaps, spec: EnergySpec,
                       comb: EnergyCombiner, kd: KernelData, alpha_t: float,
                       t_target: float, n_cells: int,
                       data_moves: bool = True):
    """Superstep over ``n_cells`` x ``n_cells`` jittered active cells in
    each of the B lanes of ``maps`` and ``kd`` (one launch sequence for all
    lanes): ``step((state, cache, energy, temp), generators)`` takes one
    generator per lane and returns the new carry and the per-lane
    (accepted, proposed) counts as (B,) device tensors. The temperature is
    one float for every lane."""
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

    def step(carry, gens):
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

        kinds, slots, xys, markss, log_fwds, log_backs = _cell_proposal(
            gens, state, kd, view, ix, h, w, y0s, x0s, free_slots, free_oks,
            data_moves=data_moves)
        deltas, (pos_us, mark_us) = superstep_deltas(
            state, cache, maps, spec, comb, kinds, slots, xys, markss)
        log_alpha = -deltas / temp + log_backs - log_fwds
        accept = ((torch.log(_rand(gens, m, device=dev) + EPS) < log_alpha)
                  & (kinds != 0))
        state, cache = _apply_batch(state, cache, spec, kinds, slots, xys,
                                    markss, pos_us, mark_us, accept)
        energy = energy + torch.where(accept, deltas, 0.0).sum(dim=-1)
        temp = temp * alpha_t if temp > t_target else temp
        return (state, cache, energy, temp), (accept.sum(dim=-1),
                                              (kinds != 0).sum(dim=-1))

    return step


def run_steps(step, state: PointsState, cache: EnergyCache,
              energy: torch.Tensor, temp: float, n_supersteps: int, gens):
    """Run ``n_supersteps`` of ``step``; returns the final carry and the
    summed per-lane (accepted, proposed) counts (device tensors, no host
    sync)."""
    carry = (state, cache, energy, temp)
    acc = prop = torch.zeros(energy.shape, dtype=torch.long,
                             device=energy.device)
    for _ in range(n_supersteps):
        carry, (a, p) = step(carry, gens)
        acc, prop = acc + a, prop + p
    return carry, acc, prop


def chain_stats(kd: KernelData, acc, prop, energy, state, temp) -> ChainStats:
    """Per-lane superstep totals in slot 0 of the per-kernel counts."""
    n_kernels = kd.p_kernels.shape[-1]
    accepted = torch.zeros(acc.shape + (n_kernels,), device=energy.device)
    proposed = torch.zeros(prop.shape + (n_kernels,), device=energy.device)
    accepted[..., 0] = acc
    proposed[..., 0] = prop
    return ChainStats(accepted=accepted, proposed=proposed,
                      final_energy=energy, final_n_points=state.n_points,
                      final_temperature=temp)


def run_parallel_chain(gen: torch.Generator, init_state: PointsState,
                       maps: EnergyMaps, spec: EnergySpec,
                       comb: EnergyCombiner, kd: KernelData,
                       n_supersteps: int, t0: float = 1.0,
                       alpha_t: float = 0.999, t_target: float = 0.0,
                       data_moves: bool = True
                       ) -> Tuple[PointsState, ChainStats]:
    """Anneal one configuration with cell-parallel supersteps over the
    whole map (one lane; unlaned inputs and outputs)."""
    h, w = kd.log_birth_density.shape
    n_cells = max(h, w) // (2 * CELL) + 1
    state, maps, kd = (expand_lanes(x, 1) for x in (init_state, maps, kd))
    step = make_parallel_step(maps, spec, comb, kd, alpha_t, t_target,
                              n_cells, data_moves=data_moves)
    cache0 = build_cache(state, maps, spec)
    u0 = energy_from_cache(state, maps, spec, comb, cache0)
    (state, _, energy, temp), acc, prop = run_steps(
        step, state, cache0, u0, t0, n_supersteps, [gen])
    stats = chain_stats(kd, acc, prop, energy, state, temp)
    return lane(state, 0), ChainStats(
        accepted=stats.accepted[0], proposed=stats.proposed[0],
        final_energy=stats.final_energy[0],
        final_n_points=stats.final_n_points[0], final_temperature=temp)
