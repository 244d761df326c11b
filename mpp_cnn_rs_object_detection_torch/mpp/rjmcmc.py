"""Chain parameters, the carried energy cache and papangelou scores.

Counterpart of ``RJMCMCParams``, ``EnergyCache``, ``build_cache``,
``update_cache``, ``energy_from_cache``, ``ChainStats`` and ``papangelou`` in
``mpp_cnn_rs_object_detection_tpu/mpp/rjmcmc.py`` (CNN data term).
The chain's functions (``build_cache``, ``energy_from_cache`` and their
helpers) take states, caches and maps with a leading lane axis B
(``mpp/state.py``); ``update_cache`` and ``papangelou`` take one
configuration and add a lane of one at their boundary. The sequential scan
sampler is not ported in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
    EnergyCombiner,
    combine,
)
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
    data_columns,
    lane_view,
    unary_terms,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    expand_lanes,
    lane,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import (
    marks_to_poly,
    quad_intersection_area_matrix,
    rect_area,
)

EPS = 1e-16


@dataclass(frozen=True)
class RJMCMCParams:
    """Static chain configuration (the config's ``rjmcmc_params`` block).

    ``alpha_t`` is a float, ``None`` or ``"auto"`` (reach ``t_target`` from
    ``t0`` in ``burn_in`` steps); ``iter_multiplier`` scales the step counts
    and takes the matching root of ``alpha_t``."""

    n_steps: int = 30_000
    t0: float = 1.0
    t_target: float = 0.0
    alpha_t: Optional[object] = 0.999
    n_samples: int = 1
    samples_interval: int = 128
    iter_multiplier: Optional[float] = None

    @property
    def burn_in(self) -> int:
        return int(self.n_steps * (self.iter_multiplier or 1))

    @property
    def resolved_interval(self) -> int:
        return max(1, int(self.samples_interval * (self.iter_multiplier or 1)))

    @property
    def total_steps(self) -> int:
        return self.burn_in + (self.n_samples + 1) * self.resolved_interval

    def resolved_alpha(self) -> float:
        alpha = self.alpha_t
        if alpha in (None, "auto"):
            t_end = max(self.t_target, 1e-6)
            return float(np.exp(np.log(t_end / self.t0) / self.burn_in))
        alpha = float(alpha)
        if self.iter_multiplier:
            alpha = float(np.power(alpha, 1.0 / self.iter_multiplier))
        return alpha

    def resolved_t_target(self) -> float:
        return 0.0 if self.alpha_t in (None, "auto") else self.t_target


@dataclass
class EnergyCache:
    """Pair/unary bookkeeping carried through the chain, per lane (B,
    leading; ``update_cache`` takes one lane's, without it)."""

    dist: torch.Tensor     # ([B,] K, K) center distances
    overlap: torch.Tensor  # ([B,] K, K) intersection / min-area ratios
    align: torch.Tensor    # ([B,] K, K) 1 - |cos dangle| - rewarding
    pos_e: torch.Tensor    # ([B,] K)
    mark_e: torch.Tensor   # ([B,] K, 3)
    polys: torch.Tensor    # ([B,] K, 4, 2) (stale at dead slots -- masked)
    areas: torch.Tensor    # ([B,] K)


@dataclass
class ChainStats:
    """Per lane: (B, n_kernels) counts with the superstep totals in slot 0,
    (B,) final energies and point counts; one temperature for all lanes."""

    accepted: torch.Tensor
    proposed: torch.Tensor
    final_energy: torch.Tensor
    final_n_points: torch.Tensor
    final_temperature: float


def pair_rows(xy_u, marks_u, polys_u, areas_u, state: PointsState,
              polys, areas, spec: EnergySpec):
    """dist / overlap / align rows of m points against all K of their
    lane: (B, m, K) each."""
    dist = torch.linalg.vector_norm(
        state.xy[..., None, :, :] - xy_u[..., :, None, :], dim=-1)
    inter = quad_intersection_area_matrix(polys_u, polys)
    overlap = inter / (torch.minimum(areas[..., None, :],
                                     areas_u[..., :, None]) + 1e-6)
    dangle = marks_u[..., :, None, 2] - state.marks[..., None, :, 2]
    align = 1.0 - torch.abs(torch.cos(dangle)) - float(spec.rewarding_align)
    return dist, overlap, align


def build_cache(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
                safe_dist: bool = False) -> EnergyCache:
    """Full O(K^2) cache build of B lanes (once per chain segment run).

    ``safe_dist``: distances as ``sqrt(sum(d^2) + 1e-12)``, as the JAX
    package's polish builds them (``mpp/polish.py``): differentiable at the
    zero diagonal; they shift by < 1e-6 px."""
    m = state.marks
    polys = marks_to_poly(state.xy, m[..., 0], m[..., 1], m[..., 2])
    areas = rect_area(m[..., 0], m[..., 1])
    diff = state.xy[..., :, None, :] - state.xy[..., None, :, :]
    if safe_dist:
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    else:
        dist = torch.linalg.vector_norm(diff, dim=-1)
    inter = quad_intersection_area_matrix(polys, polys)
    overlap = inter / (torch.minimum(areas[..., :, None],
                                     areas[..., None, :]) + 1e-6)
    dangle = m[..., :, None, 2] - m[..., None, :, 2]
    align = 1.0 - torch.abs(torch.cos(dangle)) - float(spec.rewarding_align)
    pos_e, mark_e = unary_terms(maps, state.xy, state.marks)
    return EnergyCache(dist=dist, overlap=overlap, align=align, pos_e=pos_e,
                       mark_e=mark_e, polys=polys, areas=areas)


def update_cache(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
                 cache: EnergyCache, slot: int) -> EnergyCache:
    """Refresh row + column ``slot`` of one configuration's cache after
    a birth/move of that slot."""
    s = slice(slot, slot + 1)
    mk = state.marks[s]
    poly_s = marks_to_poly(state.xy[s], mk[:, 0], mk[:, 1], mk[:, 2])
    area_s = rect_area(mk[:, 0], mk[:, 1])
    polys = cache.polys.clone()
    areas = cache.areas.clone()
    polys[s] = poly_s
    areas[s] = area_s
    rows = pair_rows(state.xy[s], mk, poly_s, area_s, state, polys, areas,
                     spec)
    mats = []
    for mat, row in zip((cache.dist, cache.overlap, cache.align), rows):
        mat = mat.clone()
        mat[slot, :] = row[0]
        mat[:, slot] = row[0]
        mats.append(mat)
    pos_s, mark_s = (x[0] for x in unary_terms(
        expand_lanes(maps, 1), state.xy[None, s], mk[None]))
    pos_e = cache.pos_e.clone()
    mark_e = cache.mark_e.clone()
    pos_e[s] = pos_s
    mark_e[s] = mark_s
    return EnergyCache(dist=mats[0], overlap=mats[1], align=mats[2],
                       pos_e=pos_e, mark_e=mark_e, polys=polys, areas=areas)


def pair_masks(state: PointsState, dist: torch.Tensor, spec: EnergySpec):
    """(overlap mask, align mask): alive pairs within each radius."""
    k = state.capacity
    eye = torch.eye(k, dtype=torch.bool, device=dist.device)
    alive_pair = (state.alive[..., :, None] & state.alive[..., None, :]
                  & ~eye)
    return (alive_pair & (dist <= spec.overlap_max_dist),
            alive_pair & (dist <= spec.align_max_dist))


def vec_cols(spec: EnergySpec, maps: EnergyMaps, pos, mark3, ov, al, area,
             ratio_mark) -> torch.Tensor:
    """Per-point energy vectors in column order, for points (B, ...) of
    B lanes; each lane's map scalars broadcast over its points."""
    min_area = lane_view(maps.min_area, area.ndim)
    max_area = lane_view(maps.max_area, area.ndim)
    area_prior = torch.clamp(
        torch.maximum(min_area - area, area - max_area), min=0.0)
    cols = [pos]
    if spec.shape_mode == "mean":
        cols.append(mark3.mean(dim=-1))
    else:
        cols.extend([mark3[..., 0], mark3[..., 1], mark3[..., 2]])
    cols.extend([ov, al, area_prior])
    if spec.use_ratio_prior:
        cols.append(torch.abs(lane_view(maps.target_ratio, ratio_mark.ndim)
                              - ratio_mark))
    return torch.stack(cols, dim=-1)


def reduced_pairs(cache: EnergyCache, ov_mask, al_mask, spec: EnergySpec):
    """Row-reduced overlap (max) and alignment (min if rewarding, else max)
    terms, 0 where a point has no interacting neighbour."""
    ov_red = torch.where(
        ov_mask.any(dim=-1),
        torch.where(ov_mask, cache.overlap, -torch.inf).amax(dim=-1), 0.0)
    if spec.rewarding_align:
        al = torch.where(al_mask, cache.align, torch.inf).amin(dim=-1)
    else:
        al = torch.where(al_mask, cache.align, -torch.inf).amax(dim=-1)
    return ov_red, torch.where(al_mask.any(dim=-1), al, 0.0)


def energy_from_cache(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
                      comb: EnergyCombiner, cache: EnergyCache
                      ) -> torch.Tensor:
    """U of each lane's configuration from the cached matrices (O(K^2)
    elementwise only): (B,)."""
    ov_mask, al_mask = pair_masks(state, cache.dist, spec)
    ov_red, al_red = reduced_pairs(cache, ov_mask, al_mask, spec)
    vec = vec_cols(spec, maps, cache.pos_e, cache.mark_e, ov_red, al_red,
                   cache.areas, state.marks[..., 1])
    vec = torch.where(state.alive[..., None], vec, 0.0)
    return torch.where(state.alive, combine(comb, vec), 0.0).sum(dim=-1)


def papangelou(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
               comb: EnergyCombiner) -> torch.Tensor:
    """Per-slot papangelou intensity ``exp(-(U(x) - U(x \\ u)))`` of one
    configuration.

    Removing u changes a neighbour's reduced pair term only when u was its
    arg-extremum, so per-row top-2 statistics give every leave-one-out
    energy vector in O(K^2)."""
    k = state.capacity
    dev = state.xy.device
    one_state, one_maps = expand_lanes(state, 1), expand_lanes(maps, 1)
    cache = lane(build_cache(one_state, one_maps, spec), 0)
    ov_mask, al_mask = pair_masks(state, cache.dist, spec)

    def top2(values, mask, take_max: bool):
        sign = 1.0 if take_max else -1.0
        v = torch.where(mask, sign * values, -torch.inf)
        t1, a1 = v.max(dim=1)
        v2 = v.clone()
        v2[torch.arange(k, device=dev), a1] = -torch.inf
        return sign * t1, a1, sign * v2.amax(dim=1)

    ov_n = ov_mask.sum(dim=1)
    al_n = al_mask.sum(dim=1)
    ov1, ov_arg, ov2 = top2(cache.overlap, ov_mask, True)
    al1, al_arg, al2 = top2(cache.align, al_mask, not spec.rewarding_align)
    ov_red = torch.where(ov_n > 0, ov1, 0.0)
    al_red = torch.where(al_n > 0, al1, 0.0)

    dcols = [c[0] for c in data_columns(one_state, one_maps, spec)]
    area = rect_area(state.marks[:, 0], state.marks[:, 1])
    area_prior = torch.clamp(
        torch.maximum(maps.min_area - area, area - maps.max_area), min=0.0)

    def vec_of(ov_col, al_col):
        shape = ov_col.shape
        cols = [c.expand(shape) for c in dcols]
        cols += [ov_col, al_col, area_prior.expand(shape)]
        if spec.use_ratio_prior:
            cols.append(torch.abs(maps.target_ratio
                                  - state.marks[:, 1]).expand(shape))
        return torch.stack(cols, dim=-1)

    base_vec = torch.where(state.alive[:, None], vec_of(ov_red, al_red), 0.0)
    base_total = torch.where(state.alive, combine(comb, base_vec), 0.0).sum()

    # leave-one-out reduced terms: (K removed, K rows)
    rm = torch.arange(k, device=dev)
    ov_without = torch.where(ov_arg[None, :] == rm[:, None],
                             torch.where(ov_n[None, :] > 1, ov2[None, :], 0.0),
                             ov_red[None, :])
    al_without = torch.where(al_arg[None, :] == rm[:, None],
                             torch.where(al_n[None, :] > 1, al2[None, :], 0.0),
                             al_red[None, :])
    alive_wo = state.alive[None, :] & (rm[None, :] != rm[:, None])
    pp = torch.where(alive_wo, combine(comb, vec_of(ov_without, al_without)),
                     0.0)
    delta = base_total - pp.sum(dim=1)
    return torch.where(state.alive, torch.exp(-delta), 0.0)
