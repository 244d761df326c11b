"""The sequential RJMCMC chain, its energy cache and papangelou scores.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/rjmcmc.py`` (CNN data
term): ``RJMCMCParams``, ``EnergyCache``, ``build_cache``,
``update_cache``, ``energy_from_cache``, ``ChainStats``, the annealed
sequential chain (``make_step_fn``, ``run_chain``, ``run_chains_batch``)
and ``papangelou``. The chain's functions take states, caches and maps
with a leading lane axis B (``mpp/state.py``): the tiles of a scene or the
independent chains of ``run_chains_batch``, all advanced by one launch
sequence per step. ``update_cache`` also takes one configuration with an
int slot, and ``papangelou`` takes one configuration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

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
from mpp_cnn_rs_object_detection_torch.mpp.kernels import (
    KernelData,
    Variates,
    apply_proposal,
    build_proposal,
    draw_raw,
    variates_from,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    cat_lanes,
    expand_lanes,
    lane,
    lanes,
    to_device,
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
    """Per lane: (B, n_kernels) accepted and proposed counts (per kernel
    for the sequential chain; the cell-parallel chain puts its superstep
    totals in slot 0), (B,) final energies and point counts; one
    temperature for all lanes."""

    accepted: torch.Tensor
    proposed: torch.Tensor
    final_energy: torch.Tensor
    final_n_points: torch.Tensor
    final_temperature: float
    # the cell-parallel chain's accepted proposals by kind, (B, 6): no-op
    # (the rejected), birth, death, move, split, merge
    accepted_by_kind: Optional[torch.Tensor] = None


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
    pos_e, mark_e = unary_terms(maps, spec, state.xy, state.marks)
    return EnergyCache(dist=dist, overlap=overlap, align=align, pos_e=pos_e,
                       mark_e=mark_e, polys=polys, areas=areas)


def update_cache(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
                 cache: EnergyCache, slot) -> EnergyCache:
    """Refresh rows + columns ``slot`` of each lane's cache after a birth,
    move or death there: laned state, maps and cache with a (B,) or
    (B, m) long ``slot`` (the m rows computed against the same state in
    one pass, by gathers and scatters, with no host read), or one
    configuration with an int slot. Only the slots' polygons and areas
    are rebuilt; a slot given twice, or refreshed again, gets the same
    values."""
    if state.xy.ndim == 2:
        at = torch.as_tensor(slot, device=state.xy.device).reshape(1)
        return lane(update_cache(expand_lanes(state, 1),
                                 expand_lanes(maps, 1), spec,
                                 expand_lanes(cache, 1), at), 0)
    k = state.capacity
    at = slot.long().reshape(slot.shape[0], -1)  # (B, m)

    def index(like):
        return at.reshape(at.shape + (1,) * (like.ndim - 2)).expand(
            at.shape + like.shape[2:])

    def rows_at(x):
        return torch.gather(x, 1, index(x))

    def set_rows(x, v):
        return x.scatter(1, index(v), v)

    xy_u, mk_u = rows_at(state.xy), rows_at(state.marks)
    poly_u = marks_to_poly(xy_u, mk_u[..., 0], mk_u[..., 1], mk_u[..., 2])
    area_u = rect_area(mk_u[..., 0], mk_u[..., 1])
    polys, areas = set_rows(cache.polys, poly_u), set_rows(cache.areas,
                                                           area_u)
    rows = pair_rows(xy_u, mk_u, poly_u, area_u, state, polys, areas, spec)
    col = at[:, None, :].expand(-1, k, -1)
    mats = [set_rows(mat, row).scatter(2, col, row.transpose(1, 2))
            for mat, row in zip((cache.dist, cache.overlap, cache.align),
                                rows)]
    pos_u, mark_u = unary_terms(maps, spec, xy_u, mk_u)
    return EnergyCache(dist=mats[0], overlap=mats[1], align=mats[2],
                       pos_e=set_rows(cache.pos_e, pos_u),
                       mark_e=set_rows(cache.mark_e, mark_u), polys=polys,
                       areas=areas)


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
    cols = [pos]  # a CNN-free term is this one column
    if spec.data_term == "cnn" and spec.shape_mode == "mean":
        cols.append(mark3.mean(dim=-1))
    elif spec.data_term == "cnn":
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


def select_lanes(accept: torch.Tensor, new, old):
    """The dataclass of tensors whose lane b is ``new``'s where
    ``accept[b]``, else ``old``'s (bit for bit)."""
    def pick(a, b):
        return torch.where(accept.reshape(accept.shape + (1,) * (a.ndim - 1)),
                           a, b)

    return type(new)(**{f: pick(getattr(new, f), getattr(old, f))
                        for f in new.__dataclass_fields__})


def step_from_variates(carry, v: Variates, u: torch.Tensor,
                       maps: EnergyMaps, spec: EnergySpec,
                       comb: EnergyCombiner, kd: KernelData):
    """The deterministic core of a sequential step: each lane's proposal
    from its variates ``v`` ((B, 1) lanes, ``kernels.draw_variates``),
    the cache refreshed at both touched slots, U recomputed from it, and
    the Metropolis-Hastings-Green test ``log(u + EPS) < -dU / T + log
    q_back - log q_fwd`` with ``u`` (B,) uniform. A rejected lane keeps
    its state, cache and energy bit for bit. Returns the (state, cache,
    energy) carry and the (B,) accepts."""
    state, cache, energy, temp = carry
    k = state.capacity
    one = PointsState(xy=state.xy[:, None], marks=state.marks[:, None],
                      alive=state.alive[:, None])
    prop = build_proposal(v, one, kd)
    applied = apply_proposal(one, prop)
    new_state = PointsState(xy=applied.xy[:, 0], marks=applied.marks[:, 0],
                            alive=applied.alive[:, 0])
    # the proposal's slot and the second of a split or merge (a repeat of
    # the first for the other kinds), refreshed in one pass
    slots = torch.clamp(torch.cat([prop.slot, prop.slot2], dim=1), 0, k - 1)
    new_cache = update_cache(new_state, maps, spec, cache, slots)
    new_energy = energy_from_cache(new_state, maps, spec, comb, new_cache)
    log_alpha = (-(new_energy - energy) / temp + prop.log_back[:, 0]
                 - prop.log_fwd[:, 0])
    accept = torch.log(u + EPS) < log_alpha
    return (select_lanes(accept, new_state, state),
            select_lanes(accept, new_cache, cache),
            torch.where(accept, new_energy, energy)), accept


def draw_step(gen: torch.Generator, n_lanes: int, capacity: int, device):
    """The raw numbers of one sequential step of ``n_lanes`` lanes, in the
    order the step draws them: ``kernels.draw_raw``'s three draws and the
    accept uniforms (B,)."""
    return draw_raw(gen, (n_lanes, 1, capacity), device) + (
        torch.rand((n_lanes,), generator=gen, device=device),)


def raw_lanes(raw, at: slice, device):
    """Lanes ``at`` of ``draw_step``'s numbers, on ``device``."""
    u, noise, z, u_acc = raw
    return (u[at].to(device), noise[:, at].to(device), z[at].to(device),
            u_acc[at].to(device))


def make_step_fn(maps: EnergyMaps, spec: EnergySpec, comb: EnergyCombiner,
                 kd: KernelData, alpha_t: float, t_target: float):
    """One annealed step of B lanes: ``step((state, cache, energy, temp),
    gen)`` draws every lane's variates and accept uniform from ``gen``
    (four calls, shaped over the lanes; or takes them drawn, ``raw`` of
    ``draw_step``) and applies ``step_from_variates``. Returns the new
    carry and the (B,) accepts and kernel indices (device tensors); the
    temperature is one host float for all lanes."""
    def step(carry, gen: Optional[torch.Generator], raw=None):
        state, _, energy, temp = carry
        if raw is None:
            raw = draw_step(gen, state.xy.shape[0], state.capacity,
                            energy.device)
        v = variates_from(raw[:3], PointsState(
            xy=state.xy[:, None], marks=state.marks[:, None],
            alive=state.alive[:, None]), kd)
        u = raw[3]
        (state, cache, energy), accept = step_from_variates(
            carry, v, u, maps, spec, comb, kd)
        temp = temp * alpha_t if temp > t_target else temp
        return (state, cache, energy, temp), (accept, v.kernel[:, 0])

    return step


def lane_groups(n_lanes: int, mesh, device) -> List[Tuple[slice, object]]:
    """Contiguous groups of the lanes, one per device of ``mesh`` (as even
    as they divide; a device with none is left out), or all lanes on
    ``device`` without a mesh."""
    if mesh is None or len(mesh) < 2:
        return [(slice(0, n_lanes), device)]
    groups = np.array_split(np.arange(n_lanes), len(mesh))
    return [(slice(int(g[0]), int(g[-1]) + 1), d)
            for g, d in zip(groups, mesh) if len(g)]


def run_chain(gen: torch.Generator, init_state: PointsState,
              maps: EnergyMaps, spec: EnergySpec, comb: EnergyCombiner,
              kd: KernelData, n_steps: int, t0: float = 1.0,
              alpha_t: float = 0.999, t_target: float = 0.0,
              n_samples: int = 0, samples_interval: int = 1,
              burn_in: int = 0, step_offset: int = 0, mesh=None):
    """``n_steps`` annealed steps of B lanes (laned state, maps and kernel
    data; every draw from ``gen``, shaped over the lanes).

    With ``n_samples > 0`` the state of global step ``g = step_offset +
    i`` is kept when ``g >= burn_in and g % samples_interval == 0``, in a
    rolling buffer of the last ``n_samples``: ``take`` depends on the step
    counters alone, so the buffer is written on the device with no host
    read. Returns ``(state, stats)``, or ``(state, stats, samples,
    n_collected)`` with ``samples`` laned (B, n_samples, K, ...), oldest
    first (the valid ones at the end), and ``n_collected`` the host count
    of sampling steps in this call, the same for every lane.

    ``mesh``: the lanes run in contiguous groups, one per device
    (``lane_groups``); each step's numbers are drawn once for all lanes on
    the inputs' device and each group takes its rows, so the run equals
    the unsplit one. The results come back to the inputs' device."""
    n_lanes, n_k = init_state.xy.shape[0], kd.p_kernels.shape[-1]
    home = init_state.xy.device
    parts = lane_groups(n_lanes, mesh, home)
    steps, carries = [], []
    for at, dev in parts:
        maps_p, kd_p, state_p = (to_device(lanes(x, at), dev)
                                 for x in (maps, kd, init_state))
        comb_p = to_device(comb, dev)
        steps.append(make_step_fn(maps_p, spec, comb_p, kd_p, alpha_t,
                                  t_target))
        cache = build_cache(state_p, maps_p, spec)
        carries.append((state_p, cache, energy_from_cache(
            state_p, maps_p, spec, comb_p, cache), float(t0)))
    accepted = torch.zeros((n_lanes, n_k), device=home)
    proposed = torch.zeros((n_lanes, n_k), device=home)
    ones = torch.ones((n_lanes, 1), device=home)
    bufs = None
    if n_samples > 0:
        bufs = [type(init_state)(**{
            f: torch.zeros((c[0].xy.shape[0], n_samples) + getattr(
                init_state, f).shape[1:], dtype=getattr(init_state, f).dtype,
                device=dev) for f in init_state.__dataclass_fields__})
            for c, (_, dev) in zip(carries, parts)]
    n_coll = 0
    for i in range(n_steps):
        raw = (draw_step(gen, n_lanes, init_state.capacity, home)
               if len(parts) > 1 else None)
        for j, (at, dev) in enumerate(parts):
            carries[j], (acc, kernel) = steps[j](
                carries[j], gen, None if raw is None else raw_lanes(raw, at,
                                                                    dev))
            kernel = kernel.to(home)
            accepted[at].scatter_add_(1, kernel[:, None],
                                      acc[:, None].float().to(home))
            proposed[at].scatter_add_(1, kernel[:, None], ones[at])
        g = step_offset + i
        if bufs is not None and g >= burn_in and g % samples_interval == 0:
            pos = n_coll % n_samples
            for buf, carry in zip(bufs, carries):
                for f in buf.__dataclass_fields__:
                    getattr(buf, f)[:, pos] = getattr(carry[0], f)
            n_coll += 1
    state = cat_lanes([c[0] for c in carries], home)
    energy = cat_lanes([c[2] for c in carries], home)
    stats = ChainStats(accepted=accepted, proposed=proposed,
                       final_energy=energy, final_n_points=state.n_points,
                       final_temperature=carries[0][3])
    if bufs is None:
        return state, stats
    buf = cat_lanes(bufs, home)
    shift = -(n_coll % n_samples)
    samples = type(buf)(**{f: torch.roll(getattr(buf, f), shift, dims=1)
                           for f in buf.__dataclass_fields__})
    return state, stats, samples, n_coll


def run_chains_batch(gen: torch.Generator, init_states: PointsState,
                     maps: EnergyMaps, spec: EnergySpec,
                     comb: EnergyCombiner, kd: KernelData, n_steps: int,
                     t0: float = 1.0, alpha_t: float = 0.999,
                     t_target: float = 0.0):
    """B independent chains of one tile: ``init_states`` laned (B, K),
    ``maps`` and ``kd`` one tile's, seen as B lanes without a copy."""
    n = init_states.xy.shape[0]
    return run_chain(gen, init_states, expand_lanes(maps, n), spec, comb,
                     expand_lanes(kd, n), n_steps, t0, alpha_t, t_target)


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
