"""Vectorised MPP energies on torch tensors.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/energies.py`` for the
CNN data term: unary energies are bilinear map gathers (tri-linear in the
mark value for the mark maps), pair energies are (K, K) matrices masked by
alive x alive and the interaction radius, reduced per row.

The chain's functions take states and maps with one leading lane axis B
(``mpp/state.py``): lane b's points read lane b's maps. The one-config
references (``energy_vectors``, ``total_energy``) add a lane of one at
their boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    expand_lanes,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import (
    marks_to_poly,
    quad_intersection_area_matrix,
    rect_area,
)


@dataclass(frozen=True)
class EnergySpec:
    """Which energy columns exist (the CNN data term; the contrast and
    gradient data terms are not ported)."""

    names: Tuple[str, ...]
    shape_mode: str = "mean"  # 'mean' (one ShapeEnergy) | 'separate' (3 marks)
    use_ratio_prior: bool = False
    rewarding_align: bool = True
    overlap_max_dist: float = 32.0
    align_max_dist: float = 16.0

    @property
    def n_energies(self) -> int:
        return len(self.names)


LEGACY_SPEC = EnergySpec(
    names=("PositionEnergy", "ShapeEnergy", "RectangleOverlapEnergy",
           "ShapeAlignmentEnergy", "AreaPriorEnergy"),
    shape_mode="mean",
)

NO_CALIBRATION_SPEC = EnergySpec(
    names=("PositionEnergy", "SizeEnergy", "RatioEnergy", "AngleEnergy",
           "OverlapPriorEnergy", "AlignmentPriorEnergy", "AreaPriorEnergy",
           "RatioPriorEnergy"),
    shape_mode="separate",
    use_ratio_prior=True,
)


@dataclass
class EnergyMaps:
    """Device-resident per-scene energy inputs; the chain stacks them on
    a leading lane axis ([B,])."""

    position: torch.Tensor    # ([B,] H, W) = -2 * (detection_map - thr)
    mark_maps: torch.Tensor   # ([B,] 3, H, W, C) per-mark energy maps
    map_vmin: torch.Tensor    # ([B,] 3)
    map_vmax: torch.Tensor    # ([B,] 3)
    map_cyclic: torch.Tensor  # ([B,] 3) bool
    min_area: torch.Tensor    # ([B,])
    max_area: torch.Tensor    # ([B,])
    target_ratio: torch.Tensor  # ([B,])


def lane_view(v: torch.Tensor, ndim: int, trailing: int = 0) -> torch.Tensor:
    """Per-lane values ``v`` ((B,), then ``trailing`` axes of their own)
    viewed to broadcast against an ``ndim``-axis tensor led by the same
    lanes: a (B,) scalar per lane against (B, K) points becomes (B, 1)."""
    cut = v.ndim - trailing
    return v.reshape(v.shape[:cut] + (1,) * (ndim - v.ndim) + v.shape[cut:])


def _lane_index(n_lanes: int, ndim: int, device) -> torch.Tensor:
    """arange(B) shaped to index the lane axis of ``ndim``-axis indices."""
    return torch.arange(n_lanes, device=device).reshape(
        (n_lanes,) + (1,) * (ndim - 1))


def stack_param_dists(param_dist_maps, pad_hw=None, device=None
                      ) -> torch.Tensor:
    """Stack 3 (H, W, C) mark maps into (3, H, W, C), zero-padding H/W at the
    bottom/right by ``pad_hw``."""
    if isinstance(param_dist_maps, (list, tuple)):
        d = torch.stack([torch.as_tensor(m, dtype=torch.float32, device=device)
                         for m in param_dist_maps])
    else:
        d = torch.as_tensor(param_dist_maps, dtype=torch.float32, device=device)
    if pad_hw is not None and (pad_hw[0] or pad_hw[1]):
        d = torch.nn.functional.pad(d, (0, 0, 0, pad_hw[1], 0, pad_hw[0]))
    return d


def mapping_tensors(mappings, device):
    vmin = torch.tensor([m.v_min for m in mappings], dtype=torch.float32,
                        device=device)
    vmax = torch.tensor([m.v_max for m in mappings], dtype=torch.float32,
                        device=device)
    cyclic = torch.tensor([m.is_cyclic for m in mappings], dtype=torch.bool,
                          device=device)
    return vmin, vmax, cyclic


def make_energy_maps(detection_map, mark_energy_maps, threshold: float,
                     min_area: float, max_area: float, mappings,
                     target_ratio: float = 0.0) -> EnergyMaps:
    """From the detection map and the already-remapped (H, W, C) mark maps
    (a list of 3 or a stacked (3, H, W, C) tensor)."""
    mark_maps = stack_param_dists(mark_energy_maps)
    dev = mark_maps.device
    det = torch.as_tensor(detection_map, dtype=torch.float32, device=dev)
    vmin, vmax, cyclic = mapping_tensors(mappings, dev)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    return EnergyMaps(
        position=-2.0 * (det - threshold), mark_maps=mark_maps,
        map_vmin=vmin, map_vmax=vmax, map_cyclic=cyclic,
        min_area=scalar(min_area), max_area=scalar(max_area),
        target_ratio=scalar(target_ratio),
    )


def bilinear_weights(x, y, h: int, w: int):
    """Continuous (x, y) -> 4 corner index pairs + weights (clamped)."""
    x = torch.clamp(x, 0.0, h - 1.0)
    y = torch.clamp(y, 0.0, w - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = torch.clamp(x0f.long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, h - 1)
    y0 = torch.clamp(y0f.long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, w - 1)
    wts = ((1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy)
    return ((x0, y0), (x0, y1), (x1, y0), (x1, y1)), wts


def position_lookup(position, xy, h: int, w: int, lane) -> torch.Tensor:
    """Bilinear detection-energy lookup of lane b's (H, W) map (``position``
    (B, H, W)) at its continuous centers ``xy`` (B, ..., 2); ``lane`` is
    ``_lane_index`` for ``xy``."""
    idx, wts = bilinear_weights(xy[..., 0], xy[..., 1], h, w)
    out = None
    for (i, j), wt in zip(idx, wts):
        term = wt * position[lane, i, j]
        out = term if out is None else out + term
    return out


def mark_lookup_interp(mark_maps, xy, marks, vmin, vmax, cyclic,
                       h: int, w: int, lane) -> torch.Tensor:
    """Tri-linear per-mark energy lookup (bilinear in space, linear between
    adjacent bin centers, cyclic wrap for the angle) of lane b's maps
    (``mark_maps`` (B, 3, H, W, C), ranges (B, 3)) at its points (``xy``
    (B, ..., 2), ``marks`` (B, ..., 3)): (B, ..., 3)."""
    idx, wts = bilinear_weights(xy[..., 0], xy[..., 1], h, w)
    n_cls = mark_maps.shape[-1]
    vmin, vmax, cyclic = (lane_view(v, marks.ndim, 1)
                          for v in (vmin, vmax, cyclic))
    rng = vmax - vmin
    step = rng / n_cls
    val = torch.where(cyclic, ((marks - vmin) % rng) + vmin, marks)
    u = (val - vmin) / step - 0.5
    k0 = torch.floor(u).long()
    t = u - k0
    k0c = torch.where(cyclic, torch.remainder(k0, n_cls),
                      torch.clamp(k0, 0, n_cls - 1))
    k1c = torch.where(cyclic, torch.remainder(k0 + 1, n_cls),
                      torch.clamp(k0 + 1, 0, n_cls - 1))
    out = []
    for m in range(3):
        v0 = v1 = None
        for (i, j), wt in zip(idx, wts):
            a = wt * mark_maps[lane, m, i, j, k0c[..., m]]
            b = wt * mark_maps[lane, m, i, j, k1c[..., m]]
            v0 = a if v0 is None else v0 + a
            v1 = b if v1 is None else v1 + b
        out.append((1.0 - t[..., m]) * v0 + t[..., m] * v1)
    return torch.stack(out, dim=-1)


def unary_terms(maps: EnergyMaps, xy, marks):
    """(position energy (B, ...), per-mark energies (B, ..., 3)) at lane
    b's (xy, marks) in lane b's maps."""
    h, w = maps.position.shape[-2:]
    lane = _lane_index(xy.shape[0], xy.ndim - 1, xy.device)
    pos = position_lookup(maps.position, xy, h, w, lane)
    mark = mark_lookup_interp(maps.mark_maps, xy, marks, maps.map_vmin,
                              maps.map_vmax, maps.map_cyclic, h, w, lane)
    return pos, mark


def data_columns(state: PointsState, maps: EnergyMaps, spec: EnergySpec):
    pos, mark_e = unary_terms(maps, state.xy, state.marks)
    if spec.shape_mode == "mean":
        return [pos, mark_e.mean(dim=-1)]
    return [pos, mark_e[..., 0], mark_e[..., 1], mark_e[..., 2]]


def pair_terms(state: PointsState, spec: EnergySpec):
    """Reduced pair energies (overlap (K,), alignment (K,)); a point with no
    interacting neighbour gets 0 for that term."""
    k = state.capacity
    dist = torch.linalg.vector_norm(state.xy[:, None] - state.xy[None], dim=-1)
    eye = torch.eye(k, dtype=torch.bool, device=state.xy.device)
    alive_pair = state.alive[:, None] & state.alive[None, :] & ~eye
    polys = marks_to_poly(state.xy, state.marks[:, 0], state.marks[:, 1],
                          state.marks[:, 2])
    inter = quad_intersection_area_matrix(polys, polys)
    areas = rect_area(state.marks[:, 0], state.marks[:, 1])
    overlap = inter / (torch.minimum(areas[:, None], areas[None, :]) + 1e-6)
    ov_mask = alive_pair & (dist <= spec.overlap_max_dist)
    overlap_red = torch.where(
        ov_mask.any(dim=1),
        torch.where(ov_mask, overlap, -torch.inf).amax(dim=1), 0.0)

    dangle = state.marks[:, None, 2] - state.marks[None, :, 2]
    align = 1.0 - torch.abs(torch.cos(dangle)) - float(spec.rewarding_align)
    al_mask = alive_pair & (dist <= spec.align_max_dist)
    if spec.rewarding_align:
        align_red = torch.where(al_mask, align, torch.inf).amin(dim=1)
    else:
        align_red = torch.where(al_mask, align, -torch.inf).amax(dim=1)
    align_red = torch.where(al_mask.any(dim=1), align_red, 0.0)
    return overlap_red, align_red


def energy_vectors(state: PointsState, maps: EnergyMaps, spec: EnergySpec
                   ) -> torch.Tensor:
    """(K, n_energies) per-point energy vectors (0 rows at dead slots)."""
    overlap_red, align_red = pair_terms(state, spec)
    area = rect_area(state.marks[:, 0], state.marks[:, 1])
    area_prior = torch.clamp(
        torch.maximum(maps.min_area - area, area - maps.max_area), min=0.0)
    cols = [c[0] for c in data_columns(expand_lanes(state, 1),
                                       expand_lanes(maps, 1), spec)]
    cols.extend([overlap_red, align_red, area_prior])
    if spec.use_ratio_prior:
        cols.append(torch.abs(maps.target_ratio - state.marks[:, 1]))
    vec = torch.stack(cols, dim=-1)
    assert vec.shape[-1] == spec.n_energies, (vec.shape, spec.names)
    return torch.where(state.alive[:, None], vec, 0.0)


def total_energy(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
                 combine: Callable[[torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
    """U(config) = sum over alive points of ``combine(energy_vector)``."""
    per_point = combine(energy_vectors(state, maps, spec))
    return torch.where(state.alive, per_point, 0.0).sum()
