"""Proposal-kernel data and helpers used by the cell-parallel superstep.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/kernels.py``:
``KernelData`` (normalised birth density, mark distributions, mixture
probabilities, scales) and the value/class helpers the superstep uses. The
sequential 10-kernel mixture and its helpers (``_window_logprobs``, and
``_clip_marks`` of split/merge) are not ported in this slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    mapping_tensors,
    stack_param_dists,
)

EPS = 1e-16
MAX_DELTA = 8  # data-translation window half-size
WINDOW = 2 * MAX_DELTA + 1

BASE_KERNEL_WEIGHTS = {
    "bd_weight": 1.0,
    "uniform_bd_weight": 1.0,
    "data_bd_weight": 2.0,
    "translation_weight": 1.0,
    "gaussian_translation_weight": 1.0,
    "data_translation_weight": 2.0,
    "transformation_weight": 1.0,
    "gaussian_transformation_weight": 1.0,
    "data_transformation_weight": 2.0,
}


@dataclass
class KernelData:
    """Device-resident sampling inputs for one scene."""

    birth_cdf: torch.Tensor          # (H*W,) cumsum of the normalised map
    log_birth_density: torch.Tensor  # (H, W)
    mark_dists: torch.Tensor         # (3, H, W, C) normalised
    padded_density: torch.Tensor     # (H + 2*MAX_DELTA, W + 2*MAX_DELTA)
    map_vmin: torch.Tensor           # (3,)
    map_vmax: torch.Tensor           # (3,)
    map_cyclic: torch.Tensor         # (3,) bool
    p_kernels: torch.Tensor          # (8,)
    log_norm_const: torch.Tensor     # log(H * W * C^3)
    intensity: torch.Tensor          # scalar
    sigma_trl: torch.Tensor          # scalar (2.0)
    sigma_trf: torch.Tensor          # (3,) = 0.1 * mark range


def kernel_probabilities() -> np.ndarray:
    """The 8-kernel mixture from the reference's decision tree (default
    weights, no split/merge)."""
    w = BASE_KERNEL_WEIGHTS
    top = np.array([w["bd_weight"], w["translation_weight"],
                    w["transformation_weight"]])
    p_bd, p_trl, p_trf = top / top.sum()
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
    p = np.array(p)
    assert abs(p.sum() - 1.0) < 1e-8
    return p


def make_kernel_data(detection_map, mark_dist_maps, mappings,
                     intensity: float) -> KernelData:
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
        p_kernels=torch.as_tensor(kernel_probabilities(),
                                  dtype=torch.float32, device=dev),
        log_norm_const=scalar(np.log(float(h * w * c ** 3))),
        intensity=scalar(intensity),
        sigma_trl=scalar(2.0),
        sigma_trf=torch.tensor([0.1 * (m.v_max - m.v_min) for m in mappings],
                               dtype=torch.float32, device=dev),
    )


def _log(x):
    return torch.log(x + EPS)


def _class_to_value(kd: KernelData, mark_idx, cls) -> torch.Tensor:
    n_cls = kd.mark_dists.shape[-1]
    step = (kd.map_vmax[mark_idx] - kd.map_vmin[mark_idx]) / n_cls
    return kd.map_vmin[mark_idx] + cls.float() * step


def _value_to_class(kd: KernelData, mark_idx, value) -> torch.Tensor:
    n_cls = kd.mark_dists.shape[-1]
    vmin, vmax = kd.map_vmin[mark_idx], kd.map_vmax[mark_idx]
    rng = vmax - vmin
    val = torch.where(kd.map_cyclic[mark_idx], ((value - vmin) % rng) + vmin,
                      value)
    cls = torch.floor((val - vmin) / (rng / n_cls)).long()
    return torch.clamp(cls, 0, n_cls - 1)


def _normal_logpdf(x, sigma):
    return -0.5 * (x / sigma) ** 2 - torch.log(sigma * math.sqrt(2.0 * math.pi))
