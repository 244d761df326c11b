"""Perturbed configurations for energy-weight training (negatives vs GT).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/perturbations.py``:
gaussian jitter / add / remove presets (light, medium, strong) and kernel
perturbations (``n_moves`` proposals of the RJMCMC mixture applied from GT,
always accepted). The B GT configurations of a batch and their S samples
run as (B, S) lanes of one program: one launch sequence per move for all
lanes, which read their image's kernel data through its index
(``mpp/kernels.py``). Random numbers come from one ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict

import torch

from mpp_cnn_rs_object_detection_torch.mpp.kernels import (
    KernelData,
    apply_proposal,
    sample_proposal,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import PointsState

PERTURBATION_LIGHT = {
    "move_proba": 0.1,
    "param_shift_proba": (0.1, 0.1, 0.1),
    "position_sigma": 1.0,
    "param_sigmas": (0.02, 0.02, 0.02),
    "point_number_sigma": 0.1,
    "no_addition": True,
}
PERTURBATION_MEDIUM = {
    "move_proba": 0.5,
    "param_shift_proba": (0.5, 0.5, 0.5),
    "position_sigma": 5.0,
    "param_sigmas": (0.1, 0.1, 0.1),
    "point_number_sigma": 1.0,
}
PERTURBATION_STRONG = {
    "move_proba": 0.9,
    "param_shift_proba": (0.9, 0.9, 0.9),
    "position_sigma": 20.0,
    "param_sigmas": (0.5, 0.5, 0.5),
    "point_number_sigma": 10.0,
}
PRESETS = {
    "light": PERTURBATION_LIGHT,
    "medium": PERTURBATION_MEDIUM,
    "strong": PERTURBATION_STRONG,
}


def sample_lanes(gt: PointsState, n_samples: int) -> PointsState:
    """(B, K) GT configurations as (B, S, K) lanes (a copy each)."""
    def rep(x):
        return x[:, None].expand((x.shape[0], n_samples) + x.shape[1:]
                                 ).clone()
    return PointsState(xy=rep(gt.xy), marks=rep(gt.marks),
                       alive=rep(gt.alive))


def sample_perturbed_state(gen: torch.Generator, gt: PointsState,
                           kd: KernelData, shape_hw, preset: Dict
                           ) -> PointsState:
    """Gaussian perturbations of every lane of ``gt`` ((B, S, K) lanes of
    B images; ``kd`` the images' (B, ...) kernel data): drop or add points
    by a gaussian count shift, jitter positions with probability
    ``move_proba`` and each mark with ``param_shift_proba[i]`` and sigma
    ``param_sigmas[i] * range``. Additions are uniform rectangles that
    claim free slots."""
    lead = gt.alive.shape
    dev = gt.xy.device
    kcap = lead[-1]
    n0 = gt.alive.sum(dim=-1)
    vmin, vmax = kd.map_vmin[:, None, None, :], kd.map_vmax[:, None, None, :]
    cyclic = kd.map_cyclic[:, None, None, :]

    n_target = torch.clamp(torch.round(
        n0 + preset["point_number_sigma"]
        * torch.randn(lead[:-1], generator=gen, device=dev)), 0, kcap).long()
    if preset.get("no_addition"):
        n_target = torch.minimum(n_target, n0)

    # removals: keep a random subset of the alive points of size n_target
    drop = torch.where(gt.alive, torch.rand(lead, generator=gen, device=dev),
                       -1.0)  # dead slots last
    rank = torch.argsort(torch.argsort(-drop, dim=-1), dim=-1)
    alive = gt.alive & (rank < n_target[..., None])

    # additions: fill free slots up to n_target with uniform rectangles
    n_add = torch.clamp(n_target - alive.sum(dim=-1), min=0)
    free_rank = torch.cumsum((~alive).long(), dim=-1) - 1
    add = (~alive) & (free_rank < n_add[..., None])
    h, w = shape_hw
    rand_xy = torch.rand(lead + (2,), generator=gen, device=dev) * torch.tensor(
        [h - 1, w - 1], dtype=torch.float32, device=dev)
    rand_marks = vmin + torch.rand(lead + (3,), generator=gen,
                                   device=dev) * (vmax - vmin)
    xy = torch.where(add[..., None], rand_xy, gt.xy)
    marks = torch.where(add[..., None], rand_marks, gt.marks)
    alive = alive | add

    # position jitter
    do_move = torch.rand(lead, generator=gen, device=dev) < preset[
        "move_proba"]
    shift = preset["position_sigma"] * torch.randn(lead + (2,), generator=gen,
                                                   device=dev)
    hi = torch.tensor([h - 1, w - 1], dtype=torch.float32, device=dev)
    moved = torch.minimum(torch.clamp(torch.trunc(xy + shift), min=0.0), hi)
    xy = torch.where((do_move & alive)[..., None], moved, xy)

    # mark jitter (cyclic wrap for the angle, clip otherwise)
    sigmas = torch.tensor(preset["param_sigmas"], dtype=torch.float32,
                          device=dev) * (vmax - vmin)
    do_shift = torch.rand(lead + (3,), generator=gen, device=dev) < torch.tensor(
        preset["param_shift_proba"], dtype=torch.float32, device=dev)
    new_vals = marks + sigmas * torch.randn(lead + (3,), generator=gen,
                                            device=dev)
    wrapped = ((new_vals - vmin) % (vmax - vmin)) + vmin
    clipped = torch.minimum(torch.maximum(new_vals, vmin), vmax)
    new_marks = torch.where(cyclic, wrapped, clipped)
    marks = torch.where(do_shift & alive[..., None], new_marks, marks)
    return PointsState(xy=xy, marks=marks, alive=alive)


def sample_kernel_perturbed_state(gen: torch.Generator, state: PointsState,
                                  kd: KernelData, n_moves: int
                                  ) -> PointsState:
    """``n_moves`` random kernel proposals applied to every lane, always
    accepted (no Metropolis test): one laned move per step."""
    for _ in range(n_moves):
        state = apply_proposal(state, sample_proposal(gen, state, kd))
    return state


def sample_perturbed_batch(gen: torch.Generator, gt: PointsState,
                           kd: KernelData, shape_hw, preset: Dict,
                           n_samples: int) -> PointsState:
    """(B, S, K) gaussian perturbations of the B GT configurations (B, K)."""
    return sample_perturbed_state(gen, sample_lanes(gt, n_samples), kd,
                                  shape_hw, preset)


def sample_kernel_perturbed_batch(gen: torch.Generator, gt: PointsState,
                                  kd: KernelData, n_moves: int,
                                  n_samples: int) -> PointsState:
    """(B, S, K) kernel perturbations of the B GT configurations (B, K)."""
    return sample_kernel_perturbed_state(gen, sample_lanes(gt, n_samples),
                                         kd, n_moves)
