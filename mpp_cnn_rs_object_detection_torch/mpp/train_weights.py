"""Energy-combination weight learning (the MPP's trainable part).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/train_weights.py``:

  - **Ordering criterion**: perturb GT configurations with kernel moves
    and maximise the mean energy increase,
    ``loss = -mean(U(perturbed) - U(gt))``;
  - **Integral criterion** (contrastive): ``loss = mean(U(gt+)) -
    mean(U(neg-)) (+ reg)``, positives and negatives from the gaussian
    presets.

The energy vectors do not depend on the combiner's parameters, so they are
computed without grad -- the B GT configurations and their B x S perturbed
samples as one laned call (``energies.lane_energy_vectors``) -- and only
``combine`` sits under torch autograd. The steps are optax's formulas
written out (``optim.Optimizer``), so the two packages take the same steps
on the same vectors. Both criteria run on the CUDA device unless the caller
passes ``device="cpu"``, and return an ``EnergyCombiner``; its JSON is the
model store's artifact.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
    EnergyCombiner,
    combine,
    combiner_as_report_dict,
    init_combiner,
    regularisation,
)
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
    lane_energy_vectors,
    stack_param_dists,
)
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import EnergySetup
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.kernels import KernelData
from mpp_cnn_rs_object_detection_torch.mpp.optim import Optimizer
from mpp_cnn_rs_object_detection_torch.mpp.perturbations import (
    PRESETS,
    sample_kernel_perturbed_batch,
    sample_perturbed_batch,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    stack_lanes,
    state_from_arrays,
)

NON_TRAINABLE = ("threshold", "raw_energy")
# the stages a trainer times into its ``seconds`` dict
TRAIN_STAGES = ("prepare", "perturb", "vectors", "steps")


def _on_device(c: ImageWMaps, device) -> ImageWMaps:
    """The crop with its detection and mark maps on ``device``."""
    return dataclasses.replace(
        c, detection_map=torch.as_tensor(c.detection_map, dtype=torch.float32,
                                         device=device),
        param_dist_maps=stack_param_dists(c.param_dist_maps, device=device))


def prepare_batch(crops: List[ImageWMaps], setup: EnergySetup,
                  capacity: int, device) -> Tuple[EnergyMaps, KernelData,
                                                  PointsState]:
    """The crops' energy maps, kernel data (intensity: the GT count) and
    GT configurations, stacked on a leading image axis on ``device``."""
    on = [_on_device(c, device) for c in crops]
    n = len(crops)
    maps = stack_lanes(lambda i: setup.make_maps(on[i]), n)
    kd = stack_lanes(lambda i: setup.make_kernel_data(
        on[i], intensity=max(1, len(on[i].gt_centers))), n)
    gt = stack_lanes(lambda i: state_from_arrays(
        on[i].gt_centers[:capacity], on[i].gt_marks[:capacity],
        capacity=capacity, device=device), n)
    return maps, kd, gt


def _masked_grads(params: Dict[str, torch.Tensor],
                  grads: Dict[str, Optional[torch.Tensor]]) -> Dict:
    """Gradients per parameter: zero for the non-trainable entries (the
    reference models' constants) and for those the loss does not reach."""
    return {k: (torch.zeros_like(v)
                if k in NON_TRAINABLE or grads.get(k) is None else grads[k])
            for k, v in params.items()}


def _make_optimizer(params, learning_rate: float, optim: str,
                    lr_scheduler: bool, lr_scheduler_params) -> Optimizer:
    gamma = ((lr_scheduler_params or {}).get("gamma", 0.95)
             if lr_scheduler else None)
    return Optimizer(params, learning_rate,
                     "adam" if optim == "adam" else "sgd", gamma)


def _config_energies(comb: EnergyCombiner, vec: torch.Tensor,
                     alive: torch.Tensor) -> torch.Tensor:
    """U of each configuration: the sum of its alive points' combined
    energies, (...,) from (..., K, E) vectors."""
    return torch.where(alive, combine(comb, vec), 0.0).sum(dim=-1)


def ordering_loss(comb: EnergyCombiner, vec_gt, alive_gt, vec_pert,
                  alive_pert, reg_weight: float = 0.0) -> torch.Tensor:
    """``-mean(U(perturbed) - U(gt))`` over the (B, S) samples (+ the
    regulariser): vectors (B, K, E) and (B, S, K, E)."""
    u_gt = _config_energies(comb, vec_gt, alive_gt)
    u_pert = _config_energies(comb, vec_pert, alive_pert)
    loss = -torch.mean(u_pert - u_gt[:, None])
    if reg_weight:
        loss = loss + reg_weight * regularisation(comb)
    return loss


def integral_loss(comb: EnergyCombiner, vec_pos, alive_pos, vec_neg,
                  alive_neg, reg_weight: float = 0.0) -> torch.Tensor:
    """``mean(U(pos)) - mean(U(neg))`` (+ ``reg_weight`` times their
    squares): vectors (B, S, K, E)."""
    e_plus = _config_energies(comb, vec_pos, alive_pos).mean()
    e_minus = _config_energies(comb, vec_neg, alive_neg).mean()
    loss = e_plus - e_minus
    if reg_weight:
        loss = loss + reg_weight * (torch.square(e_plus)
                                    + torch.square(e_minus))
    return loss


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Stages:
    """Seconds by stage into ``seconds`` (host clock; the device is
    synchronised at each stage's end)."""

    def __init__(self, seconds: Optional[Dict[str, float]], device):
        self.seconds = seconds if seconds is not None else {}
        for k in TRAIN_STAGES:
            self.seconds.setdefault(k, 0.0)
        self.device = device
        self.t = time.perf_counter()

    def lap(self, stage: Optional[str]) -> None:
        """Close the running stage (None: time outside every stage)."""
        _sync(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.seconds[stage] += now - self.t
        self.t = now


def ordering_vectors(gen: torch.Generator, maps_b: EnergyMaps,
                     kd_b: KernelData, gt_b: PointsState, spec: EnergySpec,
                     n_moves: int, n_samples: int, stages: _Stages):
    """The kernel-perturbed samples of a batch and the energy vectors of
    its GT and perturbed configurations, as one laned call:
    ``(vec_gt (B, K, E), alive_gt, vec_pert (B, S, K, E), alive_pert)``."""
    pert = sample_kernel_perturbed_batch(gen, gt_b, kd_b, n_moves,
                                         n_samples)
    stages.lap("perturb")
    both = PointsState(
        xy=torch.cat([gt_b.xy[:, None], pert.xy], dim=1),
        marks=torch.cat([gt_b.marks[:, None], pert.marks], dim=1),
        alive=torch.cat([gt_b.alive[:, None], pert.alive], dim=1))
    vec = lane_energy_vectors(both, maps_b, spec)
    stages.lap("vectors")
    return vec[:, 0], gt_b.alive, vec[:, 1:], pert.alive


def _train(crops: List[ImageWMaps], setup: EnergySetup, logger,
           rng: np.random.Generator, n_epochs: int, learning_rate: float,
           optim: str, weight_model_type: str, lr_scheduler: bool,
           lr_scheduler_params, batch_size: int, capacity: int, device,
           seconds, name: str, vectors_of, loss_of) -> EnergyCombiner:
    """The epoch loop both criteria share: one generator seeded from
    ``rng`` (as the JAX package seeds its key), a ``rng.permutation`` of
    the crops per epoch, ``len(crops) // batch_size`` batches of vectors
    (``vectors_of``, without grad) and optimiser steps on ``loss_of``."""
    device = resolve_device(device)
    comb = init_combiner(weight_model_type, setup.spec.names, device=device)
    opt = _make_optimizer(comb.params, learning_rate, optim, lr_scheduler,
                          lr_scheduler_params)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 31)))
    stages = _Stages(seconds, device)
    params = comb.params
    n_batches = max(1, len(crops) // batch_size)
    loss = None
    for epoch in range(n_epochs):
        order = rng.permutation(len(crops))
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            stages.lap(None)
            maps_b, kd_b, gt_b = prepare_batch([crops[i] for i in idx],
                                               setup, capacity, device)
            stages.lap("prepare")
            with torch.no_grad():
                vecs = vectors_of(gen, maps_b, kd_b, gt_b, stages)
            leaf = {k: v.detach().requires_grad_(k not in NON_TRAINABLE)
                    for k, v in params.items()}
            loss = loss_of(comb.replace(params=leaf), *vecs)
            trained = [k for k, v in leaf.items() if v.requires_grad]
            grads = dict(zip(trained, torch.autograd.grad(
                loss, [leaf[k] for k in trained], allow_unused=True)))
            params = opt.step({k: v.detach() for k, v in leaf.items()},
                              _masked_grads(leaf, grads))
            stages.lap("steps")
        comb = comb.replace(params=params)
        loss_f = float(loss.detach())
        if logger is not None:
            logger.update(epoch, {"loss": loss_f,
                                  **combiner_as_report_dict(comb)})
        logging.info(f"[{name}] epoch {epoch}: loss {loss_f:.4f}")
    return comb


def train_ordering_criterion(crops: List[ImageWMaps], setup: EnergySetup,
                             logger, save_dir: str, rng: np.random.Generator,
                             n_epochs: int = 8, samples_per_image: int = 16,
                             learning_rate: float = 0.05, optim: str = "adam",
                             reg_weight: float = 0.0,
                             weight_model_type: str = "logistic",
                             neg_pert_config: Dict = None,
                             lr_scheduler: bool = False,
                             lr_scheduler_params: Dict = None,
                             batch_size: int = 8, capacity: int = 256,
                             device=None,
                             seconds: Optional[Dict[str, float]] = None,
                             **_unused) -> EnergyCombiner:
    """Ordering criterion over kernel perturbations: ``iter_per_point``
    times the largest GT count of the crops in moves per sample.
    ``seconds`` (if given) accumulates the stages of ``TRAIN_STAGES``."""
    spec = setup.spec
    iter_per_point = (neg_pert_config or {}).get("iter_per_point", 1.0)
    n_moves = max(1, int(iter_per_point * max(
        1, max(len(c.gt_centers) for c in crops))))

    def vectors_of(gen, maps_b, kd_b, gt_b, stages):
        return ordering_vectors(gen, maps_b, kd_b, gt_b, spec, n_moves,
                                samples_per_image, stages)

    def loss_of(comb, *vecs):
        return ordering_loss(comb, *vecs, reg_weight=reg_weight)

    return _train(crops, setup, logger, rng, n_epochs, learning_rate, optim,
                  weight_model_type, lr_scheduler, lr_scheduler_params,
                  batch_size, capacity, device, seconds, "ordering",
                  vectors_of, loss_of)


def train_integral_criterion(crops: List[ImageWMaps], setup: EnergySetup,
                             logger, save_dir: str, rng: np.random.Generator,
                             n_epochs: int = 8, samples_per_image: int = 8,
                             learning_rate: float = 0.05, optim: str = "adam",
                             reg_weight: float = 0.0,
                             weight_model_type: str = "logistic",
                             pos_pert: str = "light", neg_pert: str = "medium",
                             lr_scheduler: bool = False,
                             lr_scheduler_params: Dict = None,
                             batch_size: int = 8, capacity: int = 256,
                             device=None,
                             seconds: Optional[Dict[str, float]] = None,
                             **_unused) -> EnergyCombiner:
    """Contrastive criterion: positives from the ``pos_pert`` preset (GT
    lightly jittered), negatives from ``neg_pert``."""
    spec = setup.spec
    pos_preset, neg_preset = PRESETS[pos_pert], PRESETS[neg_pert]
    patch_hw = crops[0].shape

    def vectors_of(gen, maps_b, kd_b, gt_b, stages):
        out = []
        for preset in (pos_preset, neg_preset):
            states = sample_perturbed_batch(gen, gt_b, kd_b, patch_hw, preset,
                                            samples_per_image)
            stages.lap("perturb")
            out += [lane_energy_vectors(states, maps_b, spec), states.alive]
            stages.lap("vectors")
        return out

    def loss_of(comb, *vecs):
        return integral_loss(comb, *vecs, reg_weight=reg_weight)

    return _train(crops, setup, logger, rng, n_epochs, learning_rate, optim,
                  weight_model_type, lr_scheduler, lr_scheduler_params,
                  batch_size, capacity, device, seconds, "integral",
                  vectors_of, loss_of)
