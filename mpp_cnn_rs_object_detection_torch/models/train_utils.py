"""Training machinery of the CNNs: train state, steps, metrics, checkpoints.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/train_utils.py``
on one device (its mesh, ``shard_batch`` and ``replicate`` have nothing to
do on one card):

  - ``TrainState``: the modules being trained (their parameters are the
    fp32 master weights, their BatchNorm buffers the running statistics),
    the optimizer's state over the parameters (``mpp/optim.Optimizer``, the
    formulas written out, one ``torch._foreach_*`` call per formula: optax
    adam for the CNNs, the detectors' global-norm clip + adam on a
    warmup-cosine schedule) and the step count;
  - ``train_step`` / ``eval_step``: the bodies of the JAX package's
    ``make_device_epoch_fns`` scans. A step returns its metrics as device
    scalars; the epoch loop reads them once per epoch (``mean_metrics``),
    as JAX reads a scan's stacked metrics;
  - checkpoints in flax's layout: ``{"params", "batch_stats", "opt_state",
    "epoch"}`` through ``models/checkpoint.py``'s writer and reader, so the
    JAX package's ``load_checkpoint`` restores the port's files (optimizer
    included) and the port resumes JAX's.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    read_checkpoint,
    train_state_from_jax,
    train_state_to_jax,
    write_msgpack,
)
from mpp_cnn_rs_object_detection_torch.mpp.optim import Optimizer

# (x, targets, train) -> (loss, metrics dict)
LossFn = Callable[[torch.Tensor, Dict, bool], tuple]


def recentred_bias(name: str) -> bool:
    """Whether the dotted parameter ``name`` is a bias that a BatchNorm
    re-centres: every conv bias of a DoubleConv, and the transposed conv's
    (its output feeds one). Its gradient is zero but for float noise, so
    adam moves it by up to the learning rate along that noise's sign: two
    devices (or packages) part there by up to twice the learning rate per
    step, without a change in the loss."""
    return name.endswith(".bias") and ("DoubleConv_0.Conv_" in name
                                       or "ConvTranspose_0." in name)


class TrainState:
    """``modules`` maps each top-level key of the flax params tree to its
    module ("" for a module that is the tree's root); ``stats_key`` names
    the module whose BatchNorm statistics are the tree's
    ``batch_stats``. With ``clip_norm`` the optimizer is the detectors'
    ``optax.chain(clip_by_global_norm(clip_norm), adam(schedule))``, whose
    state flax stores in another layout than plain adam's."""

    def __init__(self, modules: Dict[str, nn.Module], stats_key: str,
                 learning_rate: float,
                 schedule: Optional[Callable[[int], float]] = None,
                 clip_norm: Optional[float] = None):
        self.modules = modules
        self.stats_module = modules[stats_key]
        self.params: Dict[str, nn.Parameter] = {
            (f"{key}.{name}" if key else name): p
            for key, m in modules.items() for name, p in m.named_parameters()}
        self.chain = clip_norm is not None
        self.opt = Optimizer(self.params, learning_rate, schedule=schedule,
                             clip_norm=clip_norm)
        self.step = 0

    def train(self, mode: bool = True) -> None:
        for m in self.modules.values():
            m.train(mode)

    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        """One adam step in place (grads in ``self.params``' order)."""
        with torch.no_grad():
            new = self.opt.step(self.params, dict(zip(self.params, grads)))
            torch._foreach_copy_(list(self.params.values()),
                                 list(new.values()))
        self.step += 1

    def buffers(self) -> Dict[str, torch.Tensor]:
        return dict(self.stats_module.named_buffers())

    def to_jax(self) -> Dict:
        """``{"params", "batch_stats", "opt_state"}`` in flax's layout."""
        return train_state_to_jax(self.params, self.buffers(), self.opt.mu,
                                  self.opt.nu, self.opt.count,
                                  chain=self.chain)

    def load_jax(self, tree: Dict, what: str = "state") -> bool:
        """Take a flax state tree (numpy leaves). Returns whether its adam
        state was restored: a tree without one (or of another optimizer)
        restores the weights only and keeps the fresh optimizer, as the
        JAX package's ``load_checkpoint`` does."""
        st = train_state_from_jax(tree)
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(st["params"][name])
            for name, b in self.buffers().items():
                if name in st["batch_stats"] and \
                        not name.endswith("num_batches_tracked"):
                    b.copy_(st["batch_stats"][name])
        if st["count"] is None or st["chain"] != self.chain \
                or set(st["mu"]) != set(self.params):
            logging.warning(f"{what}: stored opt_state does not match the "
                            "current optimizer stack; restored weights only "
                            "(optimizer reinitialised)")
            return False
        dev = next(iter(self.params.values())).device
        self.opt.mu = {k: st["mu"][k].to(dev) for k in self.params}
        self.opt.nu = {k: st["nu"][k].to(dev) for k in self.params}
        self.opt.count = st["count"]
        self.step = st["count"]
        return True


def train_step(state: TrainState, loss_fn: LossFn, x: torch.Tensor,
               y: Dict) -> Dict[str, torch.Tensor]:
    """Forward in train mode (batch statistics, running statistics
    updated), gradients of the loss, one adam step; the metrics stay on the
    device."""
    state.train(True)
    loss, metrics = loss_fn(x, y, True)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    state.apply_gradients(grads)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(state: TrainState, loss_fn: LossFn, x: torch.Tensor,
              y: Dict) -> Dict[str, torch.Tensor]:
    state.train(False)
    return loss_fn(x, y, False)[1]


def stacked_metrics(steps: List[Dict[str, torch.Tensor]]
                    ) -> Dict[str, np.ndarray]:
    """An epoch's per-step device metrics -> one host array per key (one
    device-to-host copy per key)."""
    if not steps:
        raise ValueError("an epoch needs at least one full batch")
    return {k: torch.stack([m[k] for m in steps]).cpu().numpy()
            for k in steps[0]}


def mean_metrics(agg: Dict[str, List[float]]) -> Dict[str, float]:
    return {k: float(np.mean(v)) for k, v in agg.items()}


# ---------------------------------------------------------------------------
# Checkpoints: model.msgpack at train end + a rolling checkpoint_NNNN.msgpack
# every epoch, in flax's layout.
# ---------------------------------------------------------------------------


def save_checkpoint(save_path: str, state: TrainState, epoch: int,
                    name: Optional[str] = None) -> None:
    """``name``, or ``checkpoint_{epoch:04}.msgpack`` replacing the
    previous rolling checkpoint."""
    data = write_msgpack({**state.to_jax(), "epoch": int(epoch)})
    if name is None:
        name = f"checkpoint_{epoch:04}.msgpack"
        for old in glob.glob(os.path.join(save_path, "checkpoint_*.msgpack")):
            os.remove(old)
    with open(os.path.join(save_path, name), "wb") as f:
        f.write(data)


def load_checkpoint(path: str, state: TrainState) -> int:
    """Restore ``state`` from a checkpoint file; returns its epoch."""
    tree = read_checkpoint(path)
    state.load_jax(tree, what=path)
    return int(tree["epoch"])
