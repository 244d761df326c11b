"""The model interface of the CLI and the CNN trainer.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/base.py``:
``BaseModel`` (without ``data_preview``, ``ROADMAP.md`` item 16) and the
device-resident path of ``PatchBasedTrainer`` (``__init_data_device__``,
``_regen_device_stacks``, ``_train_device``), which every trained CNN config
of the repository uses (``data_loader.device_pipeline``): patch stacks
built on the host and kept on the device, each batch augmented and turned
into targets there, one adam step per batch, metrics read once per epoch,
a rolling checkpoint every epoch and ``model.msgpack`` at the end.

The JAX trainer's host pipeline (PNG patch datasets on disk, ``DataAugment``
with CLAHE, histogram matching and shadow/fog, the host label processors,
error-density hard mining) is not ported (``ROADMAP.md`` item 12): a
config without ``data_loader.device_pipeline`` raises.
"""

from __future__ import annotations

import copy
import time
from abc import ABC, abstractmethod
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
    PatchStack,
    augment_batch,
    build_patch_stack,
    draw_augment_variates,
)
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    latest_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.train_utils import (
    TrainState,
    eval_step,
    load_checkpoint,
    mean_metrics,
    save_checkpoint,
    stacked_metrics,
    train_step,
)
from mpp_cnn_rs_object_detection_torch.models.unet import init_like_flax_

# the JAX trainer draws epoch e's augmentation from fold_in(PRNGKey(1234), e);
# the port seeds a generator per epoch from the same pair
AUG_SEED = 1234


class BaseModel(ABC):
    @abstractmethod
    def infer(self, subset: str, **kwargs):
        ...

    @abstractmethod
    def eval(self):
        ...

    def infereval(self, subset: str = "val", **kwargs):
        self.infer(subset=subset, **kwargs)
        self.eval()


def require_device_pipeline(config: Dict) -> None:
    if not (config.get("data_loader") or {}).get("device_pipeline"):
        raise NotImplementedError(
            f"training {config.get('model_name')} needs the host patch "
            "pipeline (no data_loader.device_pipeline in its config), which "
            "is not ported (ROADMAP.md item 12)")


class DeviceStack(NamedTuple):
    """A ``PatchStack`` on the device, with its per-patch object counts on
    the host (the width each batch's targets need)."""

    images: torch.Tensor
    centers: torch.Tensor
    params: torch.Tensor
    valid: torch.Tensor
    counts: np.ndarray

    @classmethod
    def of(cls, stack: PatchStack, device) -> "DeviceStack":
        return cls(*(torch.from_numpy(a).to(device) for a in (
            stack.images, stack.centers, stack.params, stack.valid)),
            counts=stack.valid.sum(axis=1))

    def batch(self, idx: torch.Tensor, m: int):
        """(images u8, centers, params, valid) of the patches ``idx``, the
        annotations cut to their first ``m`` slots."""
        return (self.images[idx], self.centers[idx, :m],
                self.params[idx, :m], self.valid[idx, :m])


class PatchBasedTrainer:
    """The CNN trainer. The model defines ``make_train_state(dtype,
    device)`` (builds and binds its modules), ``loss(x, y, train)`` and
    ``targets(centers, params, valid)``, and holds ``config``,
    ``dataset``, ``device``, ``logger`` and ``save_path``."""

    state: TrainState

    def init_training(self, dtype: torch.dtype, resume: bool) -> None:
        """Fresh flax-initialised modules (or, with ``resume``, the newest
        checkpoint of the model store), then the train and val stacks."""
        self.state = self.make_train_state(dtype, self.device)
        gen = torch.Generator().manual_seed(0)
        for m in self.state.modules.values():
            init_like_flax_(m, gen)
        self.n_epochs = self.config["trainer"]["n_epochs"]
        self.batch_size = self.config["trainer"]["batch_size"]
        self.last_epoch = 0
        if resume:
            try:
                ckpt = latest_checkpoint(self.save_path)
            except FileNotFoundError:
                ckpt = None
            if ckpt is not None:
                self.last_epoch = load_checkpoint(ckpt, self.state)
        self.rng = np.random.default_rng(42)
        # host seconds of each build_patch_stack: (subset, seconds)
        self.stack_seconds: List[Tuple[str, float]] = []
        self.epoch_seconds: List[float] = []
        self.dataset_update_interval = self.config["data_loader"][
            "dataset_update_interval"]
        self.regen_stacks(make_val=True)

    def regen_stacks(self, make_val: bool = False) -> None:
        pm = self.config["data_loader"]["patch_maker_params"]
        common = dict(
            patch_size=pm["patch_size"],
            unf_weight=pm.get("unf_sampler_weight", 0.33),
            obj_weight=pm.get("obj_sampler_weight", 0.66),
            sigma=pm.get("obj_sampler_sigma") or 0.0,
            max_objects=pm.get("max_objects", 128),
            rng=self.rng,
        )
        t0 = time.perf_counter()
        stack = build_patch_stack(self.dataset, "train",
                                  n_patches=pm["n_patches"],
                                  copy_paste=pm.get("copy_paste"), **common)
        self.stack_seconds.append(("train", time.perf_counter() - t0))
        self.train_stack = DeviceStack.of(stack, self.device)
        if make_val:
            t0 = time.perf_counter()
            vstack = build_patch_stack(
                self.dataset, "val",
                n_patches=max(pm.get("val_patches", pm["n_patches"] // 2),
                              64), **common)
            self.stack_seconds.append(("val", time.perf_counter() - t0))
            self.val_stack = DeviceStack.of(vstack, self.device)

    def train_batch(self, batch, v) -> Dict[str, torch.Tensor]:
        """One step on a gathered batch with the augmentation variates
        ``v``: augment, paint the targets, step."""
        x, cen, par, val = augment_batch(*batch, v)
        return train_step(self.state, self.loss, x, self.targets(cen, par,
                                                                 val))

    def train_replica(self, device, dtype: torch.dtype = torch.float32
                      ) -> "PatchBasedTrainer":
        """A shallow copy training a ``dtype`` copy of this state on
        ``device`` (config and stacks shared): the same step on two devices
        checks one against the other."""
        rep = copy.copy(self)
        rep.device = torch.device(device)
        rep.state = rep.make_train_state(dtype, rep.device)
        rep.state.load_jax(self.state.to_jax())
        return rep

    def _widths(self, stack: DeviceStack, rows: np.ndarray) -> np.ndarray:
        """Per batch the object slots its targets need (at least one)."""
        return np.maximum(stack.counts[rows].max(axis=1), 1)

    def train_epoch(self, epoch: int) -> Dict[str, np.ndarray]:
        b = self.batch_size
        n = self.train_stack.counts.shape[0]
        perm = self.rng.permutation(n)[: (n // b) * b].reshape(-1, b)
        widths = self._widths(self.train_stack, perm)
        idx = torch.from_numpy(perm).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            AUG_SEED * 100_003 + epoch)
        p = self.train_stack.images.shape[1]
        steps = [self.train_batch(
            self.train_stack.batch(idx[s], int(widths[s])),
            draw_augment_variates(gen, b, p, self.device))
            for s in range(perm.shape[0])]
        return stacked_metrics(steps)

    def val_epoch(self) -> Dict[str, np.ndarray]:
        b = self.batch_size
        vn = self.val_stack.counts.shape[0]
        rows = np.arange((vn // b) * b).reshape(-1, b)
        widths = self._widths(self.val_stack, rows)
        idx = torch.from_numpy(rows).to(self.device)
        steps = []
        for s in range(rows.shape[0]):
            img, cen, par, val = self.val_stack.batch(idx[s], int(widths[s]))
            steps.append(eval_step(self.state, self.loss,
                                   img.to(torch.float32) / 255.0,
                                   self.targets(cen, par, val)))
        return stacked_metrics(steps)

    def train(self) -> None:
        """Epochs ``last_epoch .. n_epochs - 1``: the train epoch, the val
        epoch, a log line and a rolling checkpoint; the train stack is
        regenerated after every ``dataset_update_interval``-th epoch but
        the first and the last."""
        for epoch in range(self.last_epoch, self.n_epochs):
            t0 = time.perf_counter()
            train_metrics = mean_metrics(
                {k: list(v) for k, v in self.train_epoch(epoch).items()})
            val_metrics = mean_metrics(
                {k: list(v) for k, v in self.val_epoch().items()})
            self.epoch_seconds.append(time.perf_counter() - t0)
            print(f"[{epoch:04}] "
                  + " ".join(f"{k}: {v:.4f}" for k, v in train_metrics.items())
                  + " | val "
                  + " ".join(f"{k}: {v:.4f}" for k, v in val_metrics.items()),
                  flush=True)
            self.logger.update_train_val(epoch, train_metrics, val_metrics)
            save_checkpoint(self.save_path, self.state, epoch + 1)
            if (epoch % self.dataset_update_interval == 0 and epoch != 0
                    and epoch != self.n_epochs - 1):
                self.regen_stacks()
        self.state.train(False)
        self.save()
