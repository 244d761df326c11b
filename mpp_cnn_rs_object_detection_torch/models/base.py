"""The model interface of the CLI and the CNN trainer.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/base.py``:
``BaseModel`` and ``PatchBasedTrainer`` with both of JAX's input
pipelines:

  - the device-resident one (``data_loader.device_pipeline``:
    ``regen_stacks``, ``train_epoch``, ``val_epoch``): patch stacks built
    on the host and kept on the device, each batch augmented and turned
    into targets there; the stacks are rebuilt after every
    ``dataset_update_interval``-th epoch but the first and the last;
  - the host one (every other config: ``init_host_data``,
    ``host_epoch``): a PNG patch set written under
    ``temp_<model_name>`` (``data/patch_making.py``), batches loaded,
    augmented (``data/augmentation.py``) and turned into targets
    (``data/label_processing.py``) on the host by ``BatchLoader``'s
    threads, each batch copied to the device from pinned memory as the
    step needs it; the train set is rewritten after every
    ``dataset_update_interval``-th epoch but the first, the last
    included, with the error maps of the latest hard-mining pass
    (``sampling_densities``) once there are some; ``clean`` removes the
    set after ``model.msgpack`` is written.

Both run one adam step per batch, read the metrics once per epoch, and
write a rolling checkpoint every epoch and ``model.msgpack`` at the end.
JAX's host path stacks an epoch's batches before its one-dispatch scan;
the port steps batch by batch (the same steps, without holding the epoch).
``data_preview`` writes the host train loader's first batch as PNGs; a
device-pipeline config has no loader, and is refused
(``check_preview_pipeline``).
"""

from __future__ import annotations

import copy
import os
import shutil
import time
from abc import ABC, abstractmethod
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.data.augmentation import DataAugment
from mpp_cnn_rs_object_detection_torch.data.dataset import (
    BatchLoader,
    ImageDataset,
)
from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
    PatchStack,
    augment_batch,
    build_patch_stack,
    draw_augment_variates,
)
from mpp_cnn_rs_object_detection_torch.data.patch_making import (
    make_patch_dataset,
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
from mpp_cnn_rs_object_detection_torch.utils.config import (
    get_dataset_base_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import make_if_not_exist
from mpp_cnn_rs_object_detection_torch.utils.png import save_unit_image

# the JAX trainer draws epoch e's augmentation from fold_in(PRNGKey(1234), e);
# the port seeds a generator per epoch from the same pair
AUG_SEED = 1234
# hard mining: error maps downscaled 8x, drawn from with half the weight
MINING_RESCALE, MINING_WEIGHT = 1 / 8, 0.5


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


def check_preview_pipeline(config: Dict) -> None:
    """``data_preview`` shows the host pipeline's train loader: raise for a
    config on the device pipeline, which has none (the JAX package's
    device-pipeline trainer has no ``train_loader`` either)."""
    if (config.get("data_loader") or {}).get("device_pipeline"):
        raise ValueError(
            f"-p data_preview shows the host patch pipeline's train batches;"
            f" {config.get('model_name')} sets data_loader.device_pipeline, "
            "whose device-resident patch stacks have no batch loader to "
            "preview")


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
    device)`` (builds and binds its modules), ``loss(x, y, train)``,
    ``targets(centers, params, valid)`` (device pipeline) and
    ``label_processor()`` and ``TARGET_KEYS`` (host pipeline: its targets
    and the keys its loss reads), and holds ``config``, ``dataset``,
    ``device``, ``logger`` and ``save_path``. A model with
    ``DEVICE_PIPELINE_ONLY`` (the detectors) takes the device pipeline
    whatever ``data_loader.device_pipeline`` says."""

    state: TrainState
    TARGET_KEYS: Tuple[str, ...] = ()
    # the loader targets ``data_preview`` writes beside each patch
    PREVIEW_TARGETS: Tuple[str, ...] = ()
    DEVICE_PIPELINE_ONLY = False

    def init_training(self, dtype: torch.dtype, resume: bool) -> None:
        """Fresh flax-initialised modules (or, with ``resume``, the newest
        checkpoint of the model store), then the training data: the train
        and val stacks, or the host pipeline's patch set and loaders."""
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
        # host seconds of each patch set: (subset, seconds); device
        # pipeline: "train" / "val" stacks, host pipeline: "train+val"
        # patch sets, then "train" ones
        self.stack_seconds: List[Tuple[str, float]] = []
        self.epoch_seconds: List[float] = []
        dl = self.config["data_loader"]
        self.dataset_update_interval = dl["dataset_update_interval"]
        self.device_pipeline = self.DEVICE_PIPELINE_ONLY or bool(
            dl.get("device_pipeline"))
        if self.device_pipeline:
            self.regen_stacks(make_val=True)
            return
        # hard mining's error maps, once a pass has made them
        self.error_densities: Optional[List[str]] = None
        # (epoch, whether the error maps drew from) of each regeneration
        self.regenerations: List[Tuple[int, bool]] = []
        # host seconds the epoch loop waited on each batch; of each mining
        self.loader_wait_seconds: List[float] = []
        self.mining_seconds: List[float] = []
        self.init_host_data()

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

    # ------------------------------------------------------ host pipeline

    @property
    def temp_dataset(self) -> str:
        return f"temp_{self.config['model_name']}"

    def init_host_data(self) -> None:
        """The patch set (train and val) and its loaders: the train set
        augmented when the config has ``augment_params``, shuffled from
        the trainer's generator; the val set in order."""
        self.label_processor_train = self.label_processor_val = \
            self.label_processor()
        t0 = time.perf_counter()
        make_patch_dataset(new_dataset=self.temp_dataset,
                           source_dataset=self.dataset, config=self.config,
                           make_val=True, rng=self.rng)
        self.stack_seconds.append(("train+val", time.perf_counter() - t0))
        aug_params = self.config["data_loader"].get("augment_params")
        augmenter = (DataAugment(rng=self.rng, dataset=self.dataset,
                                 subset="train", **aug_params)
                     if aug_params else None)
        self.data_train = ImageDataset(
            dataset=self.temp_dataset, subset="train", rng=self.rng,
            augmenter=augmenter, label_processor=self.label_processor_train)
        self.data_val = ImageDataset(
            dataset=self.temp_dataset, subset="val", rng=self.rng,
            label_processor=self.label_processor_val)
        self.train_loader = BatchLoader(
            self.data_train, batch_size=self.batch_size, shuffle=True,
            rng=self.rng)
        self.val_loader = BatchLoader(self.data_val,
                                      batch_size=self.batch_size,
                                      shuffle=False)

    def host_batch(self, batch) -> Tuple[torch.Tensor, Dict]:
        """A loader batch on the device: the patches and the loss's
        targets, each copied from pinned memory on a GPU."""
        pin = self.device.type == "cuda"

        def move(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=pin)

        x, y = batch
        targets = {k: ([move(v) for v in y[k]] if isinstance(y[k], list)
                       else move(y[k])) for k in self.TARGET_KEYS}
        return move(x), targets

    def host_epoch(self, loader: BatchLoader, train: bool
                   ) -> Dict[str, np.ndarray]:
        """One pass over ``loader``: a train or eval step per batch; the
        seconds spent waiting on each batch go to
        ``loader_wait_seconds``."""
        step = train_step if train else eval_step
        steps = []
        t0 = time.perf_counter()
        for batch in loader:
            self.loader_wait_seconds.append(time.perf_counter() - t0)
            x, y = self.host_batch(batch)
            steps.append(step(self.state, self.loss, x, y))
            t0 = time.perf_counter()
        if not steps:
            return {"loss": np.zeros(1)}
        return stacked_metrics(steps)

    def sampling_densities(self, epoch: int) -> Optional[List[str]]:
        """The error maps the regeneration after ``epoch`` draws from:
        none unless the model mines hard examples."""
        return None

    def regenerate(self, epoch: int) -> None:
        """Rewrite the train patch set after ``epoch``."""
        densities = self.sampling_densities(epoch)
        t0 = time.perf_counter()
        make_patch_dataset(new_dataset=self.temp_dataset,
                           source_dataset=self.dataset, config=self.config,
                           make_val=False, sampling_densities=densities,
                           densities_rescale_fac=MINING_RESCALE,
                           d_sampler_weight=MINING_WEIGHT, rng=self.rng)
        self.stack_seconds.append(("train", time.perf_counter() - t0))
        self.regenerations.append((epoch, densities is not None))
        self.data_train.update_files()

    def data_preview(self) -> None:
        """The first (up to) 8 patches of the train loader's first batch
        as ``data_samples_train/sample_b00_{j:04}_raw.png`` and each of
        ``PREVIEW_TARGETS`` as ``..._{key}.png``, in [0, 1] as 8-bit RGB
        (gray maps as three equal channels). Host pipeline only."""
        check_preview_pipeline(self.config)
        samples_dir = os.path.join(self.save_path, "data_samples_train")
        make_if_not_exist(samples_dir)
        for x, y in self.train_loader:
            for j in range(min(len(x), 8)):
                stem = os.path.join(samples_dir, f"sample_b00_{j:04}")
                save_unit_image(f"{stem}_raw.png", x[j])
                for key in self.PREVIEW_TARGETS:
                    save_unit_image(f"{stem}_{key}.png", y[key][j])
            break

    def clean(self) -> None:
        """Remove the temporary patch set."""
        path = os.path.join(get_dataset_base_path(), self.temp_dataset)
        if os.path.exists(path):
            shutil.rmtree(path)

    # ------------------------------------------------------------ the loop

    def train(self) -> None:
        """Epochs ``last_epoch .. n_epochs - 1``: the train epoch, the val
        epoch, a log line and a rolling checkpoint, then the regeneration
        the pipeline schedules."""
        for epoch in range(self.last_epoch, self.n_epochs):
            t0 = time.perf_counter()
            if self.device_pipeline:
                train_metrics = self.train_epoch(epoch)
                val_metrics = self.val_epoch()
            else:
                train_metrics = self.host_epoch(self.train_loader, True)
                val_metrics = self.host_epoch(self.val_loader, False)
            train_metrics = mean_metrics(
                {k: list(v) for k, v in train_metrics.items()})
            val_metrics = mean_metrics(
                {k: list(v) for k, v in val_metrics.items()})
            self.epoch_seconds.append(time.perf_counter() - t0)
            print(f"[{epoch:04}] "
                  + " ".join(f"{k}: {v:.4f}" for k, v in train_metrics.items())
                  + " | val "
                  + " ".join(f"{k}: {v:.4f}" for k, v in val_metrics.items()),
                  flush=True)
            self.logger.update_train_val(epoch, train_metrics, val_metrics)
            save_checkpoint(self.save_path, self.state, epoch + 1)
            if epoch % self.dataset_update_interval == 0 and epoch != 0:
                if not self.device_pipeline:
                    self.regenerate(epoch)
                elif epoch != self.n_epochs - 1:
                    self.regen_stacks()
        self.state.train(False)
        self.save()
        if not self.device_pipeline:
            self.clean()
