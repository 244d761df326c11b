"""PosNet: pointing-vector U-Net -> detection map.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/posnet_model.py``:
training (``models/base.py``: the device-resident patch pipeline, or the
host pipeline with ``PosLabelProcessor`` targets and, every
``error_update_interval`` epochs, hard mining: ``compute_errors`` writes
each train scene's |target mask - predicted mask|, downscaled 8x, as the
density PNG the next patch sets draw half their centers from; the
DivClassifier head trained jointly under autograd, its params under
``"div"``), and inference (``infer_on_image``, ``vec2detection_map``,
``detection_map_on_image``, and at dataset level ``infer`` and
``eval``). Images are (H, W, 3) float tensors in [0, 1]; maps keep the JAX
package's layout ((H, W) mask, (H, W, 2) vectors). Both
detection-map branches -- the DivClassifier head and
``clip(-div/2, 0, 1) * mask`` -- go through the CUDA stencil kernel on a GPU
tensor (``ops/detection_kernel.py``), which takes the 8 TTA views' head
outputs in one launch.

A model built with ``train=True`` trains into its model-store directory
(``-r``/``load=True`` resumes its newest checkpoint). A model built with
``load=True`` alone lives in the model store
(``utils/config.py:startup_config``) and reads its newest checkpoint there;
``infer(subset)`` writes the JAX package's result pickles, detection-map
PNGs and DOTA HBB translation, and replays existing pickles on resume.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.metrics.dota_eval import dota_eval
from mpp_cnn_rs_object_detection_torch.metrics.dota_writer import (
    DOTAResultsTranslator,
)
from mpp_cnn_rs_object_detection_torch.data.dataset import load_annotation
from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
    pos_targets,
)
from mpp_cnn_rs_object_detection_torch.data.image_ops import (
    resize_bilinear_u8,
)
from mpp_cnn_rs_object_detection_torch.data.label_processing import (
    PosLabelProcessor,
)
from mpp_cnn_rs_object_detection_torch.models.base import (
    MINING_RESCALE,
    BaseModel,
    PatchBasedTrainer,
)
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    latest_checkpoint,
    params_from_jax,
    params_to_jax,
    read_checkpoint,
    write_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.losses import (
    pointing_vector_loss,
)
from mpp_cnn_rs_object_detection_torch.models.train_utils import (
    TrainState,
    save_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.unet import (
    DivClassifier,
    PosNet,
    infer_pad_hw,
)
from mpp_cnn_rs_object_detection_torch.ops.detection_kernel import (
    View,
    detection_map,
    detection_map_tta,
)
from mpp_cnn_rs_object_detection_torch.ops.dihedral import (
    D4_ELEMENTS,
    transform_image,
)
from mpp_cnn_rs_object_detection_torch.ops.nms import nms_distance
from mpp_cnn_rs_object_detection_torch.utils.config import (
    fetch_data_paths,
    get_dataset_base_path,
    get_inference_path,
    startup_config,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    load_results,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import (
    read_unit_image,
    save_unit_image,
)

PATCH_SIZE = 512
SECONDS_KEYS = ("cnn", "host", "nms", "decode")
ID_RE = re.compile(r"[^0-9]*([0-9]+).*\.png")


def image_id(path: str) -> int:
    """The numeric id of a dataset image file name."""
    return int(ID_RE.match(os.path.split(path)[1]).group(1))


def open_store(model, config: Dict, kind: str, load: bool,
               dataset: Optional[str], overwrite: bool,
               train: bool = False) -> Dict:
    """Bind ``model`` to its model-store directory when it loads (the
    config is frozen there and the newest checkpoint is read after the
    networks exist) or trains (a new directory unless ``load`` resumes;
    ``overwrite`` replaces an existing one); returns the config to build
    from."""
    model.save_path, model.logger = None, None
    if load or train:
        config, model.logger, model.save_path = startup_config(
            config, kind, load_model=load, overwrite=overwrite)
    model.dataset = dataset or (config.get("data_loader") or {}).get(
        "dataset")
    # seconds of dataset inference: U-Net forwards and the detection-map
    # kernel ("cnn", synchronised), and the host's share ("host": image
    # decoding, candidate selection, NMS, mark decoding and the exports),
    # of which the distance NMS ("nms") and the ShapeNet's mark decoding
    # ("decode")
    model.seconds = dict.fromkeys(SECONDS_KEYS, 0.0)
    return config


def net_dtype(config: Dict) -> torch.dtype:
    """The U-Net compute type: bf16 unless the config says float32."""
    name = config["model"].get("dtype", "bfloat16")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _inference_module(module: torch.nn.Module, device) -> torch.nn.Module:
    return module.to(device).eval().requires_grad_(False)


def infer_chunked(image: torch.Tensor, forward) -> List[torch.Tensor]:
    """Channels-first outputs of ``forward`` over the (h, w, 3) image whose
    ``[:, :h, :w]`` is the image's: ``forward`` maps a padded image to a
    list of (C, Hp, Wp) maps. The whole image runs padded to its bucket and
    its outputs come back uncropped; an image above 2 * PATCH_SIZE per side
    runs in ``PATCH_SIZE`` tiles, assembled into (C, h, P) buffers with P
    = w rounded up to a multiple of 4 (the detection-map kernel's pitch)."""
    h, w = image.shape[:2]
    patch = PATCH_SIZE

    def run(img):
        th, tw = infer_pad_hw(*img.shape[:2])
        return forward(F.pad(img, (0, 0, 0, tw - img.shape[1], 0,
                                   th - img.shape[0])))

    if max(h, w) <= 2 * patch:
        return run(image)
    outs = None
    for i in range(0, h, patch):
        for j in range(0, w, patch):
            tile = image[i:i + patch, j:j + patch]
            ph, pw = tile.shape[:2]
            part = run(tile)
            if outs is None:
                outs = [torch.empty((p.shape[0], h, -(-w // 4) * 4),
                                    dtype=p.dtype, device=p.device)
                        for p in part]
            for o, p in zip(outs, part):
                o[:, i:i + ph, j:j + pw] = p[:, :ph, :pw]
    return outs


class PosNetModel(BaseModel, PatchBasedTrainer):
    """A PosNet (+ DivClassifier head): trained with ``train=True``, else
    an inference wrapper."""

    TARGET_KEYS = ("pointing_map", "mask", "center_binary_map_dil")
    PREVIEW_TARGETS = ("mask",)

    def __init__(self, config: Dict, device=None, load: bool = False,
                 dataset: Optional[str] = None, overwrite: bool = False,
                 train: bool = False):
        config = open_store(self, config, "posnet", load, dataset, overwrite,
                            train)
        self.config = config
        self.device = resolve_device(device)
        self.use_div_clf = bool(config.get("div_clf_model"))
        self.learn_mask = config.get("loss", {}).get("learn_mask", True)
        self.error_update_interval = (config.get("data_loader") or {}).get(
            "error_update_interval")
        self._clf_wb: Optional[Tuple[float, float]] = None
        self.state = None
        if train:
            self.init_training(net_dtype(config), resume=load)
            return
        self.net = _inference_module(self._new_net(net_dtype(config)),
                                     self.device)
        self.div_clf = (_inference_module(DivClassifier(), self.device)
                        if self.use_div_clf else None)
        if load:
            self.load_checkpoint(latest_checkpoint(self.save_path))

    def _new_net(self, dtype: torch.dtype) -> PosNet:
        return PosNet(self.config["model"]["hidden_dims"],
                      out_channels=3 if self.learn_mask else 2, dtype=dtype)

    # ------------------------------------------------------------ training

    def make_train_state(self, dtype: torch.dtype, device) -> TrainState:
        """Bind new trainable modules of ``dtype`` on ``device``: the U-Net
        (params ``net``, its BatchNorm statistics the tree's) and the
        DivClassifier head (params ``div``)."""
        self.net = self._new_net(dtype).to(device)
        self.div_clf = DivClassifier().to(device) if self.use_div_clf \
            else None
        modules = {"net": self.net}
        if self.div_clf is not None:
            modules["div"] = self.div_clf
        loss_cfg = self.config["loss"]
        self.loss_kwargs = dict(
            learn_mask=self.learn_mask,
            compute_mask=loss_cfg.get("compute_relevant", True),
            balanced_mask_loss=loss_cfg.get("balanced_mask_loss", True),
            focal_loss=bool(loss_cfg.get("focal_loss")),
            vec_loss_on_prod=bool(loss_cfg.get("vec_loss_on_prod")),
        )
        return TrainState(modules, "net", loss_cfg.get("learning_rate", 1e-3))

    def targets(self, centers, params, valid) -> Dict[str, torch.Tensor]:
        loss_cfg = self.config["loss"]
        return pos_targets(
            centers, params, valid,
            self.config["data_loader"]["patch_maker_params"]["patch_size"],
            loss_cfg["max_distance"],
            sigma_dil=loss_cfg.get("bin_map_dil") or 0.6)

    def label_processor(self) -> PosLabelProcessor:
        loss_cfg = self.config["loss"]
        return PosLabelProcessor(
            max_distance=loss_cfg["max_distance"],
            mode=loss_cfg.get("target_mode", "uvec"),
            n_classes=loss_cfg.get("n_classes"),
            sigma_dil=loss_cfg.get("bin_map_dil"))

    def sampling_densities(self, epoch: int) -> Optional[List[str]]:
        """Hard mining: a new pass after every ``error_update_interval``-th
        epoch (among those that regenerate); later regenerations reuse the
        latest pass's maps."""
        if self.error_update_interval is not None \
                and epoch % self.error_update_interval == 0:
            logging.info("computing error densities for hard mining")
            t0 = time.perf_counter()
            self.error_densities = self.compute_errors(
                rescale_fac=MINING_RESCALE)
            self.mining_seconds.append(time.perf_counter() - t0)
        return self.error_densities

    def compute_errors(self, rescale_fac: float = 1.0) -> List[str]:
        """|target mask - predicted mask| of every train scene (the U-Net
        in eval mode, on the device), downscaled by ``rescale_fac`` as
        Pillow's bilinear resize does, written as
        ``<dataset_path>/error_maps/<dataset>/train/<model>/<id>.png``;
        returns the files."""
        model_name = os.path.split(self.save_path)[1]
        densities_dir = os.path.join(get_dataset_base_path(), "error_maps",
                                     self.dataset, "train", model_name)
        make_if_not_exist(densities_dir, recursive=True)
        files = []
        paths = fetch_data_paths(self.dataset, "train", metadata=False)
        self.state.train(False)
        for pf, lf in zip(paths["images"], paths["annotations"]):
            img = read_unit_image(pf)
            labels = load_annotation(lf)
            _, label = self.label_processor_train.process(
                img, labels["centers"], labels["parameters"], idx=0)
            mask = self.infer_on_image(img)[0].cpu().numpy()
            error = np.abs(label["mask"] - mask)
            if rescale_fac != 1:
                h, w = error.shape
                nh = max(1, int(h * rescale_fac))
                nw = max(1, int(w * rescale_fac))
                error = resize_bilinear_u8((error * 255).astype(np.uint8),
                                           (nw, nh)).astype(np.float32) \
                    / 255.0
            file = os.path.join(densities_dir,
                                f"{ID_RE.match(os.path.split(pf)[1]).group(1)}"
                                ".png")
            save_unit_image(file, error)
            files.append(file)
        return files

    def loss(self, x: torch.Tensor, y: Dict, train: bool):
        """(B, P, P, 3) images -> (loss, metrics). The DivClassifier head
        runs in training only (its input ``concat(vec, sigmoid(mask))``),
        so the validation loss has no ``div_loss``, as in JAX."""
        out = self.net(x.permute(0, 3, 1, 2).contiguous())
        div_score = center_bin = None
        if train and self.div_clf is not None:
            div_score = self.div_clf(torch.cat(
                [out[:, :2], torch.sigmoid(out[:, 2:3])], dim=1
            ).permute(0, 2, 3, 1))
            center_bin = y["center_binary_map_dil"]
        d = pointing_vector_loss(
            out, y["pointing_map"],
            target_mask=y["mask"] if self.learn_mask else None,
            div_score=div_score, center_bin_map=center_bin,
            **self.loss_kwargs)
        return d["loss"], d

    @classmethod
    def from_model_dir(cls, model_dir: str, device=None):
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
        model = cls(config, device=device)
        model.load_checkpoint(os.path.join(model_dir, "model.msgpack"))
        return model

    def load_variables(self, params: Dict, batch_stats: Dict) -> None:
        """Load flax variables (numpy trees): ``params`` holds ``net`` (and
        ``div`` with a DivClassifier head)."""
        self.net.load_state_dict(params_from_jax(
            {"params": params["net"], "batch_stats": batch_stats}))
        if self.div_clf is not None:
            self.div_clf.load_state_dict(
                params_from_jax({"params": params["div"]}))
        self._clf_wb = None

    def load_checkpoint(self, path: str) -> None:
        ck = read_checkpoint(path)
        self.load_variables(ck["params"], ck["batch_stats"])

    def save(self) -> None:
        """``model.msgpack`` in the model's store directory (the inverse of
        ``load_checkpoint``): with the optimizer state after training."""
        if self.state is not None:
            save_checkpoint(self.save_path, self.state,
                            self.config["trainer"]["n_epochs"],
                            name="model.msgpack")
            return
        net = params_to_jax(self.net.state_dict())
        params = {"net": net["params"]}
        if self.div_clf is not None:
            params["div"] = params_to_jax(self.div_clf.state_dict())["params"]
        write_checkpoint(os.path.join(self.save_path, "model.msgpack"),
                         params, net["batch_stats"],
                         epoch=self.config["trainer"]["n_epochs"])

    @torch.no_grad()
    def head_planes(self, image: torch.Tensor) -> torch.Tensor:
        """(h, w, 3) image -> the head's raw ``[vx, vy, mask logit]`` as
        (3, Hp, P) fp32 planes whose ``[:, :h, :w]`` is the image's."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        return infer_chunked(
            image, lambda padded: [self.net(padded.permute(2, 0, 1)[None])[0]]
        )[0]

    def infer_on_image(self, image: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H, W, 3) image -> (mask (H, W) probabilities, vec (H, W, 2))."""
        h, w = image.shape[:2]
        planes = self.head_planes(image)[:, :h, :w]
        return (torch.sigmoid(planes[2]).contiguous(),
                planes[:2].permute(1, 2, 0).contiguous())

    def _epilogue(self) -> Dict:
        """The kernel's epilogue arguments: the DivClassifier head if
        trained (``sigmoid(w*div*mask + b)``), else ``clip(-div/2, 0, 1) *
        mask``."""
        if self.div_clf is None:
            return {"epilogue": "detection"}
        if self._clf_wb is None:
            self._clf_wb = self.div_clf.scalars
        w, b = self._clf_wb
        return {"epilogue": "div_clf", "clf_w": w, "clf_b": b}

    def vec2detection_map(self, vector_map: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        """Detection map of one (vec, mask probabilities) pair."""
        return detection_map(vector_map, mask, mask_is_logit=False,
                             **self._epilogue())

    @torch.no_grad()
    def detection_map_on_image(self, image: torch.Tensor) -> torch.Tensor:
        """Detection map; with ``inference.tta`` the mean over the 8 dihedral
        symmetries. Each view is one forward; the views' raw head outputs go
        to the detection-map kernel together, in one launch that pulls
        their maps back and averages them."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        tta = bool(self.config.get("inference", {}).get("tta", False))
        views = []
        for k, flip in (D4_ELEMENTS if tta else ((0, False),)):
            img_t = transform_image(image, k, flip).contiguous()
            views.append(View(self.head_planes(img_t),
                              tuple(img_t.shape[:2]), (k, flip)))
        return detection_map_tta(views, tuple(image.shape[:2]),
                                 mask_is_logit=True, **self._epilogue())

    # ------------------------------------------------------------ dataset

    def infer(self, subset: str, min_confidence: float = 0.1, overwrite=True,
              **kwargs):
        """Detection maps of the subset's images -> ``NNNN_results.pkl``
        (every map pixel above ``min_confidence`` as a candidate center),
        ``NNNN_detection_map.png`` and the DOTA HBB translation of the
        candidates after a 6 px distance NMS (12 px boxes)."""
        results_dir = get_inference_path(
            model_name=os.path.split(self.save_path)[1],
            dataset=self.dataset, subset=subset)
        make_if_not_exist(results_dir, recursive=True)
        dota_trlt = DOTAResultsTranslator(
            self.dataset, subset, results_dir, "hbb", all_classes=["vehicle"])
        paths_dict = fetch_data_paths(self.dataset, subset=subset,
                                      metadata=False)

        for pf, af in zip(paths_dict["images"], paths_dict["annotations"]):
            t_host = time.perf_counter()
            patch_id = image_id(pf)
            out_pkl = os.path.join(results_dir, f"{patch_id:04}_results.pkl")
            replay = os.path.exists(out_pkl) and not overwrite
            with open(af, "rb") as f:
                labels_dict = pickle.load(f)
            centers = labels_dict["centers"]

            if replay:
                # resume: replay the existing result pickle into the freshly
                # rewritten DOTA translation
                logging.info(f"{out_pkl} exists, replaying into translations")
                prev = load_results(out_pkl)
                detection_map = prev["detection_map"]
                det_centers = np.asarray(prev["detection"]).reshape(-1, 2)
                det_scores = np.asarray(prev["detection_score"]).reshape(-1)
            else:
                img = read_unit_image(pf)
                t_cnn = time.perf_counter()
                detection_map = self.detection_map_on_image(img)
                detection_map = detection_map.cpu().numpy()
                dt = time.perf_counter() - t_cnn
                self.seconds["cnn"] += dt
                t_host += dt
                det_centers = np.array(
                    np.where(detection_map > min_confidence)).T
                det_scores = detection_map[det_centers[:, 0],
                                           det_centers[:, 1]]
            t_nms = time.perf_counter()
            nms_centers, nms_scores = nms_distance(det_centers, det_scores,
                                                   threshold=6)
            self.seconds["nms"] += time.perf_counter() - t_nms
            logging.info(f"image {patch_id}: {len(det_scores)} candidates, "
                         f"{len(nms_scores)} after the distance NMS")

            s1, s2 = 6, 6
            nc = np.asarray(nms_centers).reshape(-1, 2)
            nms_boxes = np.stack([nc[:, 1] - s1, nc[:, 0] - s1,
                                  nc[:, 1] + s2, nc[:, 0] + s2], axis=-1)
            gc = np.asarray(centers).reshape(-1, 2)
            gt_boxes = np.stack([gc[:, 1] - s1, gc[:, 0] - s1,
                                 gc[:, 1] + s2, gc[:, 0] + s2], axis=-1)
            gt_poly = np.stack([gt_boxes[:, [0, 1]], gt_boxes[:, [2, 1]],
                                gt_boxes[:, [2, 3]], gt_boxes[:, [0, 3]]],
                               axis=1)

            dota_trlt.add_gt(
                image_id=patch_id, polygons=gt_poly,
                difficulty=labels_dict["difficult"], flip_coor=False,
                categories=["vehicle"] * len(gt_poly))
            dota_trlt.add_detections(
                image_id=patch_id, scores=nms_scores, bbox=nms_boxes,
                flip_coor=False, class_names=["vehicle"] * len(nms_scores))
            if not replay:
                with open(out_pkl, "wb") as f:
                    pickle.dump(
                        {
                            "detection": det_centers,
                            "detection_score": det_scores,
                            "detection_type": "center",
                            "detection_map": detection_map,
                        },
                        f,
                    )
                save_unit_image(os.path.join(
                    results_dir, f"{patch_id:04}_detection_map.png"),
                    detection_map)
            self.seconds["host"] += time.perf_counter() - t_host
        dota_trlt.save()
        logging.info("saved DOTA translations")

    def eval(self):
        dota_eval(model_dir=self.save_path, dataset=self.dataset,
                  subset="val", det_type="hbb")
