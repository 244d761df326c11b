"""ShapeNet: per-pixel mark distributions (size, ratio, angle).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/shapenet_model.py``:
training (``models/base.py``: the device-resident patch pipeline, or the
host pipeline with ``ShapeLabelProcessor`` targets; class targets in
``mask_mode`` "shapes" or "gaussian", the masked pixel CE
with optional focal weighting and ordinal label smoothing) and inference
(``infer_on_image``, ``dist_maps_on_image``, and at dataset level ``infer``
and ``eval``): three (H, W, C) softmax maps, averaged over the dihedral group
with ``inference.tta`` (the cyclic angle map also permutes its bins).

``infer(subset)`` runs the config's ``inference.pos_model`` PosNet for the
centers (one detection-map kernel launch per image), decodes a mark per
center at the argmax bin's center, and writes the JAX package's result
pickle (the maps as (1, C, H, W) ``output`` arrays, the ImageWMaps contract)
and DOTA OBB translation.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.metrics.dota_eval import dota_eval
from mpp_cnn_rs_object_detection_torch.metrics.dota_writer import (
    DOTAResultsTranslator,
)
from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
    shape_targets,
)
from mpp_cnn_rs_object_detection_torch.data.label_processing import (
    ShapeLabelProcessor,
)
from mpp_cnn_rs_object_detection_torch.models.base import (
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
from mpp_cnn_rs_object_detection_torch.models.losses import pixel_ce_loss
from mpp_cnn_rs_object_detection_torch.models.train_utils import (
    TrainState,
    save_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    PosNetModel,
    _inference_module,
    image_id,
    infer_chunked,
    net_dtype,
    open_store,
)
from mpp_cnn_rs_object_detection_torch.models.unet import ShapeNet
from mpp_cnn_rs_object_detection_torch.ops.geometry import (
    rect_to_poly_np,
    sra_to_wla,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    ValueMapping,
    default_mappings,
)
from mpp_cnn_rs_object_detection_torch.ops.nms import nms_distance
from mpp_cnn_rs_object_detection_torch.utils.config import (
    fetch_data_paths,
    get_inference_path,
    resolve_model_config_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    load_results,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import read_unit_image


class ShapeNetModel(BaseModel, PatchBasedTrainer):
    """A ShapeNet: trained with ``train=True``, else an inference
    wrapper."""

    TARGET_KEYS = ("value_class_map", "loss_mask")

    def __init__(self, config: Dict, device=None, load: bool = False,
                 dataset: Optional[str] = None, overwrite: bool = False,
                 train: bool = False):
        config = open_store(self, config, "shapenet", load, dataset,
                            overwrite, train)
        self.config = config
        self.device = resolve_device(device)
        self.n_classes = config["trainer"].get("n_classes", 32)
        map_cfg = config.get("mappings", {})
        self.mappings: List[ValueMapping] = default_mappings(
            n_classes=self.n_classes,
            size_min=map_cfg.get("size_mapping_min", 0.0),
            size_max=map_cfg.get("size_mapping_max", 32.0),
        )
        self.state = None
        if train:
            self.init_training(net_dtype(config), resume=load)
            return
        self.net = _inference_module(self._new_net(net_dtype(config)),
                                     self.device)
        if load:
            self.load_checkpoint(latest_checkpoint(self.save_path))

    def _new_net(self, dtype: torch.dtype) -> ShapeNet:
        return ShapeNet(self.config["model"]["hidden_dims"], out_features=3,
                        n_classes=self.n_classes, dtype=dtype)

    # ------------------------------------------------------------ training

    def make_train_state(self, dtype: torch.dtype, device) -> TrainState:
        """Bind a new trainable U-Net of ``dtype`` on ``device`` (the params
        tree's root)."""
        self.net = self._new_net(dtype).to(device)
        return TrainState({"": self.net}, "",
                          self.config["loss"].get("learning_rate", 1e-3))

    def targets(self, centers, params, valid) -> Dict:
        loss_cfg = self.config["loss"]
        return shape_targets(
            centers, params, valid,
            self.config["data_loader"]["patch_maker_params"]["patch_size"],
            self.mappings, mask_mode=loss_cfg.get("mask_mode", "shapes"),
            mask_sigma=loss_cfg.get("mask_sigma") or "auto")

    def label_processor(self) -> ShapeLabelProcessor:
        """Host targets; ``class_perturbation`` draws from the trainer's
        generator."""
        loss_cfg = self.config["loss"]
        return ShapeLabelProcessor(
            mappings=self.mappings,
            mask_mode=loss_cfg.get("mask_mode", "shapes"),
            mask_sigma=loss_cfg.get("mask_sigma"),
            mask_cutoff_dist=loss_cfg.get("mask_cutoff_dist"),
            class_perturbation=loss_cfg.get("class_perturbation"),
            rng=self.rng)

    def loss(self, x: torch.Tensor, y: Dict, train: bool):
        """(B, P, P, 3) images -> (loss, metrics)."""
        loss_cfg = self.config["loss"]
        focal_args = loss_cfg.get("focal_loss_args", {}) or {}
        d = pixel_ce_loss(
            self.net(x.permute(0, 3, 1, 2).contiguous()),
            y["value_class_map"], y["loss_mask"],
            focal_loss=bool(loss_cfg.get("focal_loss")),
            focal_alpha=focal_args.get("alpha", 0.5),
            focal_gamma=focal_args.get("gamma", 2.0),
            label_smoothing_sigma=float(
                loss_cfg.get("label_smoothing_sigma", 0.0)))
        return d["loss"], d

    @classmethod
    def from_model_dir(cls, model_dir: str, device=None):
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
        model = cls(config, device=device)
        model.load_checkpoint(os.path.join(model_dir, "model.msgpack"))
        return model

    def load_variables(self, params: Dict, batch_stats: Dict) -> None:
        self.net.load_state_dict(params_from_jax(
            {"params": params, "batch_stats": batch_stats}))

    def load_checkpoint(self, path: str) -> None:
        ck = read_checkpoint(path)
        self.load_variables(ck["params"], ck["batch_stats"])

    def save(self) -> None:
        """``model.msgpack`` in the model's store directory: with the
        optimizer state after training."""
        if self.state is not None:
            save_checkpoint(self.save_path, self.state,
                            self.config["trainer"]["n_epochs"],
                            name="model.msgpack")
            return
        var = params_to_jax(self.net.state_dict())
        write_checkpoint(os.path.join(self.save_path, "model.msgpack"),
                         var["params"], var["batch_stats"],
                         epoch=self.config["trainer"]["n_epochs"])

    @torch.no_grad()
    def infer_on_image(self, image: torch.Tensor) -> List[torch.Tensor]:
        """(H, W, 3) image -> three (H, W, C) softmax maps."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)

        def fwd(padded):
            outs = self.net(padded.permute(2, 0, 1)[None])
            return [torch.softmax(o[0], dim=0) for o in outs]

        h, w = image.shape[:2]
        return [o[:, :h, :w].permute(1, 2, 0).contiguous()
                for o in infer_chunked(image, fwd)]

    def dist_maps_on_image(self, image: torch.Tensor) -> List[torch.Tensor]:
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if not bool(self.config.get("inference", {}).get("tta", False)):
            return self.infer_on_image(image)
        from mpp_cnn_rs_object_detection_torch.ops.dihedral import (
            tta_dist_maps,
        )

        cyclic = tuple(bool(m.is_cyclic) for m in self.mappings)
        return tta_dist_maps(
            lambda x: self.infer_on_image(x.contiguous()), image, cyclic=cyclic
        )

    # ------------------------------------------------------------ dataset

    def infer(self, subset: str, overwrite=True, min_confidence=0.5,
              **kwargs):
        pos_model_name = self.config["inference"]["pos_model"]
        with open(resolve_model_config_path(pos_model_name)) as f:
            pos_config = json.load(f)
        pos_model = PosNetModel(pos_config, self.device, load=True,
                                dataset=self.dataset)

        results_dir = get_inference_path(
            model_name=os.path.split(self.save_path)[1],
            dataset=self.dataset, subset=subset)
        make_if_not_exist(results_dir, recursive=True)
        dota_trlt = DOTAResultsTranslator(
            self.dataset, subset, results_dir, "obb", all_classes=["vehicle"])
        paths_dict = fetch_data_paths(self.dataset, subset=subset,
                                      metadata=False)

        for pf, af in zip(paths_dict["images"], paths_dict["annotations"]):
            t_host = time.perf_counter()
            patch_id = image_id(pf)
            out_pkl = os.path.join(results_dir, f"{patch_id:04}_results.pkl")
            with open(af, "rb") as f:
                labels_dict = pickle.load(f)
            centers, params = labels_dict["centers"], labels_dict["parameters"]
            params = np.asarray(params).reshape(-1, 3)
            gt_as_poly = rect_to_poly_np(centers, params[:, 0], params[:, 1],
                                         params[:, 2])
            dota_trlt.add_gt(
                image_id=patch_id, polygons=gt_as_poly,
                difficulty=labels_dict["difficult"],
                categories=["vehicle"] * len(gt_as_poly))
            if os.path.exists(out_pkl) and not overwrite:
                # resume: replay the existing result pickle into the freshly
                # rewritten DOTA translation
                prev = load_results(out_pkl)
                prev_scores = np.asarray(prev["detection_score"]).reshape(-1)
                dota_trlt.add_detections(
                    image_id=patch_id, scores=prev_scores,
                    polygons=np.asarray(prev["detection"]).reshape(-1, 4, 2),
                    flip_coor=True,
                    class_names=["vehicle"] * len(prev_scores))
                self.seconds["host"] += time.perf_counter() - t_host
                continue
            img = read_unit_image(pf)

            # posnet centers
            t_cnn = time.perf_counter()
            detection_map = pos_model.detection_map_on_image(img)
            detection_map = detection_map.cpu().numpy()
            dist_maps = self.dist_maps_on_image(img)  # 3 x (H, W, C)
            # the ImageWMaps contract: channel-first (1, C, H, W) arrays
            output = [d.permute(2, 0, 1).contiguous().cpu().numpy()[None]
                      for d in dist_maps]
            dt = time.perf_counter() - t_cnn
            self.seconds["cnn"] += dt
            t_host += dt

            det_centers = np.array(np.where(detection_map > min_confidence)).T
            det_scores = detection_map[det_centers[:, 0], det_centers[:, 1]]
            t_nms = time.perf_counter()
            pred_centers, pred_scores = nms_distance(det_centers, det_scores,
                                                     threshold=6)
            self.seconds["nms"] += time.perf_counter() - t_nms
            logging.info(f"image {patch_id}: {len(det_scores)} candidates, "
                         f"{len(pred_scores)} after the distance NMS")

            # shapenet marks at centers: bin-center decode of the argmax
            t_decode = time.perf_counter()
            pc = np.asarray(pred_centers, np.int64).reshape(-1, 2)
            sra = [m.class_to_center_value(np.argmax(o[0][:, pc[:, 0],
                                                          pc[:, 1]], axis=0))
                   for m, o in zip(self.mappings, output)]
            pred_params = np.stack(sra_to_wla(*sra), axis=-1).reshape(-1, 3)
            self.seconds["decode"] += time.perf_counter() - t_decode

            detection_as_poly = rect_to_poly_np(
                pred_centers, pred_params[:, 0], pred_params[:, 1],
                pred_params[:, 2])
            dota_trlt.add_detections(
                image_id=patch_id, scores=pred_scores,
                polygons=detection_as_poly, flip_coor=True,
                class_names=["vehicle"] * len(pred_scores))

            with open(out_pkl, "wb") as f:
                pickle.dump(
                    {
                        "detection": detection_as_poly,
                        "detection_type": "poly",
                        "detection_center": pred_centers,
                        "detection_score": pred_scores,
                        "detection_params": pred_params,
                        "pos_model": pos_model_name,
                        "mappings": self.mappings,
                        "output": output,
                    },
                    f,
                )
            self.seconds["host"] += time.perf_counter() - t_host
        dota_trlt.save()
        logging.info("saved DOTA translations")

    def eval(self):
        dota_eval(model_dir=self.save_path, dataset=self.dataset,
                  subset="val", det_type="obb")
