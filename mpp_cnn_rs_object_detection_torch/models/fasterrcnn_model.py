"""Baseline detectors: two-stage Faster R-CNN (HBB) and CTRBOX BBAVectors
(OBB), with the CLI's train / infer / eval / DOTA export surface.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/fasterrcnn_model.py``.
Both train on the device-resident patch pipeline (``models/base.py``)
whatever ``data_loader.device_pipeline`` says, as the JAX package does:
each batch's GT targets are built on the device from the padded (centers,
params) arrays. The optimizer is JAX's ``optax.chain(clip_by_global_norm(
grad_clip), adam(warmup_cosine_decay_schedule(...)))`` written out
(``mpp/optim.py``), with ``total_steps = n_patches // batch_size *
n_epochs`` and a warmup of a twentieth of it; checkpoints keep flax's
layout of that chain, so either package resumes the other's.

Inference pads an image with zeros at the bottom and right to a multiple
of 64 (Faster R-CNN) or 32 (CTRBOX), runs the forward on the device and
the final NMS on the host: the IoU NMS of ``ops/nms.py`` on [x1, y1, x2,
y2] boxes, or the rotated NMS over ``metrics/polyiou.py``'s IoU matrix. A
config's ``inference.min_confidence`` overrides the caller's. A model
built to infer without a checkpoint raises ``FileNotFoundError``.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.metrics.dota_eval import dota_eval
from mpp_cnn_rs_object_detection_torch.metrics.dota_writer import (
    DOTAResultsTranslator,
)
from mpp_cnn_rs_object_detection_torch.models.base import (
    BaseModel,
    PatchBasedTrainer,
)
from mpp_cnn_rs_object_detection_torch.models.bbavec_arch import (
    CTRBOX,
    ctrbox_decode,
    ctrbox_loss,
    ctrbox_targets,
)
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    latest_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.fasterrcnn_arch import (
    FasterRCNN,
    decode_boxes,
    make_anchors,
    roi_align,
    roi_loss,
    roi_targets,
    rpn_loss,
    select_proposals,
)
from mpp_cnn_rs_object_detection_torch.models.posnet_model import image_id
from mpp_cnn_rs_object_detection_torch.models.train_utils import (
    TrainState,
    load_checkpoint,
    save_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.unet import init_like_flax_
from mpp_cnn_rs_object_detection_torch.mpp.optim import (
    warmup_cosine_decay_schedule,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import rect_to_poly_np
from mpp_cnn_rs_object_detection_torch.ops.nms import nms
from mpp_cnn_rs_object_detection_torch.utils.config import (
    fetch_data_paths,
    get_inference_path,
    startup_config,
)
from mpp_cnn_rs_object_detection_torch.utils.files import make_if_not_exist
from mpp_cnn_rs_object_detection_torch.utils.png import read_unit_image

FPN_STRIDES = (4, 8, 16, 32, 64)


def hbb_from_marks(centers: torch.Tensor, params: torch.Tensor
                   ) -> torch.Tensor:
    """Axis-aligned (y1, x1, y2, x2) hulls of rotated rects (the
    reference's HBB conversion for Faster R-CNN)."""
    a, b, w = params[..., 0], params[..., 1], params[..., 2]
    ch = torch.abs(b * torch.cos(w)) + torch.abs(a * torch.sin(w))
    cw = torch.abs(b * torch.sin(w)) + torch.abs(a * torch.cos(w))
    return torch.stack([centers[..., 0] - ch / 2, centers[..., 1] - cw / 2,
                        centers[..., 0] + ch / 2, centers[..., 1] + cw / 2],
                       -1)


def pad_image(image: np.ndarray, mult: int) -> np.ndarray:
    """Zeros at the bottom and right up to a multiple of ``mult``."""
    h, w = image.shape[:2]
    return np.pad(image, ((0, (mult - h % mult) % mult),
                          (0, (mult - w % mult) % mult), (0, 0)))


class _DetectorBase(BaseModel, PatchBasedTrainer):
    """A detector: trained with ``train=True`` (``load`` resumes), else
    an inference wrapper (``load`` reads the newest checkpoint)."""

    MODEL_TYPE = "fasterrcnn"
    ORIENTED = False
    PAD_MULTIPLE = 64
    # the JAX detectors train on the device pipeline whatever the config
    DEVICE_PIPELINE_ONLY = True

    def __init__(self, config: Dict, device=None, overwrite: bool = False,
                 load: bool = False, train: bool = True,
                 dataset: Optional[str] = None):
        self.config, self.logger, self.save_path = startup_config(
            config, self.MODEL_TYPE, load_model=load, overwrite=overwrite)
        self.dataset = dataset or self.config["data_loader"]["dataset"]
        self.device = resolve_device(device)
        self.n_epochs = self.config["trainer"]["n_epochs"]
        self.batch_size = self.config["trainer"]["batch_size"]
        self.patch_size = self.config["data_loader"]["patch_maker_params"][
            "patch_size"]
        mc = self.config.get("model", {})
        self.dtype = torch.bfloat16 \
            if mc.get("dtype", "bfloat16") == "bfloat16" else torch.float32
        self._configure(mc)
        if train:
            self.init_training(self.dtype, resume=load)
            return
        self.state = self.make_train_state(self.dtype, self.device)
        gen = torch.Generator().manual_seed(0)
        init_like_flax_(self.net, gen)
        self.last_epoch = 0
        if load:
            try:
                ckpt = latest_checkpoint(self.save_path)
            except FileNotFoundError:
                # inference from random weights would export garbage rows
                raise FileNotFoundError(
                    f"no model.msgpack / checkpoint_*.msgpack under "
                    f"{self.save_path}; train before infer/eval") from None
            self.last_epoch = load_checkpoint(ckpt, self.state)
            logging.info(f"restored {ckpt} (epoch {self.last_epoch})")
        self.state.train(False)

    # hooks ----------------------------------------------------------------

    def _configure(self, mc: Dict) -> None:
        raise NotImplementedError

    def _new_net(self, dtype: torch.dtype) -> torch.nn.Module:
        raise NotImplementedError

    def make_train_state(self, dtype: torch.dtype, device) -> TrainState:
        """The network (the flax tree's root) on ``device`` and the chained
        optimizer: clip at ``loss.grad_clip`` (1.0), adam on a warmup
        cosine from 5 % to 100 % to 1 % of ``loss.learning_rate``."""
        self.net = self._new_net(dtype).to(device)
        loss_cfg = self.config.get("loss", {})
        peak = loss_cfg.get("learning_rate", 1e-3)
        n_train = self.config["data_loader"]["patch_maker_params"].get(
            "n_patches", 2048)
        total = max(1, (n_train // self.batch_size) * self.n_epochs)
        schedule = warmup_cosine_decay_schedule(
            peak * 0.05, peak, max(1, total // 20), total, peak * 0.01)
        return TrainState({"": self.net}, "", peak, schedule=schedule,
                          clip_norm=loss_cfg.get("grad_clip", 1.0))

    def save(self) -> None:
        save_checkpoint(self.save_path, self.state, self.n_epochs,
                        name="model.msgpack")

    def eval(self):
        dota_eval(model_dir=self.save_path, dataset=self.dataset,
                  subset="val", det_type="obb" if self.ORIENTED else "hbb")

    def _image_tensor(self, image: np.ndarray) -> torch.Tensor:
        """(1, 3, Hp, Wp) device tensor of the padded image."""
        padded = pad_image(image, self.PAD_MULTIPLE)
        return torch.from_numpy(np.ascontiguousarray(padded)).to(
            self.device).permute(2, 0, 1)[None]

    # shared DOTA/pickle export -------------------------------------------

    def _export_gt(self, trlt, patch_id: int, labels: Dict) -> None:
        gt_centers = np.asarray(labels["centers"]).reshape(-1, 2)
        gt_params = np.asarray(labels["parameters"]).reshape(-1, 3)
        if self.ORIENTED:
            gt_poly = rect_to_poly_np(gt_centers, gt_params[:, 0],
                                      gt_params[:, 1], gt_params[:, 2]
                                      ).reshape(-1, 4, 2)
            trlt.add_gt(image_id=patch_id, polygons=gt_poly,
                        difficulty=labels["difficult"],
                        categories=["vehicle"] * len(gt_poly))
            return
        boxes = hbb_from_marks(
            torch.from_numpy(gt_centers.astype(np.float32)),
            torch.from_numpy(gt_params.astype(np.float32))).numpy() \
            if len(gt_centers) else np.zeros((0, 4))
        gt_poly = np.stack([boxes[:, [1, 0]], boxes[:, [3, 0]],
                            boxes[:, [3, 2]], boxes[:, [1, 2]]], axis=1) \
            if len(boxes) else np.zeros((0, 4, 2))
        trlt.add_gt(image_id=patch_id, polygons=gt_poly,
                    difficulty=labels["difficult"], flip_coor=False,
                    categories=["vehicle"] * len(gt_poly))

    def _replay_export(self, trlt, patch_id: int, annotation_file: str,
                       out_pkl: str) -> None:
        """Resume: a skipped image still reaches the rewritten DOTA
        translation, GT and detections both."""
        with open(annotation_file, "rb") as f:
            labels = pickle.load(f)
        with open(out_pkl, "rb") as f:
            prev = pickle.load(f)
        self._export_gt(trlt, patch_id, labels)
        scores = np.asarray(prev["detection_score"]).reshape(-1)
        det = np.asarray(prev["detection"])
        if str(prev.get("detection_type")) == "poly":
            trlt.add_detections(image_id=patch_id, scores=scores,
                                polygons=det.reshape(-1, 4, 2),
                                flip_coor=True,
                                class_names=["vehicle"] * len(scores))
        else:
            trlt.add_detections(image_id=patch_id, scores=scores,
                                bbox=det.reshape(-1, 4), flip_coor=False,
                                class_names=["vehicle"] * len(scores))

    def _export_detections(self, trlt, patch_id: int, image: np.ndarray,
                           min_confidence: float) -> Dict:
        raise NotImplementedError

    def data_preview(self):
        """Nothing to preview (as the JAX package's detectors)."""

    def infer(self, subset: str = "val", overwrite: bool = True,
              min_confidence: Optional[float] = None, **kwargs):
        """``NNNN_results.pkl`` per image of the subset and the DOTA
        translation; existing pickles are replayed unless ``overwrite``."""
        if min_confidence is None:
            min_confidence = self.MIN_CONFIDENCE
        min_confidence = self.config.get("inference", {}).get(
            "min_confidence", min_confidence)
        results_dir = get_inference_path(
            model_name=os.path.split(self.save_path)[1],
            dataset=self.dataset, subset=subset)
        make_if_not_exist(results_dir, recursive=True)
        trlt = DOTAResultsTranslator(
            self.dataset, subset, results_dir,
            "obb" if self.ORIENTED else "hbb", all_classes=["vehicle"])
        paths = fetch_data_paths(self.dataset, subset=subset, metadata=False)
        self.state.train(False)
        for pf, af in zip(paths["images"], paths["annotations"]):
            patch_id = image_id(pf)
            out_pkl = os.path.join(results_dir, f"{patch_id:04}_results.pkl")
            if os.path.exists(out_pkl) and not overwrite:
                self._replay_export(trlt, patch_id, af, out_pkl)
                continue
            with open(af, "rb") as f:
                labels = pickle.load(f)
            img = read_unit_image(pf)
            result = self._export_detections(trlt, patch_id, img,
                                              min_confidence)
            self._export_gt(trlt, patch_id, labels)
            with open(out_pkl, "wb") as f:
                pickle.dump(result, f)
        trlt.save()
        logging.info("saved DOTA translations")


class FasterRCNNModel(_DetectorBase):
    """Two-stage HBB detector: ResNet-FPN + RPN + ROIAlign + box head."""

    ORIENTED = False
    MODEL_TYPE = "fasterrcnn"
    PAD_MULTIPLE = 64
    MIN_CONFIDENCE = 0.25

    def _configure(self, mc: Dict) -> None:
        self.net_kwargs = dict(depth=mc.get("depth", 50),
                               width=mc.get("width", 64),
                               fpn_channels=mc.get("fpn_channels", 256),
                               box_hidden=mc.get("box_hidden", 1024))
        self.anchor_sizes = tuple(mc.get("anchor_sizes", (8, 16, 32, 64, 128)))
        self.anchor_ratios = tuple(mc.get("anchor_ratios", (0.5, 1.0, 2.0)))
        self.post_nms_train = mc.get("post_nms_train", 64)
        self.post_nms_infer = mc.get("post_nms_infer", 256)
        self.pre_nms = mc.get("pre_nms", 512)
        self.rpn_iou = (mc.get("rpn_pos_iou", 0.7), mc.get("rpn_neg_iou", 0.3))
        self.iou_threshold = mc.get("iou_threshold", 0.5)
        self._anchor_cache: Dict = {}

    def _new_net(self, dtype: torch.dtype) -> FasterRCNN:
        return FasterRCNN(dtype=dtype, **self.net_kwargs)

    def anchors_for(self, hw, device) -> List[torch.Tensor]:
        key = (hw, str(device))
        if key not in self._anchor_cache:
            fm = [(-(-hw[0] // s), -(-hw[1] // s)) for s in FPN_STRIDES]
            self._anchor_cache[key] = [
                torch.from_numpy(a).to(device) for a in make_anchors(
                    fm, FPN_STRIDES, self.anchor_sizes, self.anchor_ratios)]
        return self._anchor_cache[key]

    def targets(self, centers, params, valid) -> Dict[str, torch.Tensor]:
        boxes = hbb_from_marks(centers, params)
        return {"gt": torch.where(valid[..., None], boxes, 0.0),
                "gt_valid": valid}

    def _roi_head(self, feats, props):
        """(B, N) proposals -> box-head (cls, reg) of shape (B, N, .)."""
        b, n = props.shape[:2]
        rois = roi_align(feats[:4], props, FPN_STRIDES[:4])
        cls, reg = self.net.box_head(rois.reshape((b * n,) + rois.shape[2:]))
        return cls.reshape(b, n, -1), reg.reshape(b, n, 4)

    def loss(self, x: torch.Tensor, y: Dict, train: bool):
        """(B, P, P, 3) images -> (loss, metrics): the RPN terms over all
        anchors, the ROI terms over each image's ``post_nms_train``
        proposals (selected without gradient)."""
        hw = (x.shape[1], x.shape[2])
        anchors = self.anchors_for(hw, x.device)
        feats, logits, deltas = self.net(x.permute(0, 3, 1, 2))
        gt, gv = y["gt"], y["gt_valid"]
        rpn_c, rpn_r = rpn_loss(logits, deltas, torch.cat(anchors), gt, gv,
                                pos_iou=self.rpn_iou[0],
                                neg_iou=self.rpn_iou[1])
        with torch.no_grad():
            props, _, valid = select_proposals(
                logits.detach(), deltas.detach(), anchors, hw, self.pre_nms,
                self.post_nms_train)
        labels, matched, pos = roi_targets(props, valid, gt, gv)
        cls, reg = self._roi_head(feats, props)
        roi_c, roi_r = roi_loss(cls, reg, props, labels, matched, pos, valid)
        metrics = {"rpn_cls": rpn_c.mean(), "rpn_reg": rpn_r.mean(),
                   "roi_cls": roi_c.mean(), "roi_reg": roi_r.mean()}
        loss = metrics["rpn_cls"] + metrics["rpn_reg"] + metrics["roi_cls"] \
            + metrics["roi_reg"]
        return loss, {"loss": loss, **metrics}

    @torch.no_grad()
    def _detect(self, image: np.ndarray, min_confidence: float):
        """(h, w, 3) image -> (boxes (n, 4) (y1, x1, y2, x2), scores) after
        the score floor and the IoU NMS."""
        x = self._image_tensor(image)
        hw = tuple(x.shape[2:])
        anchors = self.anchors_for(hw, self.device)
        feats, logits, deltas = self.net(x)
        props, _, valid = select_proposals(logits, deltas, anchors, hw,
                                           self.pre_nms, self.post_nms_infer)
        cls, reg = self._roi_head(feats, props)
        scores = torch.softmax(cls, -1)[..., 1]
        boxes = decode_boxes(props, reg)[0].cpu().numpy()
        scores = torch.where(valid, scores, 0.0)[0].cpu().numpy()
        keep = scores >= min_confidence
        boxes, scores = boxes[keep], scores[keep]
        if len(boxes):
            _, _, kidx = nms(boxes[:, [1, 0, 3, 2]], scores,
                             self.iou_threshold, return_index=True)
            boxes, scores = boxes[kidx], scores[kidx]
        return boxes, scores

    def _export_detections(self, trlt, patch_id, image, min_confidence):
        boxes, scores = self._detect(image, min_confidence)
        det_xyxy = boxes[:, [1, 0, 3, 2]] if len(boxes) else np.zeros((0, 4))
        trlt.add_detections(image_id=patch_id, scores=scores, bbox=det_xyxy,
                            flip_coor=False,
                            class_names=["vehicle"] * len(scores))
        return {"detection": det_xyxy, "detection_type": "bbox",
                "detection_score": scores,
                "detection_center": (boxes[:, :2] + boxes[:, 2:]) / 2
                if len(boxes) else np.zeros((0, 2))}


class BBAVecModel(_DetectorBase):
    """CTRBOX oriented detector."""

    ORIENTED = True
    MODEL_TYPE = "bbavec"
    PAD_MULTIPLE = 32
    MIN_CONFIDENCE = 0.2
    # candidates decoded per image (the JAX package's default)
    TOP_K = 500
    # rotated NMS threshold
    NMS_IOU = 0.1

    def _configure(self, mc: Dict) -> None:
        self.down_ratio = mc.get("down_ratio", 4)
        self.net_kwargs = dict(depth=mc.get("depth", 101),
                               width=mc.get("width", 64),
                               head_conv=mc.get("head_conv", 256),
                               down_ratio=self.down_ratio)

    def _new_net(self, dtype: torch.dtype) -> CTRBOX:
        return CTRBOX(dtype=dtype, **self.net_kwargs)

    def targets(self, centers, params, valid) -> Dict[str, torch.Tensor]:
        p = self.patch_size
        return ctrbox_targets(centers, params, valid, (p, p),
                              down_ratio=self.down_ratio)

    def loss(self, x: torch.Tensor, y: Dict, train: bool):
        losses = ctrbox_loss(self.net(x.permute(0, 3, 1, 2)), y)
        metrics = {k: v.mean() for k, v in losses.items()}
        return metrics["loss"], metrics

    @torch.no_grad()
    def _detect(self, image: np.ndarray, min_confidence: float,
                k: int = TOP_K):
        """(h, w, 3) image -> (scores, quads (n, 4, 2), centers) after the
        score floor and the rotated NMS (IoU 0.1, score order)."""
        from mpp_cnn_rs_object_detection_torch.metrics.polyiou import (
            poly_iou_matrix,
        )

        outs = self.net(self._image_tensor(image))
        scores, quads, centers = (t.cpu().numpy() for t in ctrbox_decode(
            {kk: v[0] for kk, v in outs.items()}, k=k,
            down_ratio=self.down_ratio))
        keep = scores >= min_confidence
        scores, quads, centers = scores[keep], quads[keep], centers[keep]
        if len(scores):
            iou = poly_iou_matrix(quads, quads)
            kept = np.zeros(len(scores), bool)
            for i in np.argsort(-scores, kind="stable"):
                kept[i] = not np.any(iou[i, kept] >= self.NMS_IOU)
            scores, quads, centers = scores[kept], quads[kept], centers[kept]
        return scores, quads, centers

    def _export_detections(self, trlt, patch_id, image, min_confidence):
        scores, quads, centers = self._detect(image, min_confidence)
        trlt.add_detections(image_id=patch_id, scores=scores,
                            polygons=quads, flip_coor=True,
                            class_names=["vehicle"] * len(scores))
        return {"detection": quads, "detection_type": "poly",
                "detection_score": scores, "detection_center": centers}
