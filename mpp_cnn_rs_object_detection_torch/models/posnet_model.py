"""PosNet inference: pointing-vector U-Net -> detection map.

Counterpart of the inference part of
``mpp_cnn_rs_object_detection_tpu/models/posnet_model.py`` (``infer_on_image``,
``vec2detection_map``, ``detection_map_on_image``). Images are (H, W, 3)
float tensors in [0, 1]; maps keep the JAX package's layout ((H, W) mask,
(H, W, 2) vectors). Both detection-map branches -- the DivClassifier head
and ``clip(-div/2, 0, 1) * mask`` -- go through the CUDA stencil kernel on a
GPU tensor (``ops/detection_kernel.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_from_jax,
    read_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.unet import (
    DivClassifier,
    PosNet,
    infer_pad_hw,
)
from mpp_cnn_rs_object_detection_torch.ops.detection_kernel import (
    detection_map,
)

PATCH_SIZE = 512


def net_dtype(config: Dict) -> torch.dtype:
    """The U-Net compute type: bf16 unless the config says float32."""
    name = config["model"].get("dtype", "bfloat16")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _inference_module(module: torch.nn.Module, device) -> torch.nn.Module:
    return module.to(device).eval().requires_grad_(False)


def infer_chunked(image: torch.Tensor, forward):
    """Run ``forward`` on the whole (H, W, 3) image padded to its bucket, or
    on ``PATCH_SIZE`` tiles when the image exceeds 2 * PATCH_SIZE per side;
    ``forward`` maps a padded image to a list of (h, w, ...) outputs."""
    h, w = image.shape[:2]
    patch = PATCH_SIZE

    def chunk(img):
        th, tw = infer_pad_hw(*img.shape[:2])
        padded = F.pad(img, (0, 0, 0, tw - img.shape[1], 0, th - img.shape[0]))
        return [o[: img.shape[0], : img.shape[1]] for o in forward(padded)]

    if max(h, w) <= 2 * patch:
        return chunk(image)
    outs = None
    for i in range(0, h, patch):
        for j in range(0, w, patch):
            part = chunk(image[i:i + patch, j:j + patch])
            if outs is None:
                outs = [torch.empty((h, w) + p.shape[2:], dtype=p.dtype,
                                    device=p.device) for p in part]
            for o, p in zip(outs, part):
                o[i:i + patch, j:j + patch] = p
    return outs


class PosNetModel:
    """Inference wrapper around a PosNet (+ DivClassifier head)."""

    def __init__(self, config: Dict, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.use_div_clf = bool(config.get("div_clf_model"))
        learn_mask = config.get("loss", {}).get("learn_mask", True)
        self.net = _inference_module(PosNet(
            config["model"]["hidden_dims"], out_channels=3 if learn_mask else 2,
            dtype=net_dtype(config)), self.device)
        self.div_clf = (_inference_module(DivClassifier(), self.device)
                        if self.use_div_clf else None)
        self._clf_wb: Optional[Tuple[float, float]] = None

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

    @torch.no_grad()
    def infer_on_image(self, image: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H, W, 3) image -> (mask (H, W) probabilities, vec (H, W, 2))."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)

        def fwd(padded):
            out = self.net(padded.permute(2, 0, 1)[None])[0]
            return [torch.sigmoid(out[2]), out[:2].permute(1, 2, 0)]

        mask, vec = infer_chunked(image, fwd)
        return mask.contiguous(), vec.contiguous()

    def vec2detection_map(self, vector_map: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        """DivClassifier head if trained (``sigmoid(w*div*mask + b)``), else
        ``clip(-div/2, 0, 1) * mask``; both in the stencil kernel."""
        if self.div_clf is not None:
            if self._clf_wb is None:
                self._clf_wb = self.div_clf.scalars
            w, b = self._clf_wb
            return detection_map(vector_map, mask, mask_is_logit=False,
                                 epilogue="div_clf", clf_w=w, clf_b=b)
        return detection_map(vector_map, mask, mask_is_logit=False,
                             epilogue="detection")

    def detection_map_on_image(self, image: torch.Tensor) -> torch.Tensor:
        """Detection map; with ``inference.tta`` the mean over the 8 dihedral
        symmetries (each a full forward + kernel launch)."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if not bool(self.config.get("inference", {}).get("tta", False)):
            mask, vec = self.infer_on_image(image)
            return self.vec2detection_map(vec, mask)
        from mpp_cnn_rs_object_detection_torch.ops.dihedral import (
            tta_scalar_map,
        )

        def one(img_t):
            mask, vec = self.infer_on_image(img_t.contiguous())
            return self.vec2detection_map(vec, mask)

        return tta_scalar_map(one, image)
