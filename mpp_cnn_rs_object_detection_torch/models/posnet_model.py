"""PosNet inference: pointing-vector U-Net -> detection map.

Counterpart of the inference part of
``mpp_cnn_rs_object_detection_tpu/models/posnet_model.py`` (``infer_on_image``,
``vec2detection_map``, ``detection_map_on_image``). Images are (H, W, 3)
float tensors in [0, 1]; maps keep the JAX package's layout ((H, W) mask,
(H, W, 2) vectors). Both detection-map branches -- the DivClassifier head
and ``clip(-div/2, 0, 1) * mask`` -- go through the CUDA stencil kernel on a
GPU tensor (``ops/detection_kernel.py``), which takes the 8 TTA views' head
outputs in one launch.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

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
    View,
    detection_map,
    detection_map_tta,
)
from mpp_cnn_rs_object_detection_torch.ops.dihedral import (
    D4_ELEMENTS,
    transform_image,
)

PATCH_SIZE = 512


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
