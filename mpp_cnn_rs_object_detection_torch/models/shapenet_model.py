"""ShapeNet inference: per-pixel mark distributions (size, ratio, angle).

Counterpart of the inference part of
``mpp_cnn_rs_object_detection_tpu/models/shapenet_model.py``
(``infer_on_image``, ``dist_maps_on_image``): three (H, W, C) softmax maps,
averaged over the dihedral group with ``inference.tta`` (the cyclic angle map
also permutes its bins).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_from_jax,
    read_checkpoint,
)
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    _inference_module,
    infer_chunked,
    net_dtype,
)
from mpp_cnn_rs_object_detection_torch.models.unet import ShapeNet
from mpp_cnn_rs_object_detection_torch.ops.mappings import (
    ValueMapping,
    default_mappings,
)


class ShapeNetModel:
    def __init__(self, config: Dict, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.n_classes = config["trainer"].get("n_classes", 32)
        map_cfg = config.get("mappings", {})
        self.mappings: List[ValueMapping] = default_mappings(
            n_classes=self.n_classes,
            size_min=map_cfg.get("size_mapping_min", 0.0),
            size_max=map_cfg.get("size_mapping_max", 32.0),
        )
        self.net = _inference_module(ShapeNet(
            config["model"]["hidden_dims"], out_features=3,
            n_classes=self.n_classes, dtype=net_dtype(config)), self.device)

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
