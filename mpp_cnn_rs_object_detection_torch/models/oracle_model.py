"""The oracle model: the ground truth as detections of score 1.0, an
upper bound and a check of the metric pipeline.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/oracle_model.py``
(numpy only; nothing runs on a device).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, Optional

import numpy as np

from mpp_cnn_rs_object_detection_torch.metrics.dota_eval import dota_eval
from mpp_cnn_rs_object_detection_torch.metrics.dota_writer import (
    DOTAResultsTranslator,
)
from mpp_cnn_rs_object_detection_torch.models.base import BaseModel
from mpp_cnn_rs_object_detection_torch.ops.geometry import rect_to_poly_np
from mpp_cnn_rs_object_detection_torch.utils.config import (
    fetch_data_paths,
    get_inference_path,
    startup_config,
)
from mpp_cnn_rs_object_detection_torch.utils.files import make_if_not_exist

_ID_RE = re.compile(r"[^0-9]*([0-9]+).*\.png")


class OracleModel(BaseModel):
    def __init__(self, config: Dict, dataset: Optional[str] = None):
        self.config, self.logger, self.save_path = startup_config(
            config, "oracle", load_model=False, overwrite=True)
        self.dataset = dataset or self.config.get("dataset", "DOTA_gsd50")

    def train(self):
        print("The oracle model won't train")

    def data_preview(self):
        """Nothing to preview (as the JAX package's oracle)."""

    def infer(self, subset: str = "val", overwrite: bool = True, **kwargs):
        """Each image's GT as its detections: DOTA files and one result
        pickle per image."""
        results_dir = get_inference_path(
            model_name=os.path.split(self.save_path)[1],
            dataset=self.dataset, subset=subset)
        make_if_not_exist(results_dir, recursive=True)
        dota_trlt = DOTAResultsTranslator(self.dataset, subset, results_dir,
                                          det_type="obb",
                                          all_classes=["vehicle"])
        paths = fetch_data_paths(self.dataset, subset=subset, metadata=False)
        for pf, af in zip(paths["images"], paths["annotations"]):
            patch_id = int(_ID_RE.match(os.path.split(pf)[1]).group(1))
            with open(af, "rb") as f:
                labels = pickle.load(f)
            centers = np.asarray(labels["centers"]).reshape(-1, 2)
            params = np.asarray(labels["parameters"]).reshape(-1, 3)
            gt_as_poly = rect_to_poly_np(centers, params[:, 0], params[:, 1],
                                         params[:, 2])
            scores = [1.0] * len(gt_as_poly)
            dota_trlt.add_gt(image_id=patch_id, polygons=gt_as_poly,
                             difficulty=labels["difficult"],
                             categories=["vehicle"] * len(gt_as_poly))
            dota_trlt.add_detections(image_id=patch_id, scores=scores,
                                     polygons=gt_as_poly, flip_coor=True,
                                     class_names=["vehicle"] * len(scores))
            with open(os.path.join(results_dir, f"{patch_id:04}_results.pkl"),
                      "wb") as f:
                pickle.dump({"detection": gt_as_poly,
                             "detection_type": "poly",
                             "detection_center": centers,
                             "detection_score": scores,
                             "detection_params": params}, f)
        dota_trlt.save()

    def eval(self):
        """AP at every IoU threshold of the val subset's DOTA files."""
        return dota_eval(model_dir=self.save_path, dataset=self.dataset,
                         subset="val", det_type="obb")
