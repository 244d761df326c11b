"""Scene inference facade: image -> CNN maps -> exact chain -> scores.

Counterpart of the exact-scene inference path of
``mpp_cnn_rs_object_detection_tpu/mpp/mpp_model.py`` (``MPPModel.infer``)
on in-memory images: the PosNet detection maps (8-way TTA each,
max-combined across position models) and the ShapeNet mark distributions
form an ``ImageWMaps``; the configured energy setup, calibration and learned
combiner turn it into energy maps; one exact cell-parallel chain runs per
scene; the final configuration is scored by its papangelou intensities and
deduplicated with a distance NMS. Dataset IO, DOTA export and evaluation are
not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.models.posnet_model import PosNetModel
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel,
)
from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
    EnergyCombiner,
    load_combiner,
)
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
    EnergySetup,
    make_energy_setup,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
from mpp_cnn_rs_object_detection_torch.mpp.scene import (
    SceneResult,
    run_exact_scenes_batched,
)
from mpp_cnn_rs_object_detection_torch.ops.nms import nms_distance

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_ROOT = os.path.join(REPO_ROOT, "artifacts", "models_storage")
CONFIG_DIR = os.path.join(REPO_ROOT, "model_configs", "mpp")
# detections of one scene closer than this are duplicates (the reference's
# patch-merge distance); the one with the higher papangelou score is kept
NMS_DISTANCE = 3.0


def load_mpp_config(name: str) -> Dict:
    with open(os.path.join(CONFIG_DIR, name + ".json")) as f:
        return json.load(f)


def rjmcmc_params_from_config(config: Dict) -> RJMCMCParams:
    rj = config["inference"]["rjmcmc_params"]
    return RJMCMCParams(
        n_steps=rj.get("burn_in", 30000),
        t0=rj.get("init_temperature", 1.0),
        t_target=rj.get("target_temperature", 0.0),
        alpha_t=rj.get("alpha_t", 0.999),
        n_samples=rj.get("num_samples", 1),
        samples_interval=rj.get("samples_interval", 1),
        iter_multiplier=rj.get("iter_multiplier"),
    )


def load_energy_model(config: Dict, mpp_dir: str, device
                      ) -> Tuple[EnergySetup, EnergyCombiner]:
    """The configured energy setup with its calibration, and the trained
    combiner, from a trained MPP model directory."""
    setup = make_energy_setup(config)
    setup.load_calibration(mpp_dir)
    comb = load_combiner(os.path.join(mpp_dir,
                                      "energy_combination_model.json"),
                         device=device)
    return setup, comb


class SceneInference:
    """The exact-scene MPP detector for one configuration."""

    def __init__(self, config: Dict, pos_models: Sequence[PosNetModel],
                 shape_model: ShapeNetModel, setup: EnergySetup,
                 comb: EnergyCombiner, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.pos_models = list(pos_models)
        self.shape_model = shape_model
        self.setup = setup
        self.comb = comb
        self.params = rjmcmc_params_from_config(config)

    @classmethod
    def from_storage(cls, config: Dict, models_root: str = MODELS_ROOT,
                     device=None) -> "SceneInference":
        device = resolve_device(device)
        ds = config["dataset"]
        names = ds["position_model"]
        names = names if isinstance(names, (list, tuple)) else [names]
        pos = [PosNetModel.from_model_dir(
            os.path.join(models_root, "posnet", n), device) for n in names]
        shape = ShapeNetModel.from_model_dir(
            os.path.join(models_root, "shapenet", ds["shape_model"]), device)
        setup, comb = load_energy_model(
            config, os.path.join(models_root, "mpp", config["model_name"]),
            device)
        return cls(config, pos, shape, setup, comb, device)

    def cnn_maps(self, image, name: str = "scene") -> ImageWMaps:
        """(H, W, 3) image in [0, 1] -> ImageWMaps on the device: the
        max-combined PosNet detection maps and the ShapeNet distributions."""
        image = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device)
        det = None
        for pm in self.pos_models:
            d = pm.detection_map_on_image(image)
            det = d if det is None else torch.maximum(det, d)
        dists = self.shape_model.dist_maps_on_image(image)
        return ImageWMaps(
            image=image, name=name, shape=tuple(image.shape[:2]),
            detection_map=det, param_dist_maps=dists,
            mappings=self.shape_model.mappings, labels={},
            gt_centers=np.zeros((0, 2), np.float32),
            gt_marks=np.zeros((0, 3), np.float32),
        )

    def run_scenes(self, datas: List[ImageWMaps], seeds: Sequence[int],
                   max_segments: Optional[int] = None) -> List[SceneResult]:
        inf = self.config["inference"]
        rj = inf["rjmcmc_params"]
        for flag in ("superstep_split_merge", "superstep_move_switch"):
            if rj.get(flag):
                raise NotImplementedError(f"{flag} is not ported")
        if inf.get("scene_mode", "tiled") != "exact":
            raise NotImplementedError("only the exact scene mode is ported")
        return run_exact_scenes_batched(
            datas, self.setup, self.comb, self.params, seeds=list(seeds),
            capacity=self.config.get("capacity", 256),
            segment_size=int(inf.get("segment_size", 4096)),
            max_segments=max_segments,
            data_moves=bool(rj.get("superstep_data_moves", True)),
            device=self.device)


def final_detections(result: SceneResult, threshold: float = NMS_DISTANCE
                     ) -> Dict[str, np.ndarray]:
    """Distance NMS on a scene's scored detections (highest score kept)."""
    if len(result.centers) == 0:
        return {"centers": result.centers, "marks": result.marks,
                "scores": result.scores}
    _, _, keep = nms_distance(result.centers, result.scores, threshold,
                              return_index=True)
    keep = np.asarray(keep, int)
    return {"centers": result.centers[keep], "marks": result.marks[keep],
            "scores": result.scores[keep]}


def infer_scenes(images: Sequence, config: Dict,
                 models_root: str = MODELS_ROOT, device=None,
                 seeds: Optional[Sequence[int]] = None
                 ) -> List[Dict[str, np.ndarray]]:
    """Detections (centers (N, 2), marks (N, 3), papangelou scores (N,)) for
    each (H, W, 3) image, with the trained models of ``config``."""
    det = SceneInference.from_storage(config, models_root, device)
    datas = [det.cnn_maps(img, name=f"scene{i}")
             for i, img in enumerate(images)]
    seeds = list(range(len(datas))) if seeds is None else list(seeds)
    return [final_detections(r) for r in det.run_scenes(datas, seeds)]
