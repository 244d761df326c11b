"""The MPP facade: image -> CNN maps -> chains -> scores -> DOTA.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/mpp_model.py``:

  - ``MPPModel(config, load=False, phase="train")`` calibrates the energy
    setup on object-biased crops of the train subset, and ``train()``
    trains the combiner (the ordering or integral criterion) or builds the
    config's manual one, writing ``calibration.json`` and
    ``energy_combination_model.json`` in the JAX package's format;
  - ``MPPModel(config, load=True)`` reads the trained combiner and the
    calibration from the model store (a ``manual`` config without them
    calibrates and builds its combiner); ``infer(subset)`` runs the CNN
    inference the dataset lacks (``ensure_cnn_inference``), assembles each
    image's maps from the result pickles, and runs the config's
    ``scene_mode``: ``"tiled"`` (the default) runs each scene's tiles as
    the lanes of one sequential (or cell-parallel) chain, merges and
    rescores them; ``"exact"`` runs whole-scene cell-parallel chains --
    all pending scenes as one batched program with ``batch_scenes``, else
    one scene at a time -- with the config's stopping block and restarts.
    Either way one scene's maps are in memory at a time unless batched,
    the chains checkpoint per segment, and every scored point of the
    final configurations is exported -- scores divided by ``max_score``,
    and the default-off polish, refine, score blend and backfill -- to
    ``NNNN_results.pkl``, the DOTA OBB translations (plain, and ``-SV``
    with large vehicles difficult) and the overlays ``NNNN_detection.png``
    (score-coloured) and ``NNNN_gt.png`` (green) over the scene;
    ``eval()`` computes AP at each IoU threshold. On a host with several
    cards, ``scene_mesh`` (exact) runs a scene's chain in row bands over
    up to one card per CELL rows, ``tile_mesh`` splits a tiled scene's
    tiles over the cards (row bands in exact mode, as in the JAX package)
    and ``batch_mesh`` a batch's scenes (``mesh_for_scene``); with one
    card each is a no-op;
  - ``SceneInference`` runs the same models on in-memory images, on one
    device.

After training, ``train()`` draws the energy attribution figure
(``figures/energy_attribution.png``, ``mpp/figures.py``) on 8 more train
crops, as the JAX package does; ``data_preview()`` writes the first 8
train scenes under ``data_preview/``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.ndimage import maximum_filter
from scipy.spatial import cKDTree

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.metrics.dota_eval import dota_eval
from mpp_cnn_rs_object_detection_torch.metrics.dota_writer import (
    DOTAResultsTranslator,
)
from mpp_cnn_rs_object_detection_torch.models.base import BaseModel
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    SECONDS_KEYS,
    PosNetModel,
    image_id,
)
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel,
)
from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
    EnergyCombiner,
    hierarchical_fixed,
    load_combiner,
    manual_hierarchical,
    save_combiner,
)
from mpp_cnn_rs_object_detection_torch.mpp.energies import energy_vectors
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
    EnergySetup,
    make_energy_setup,
)
from mpp_cnn_rs_object_detection_torch.mpp.figures import (
    attribution_summary_plot,
    energy_attribution,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    ImageWMaps,
    crop_image_w_maps,
    load_image_w_maps,
)
from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import CELL
from mpp_cnn_rs_object_detection_torch.mpp.refine import snap_centers_to_map
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
from mpp_cnn_rs_object_detection_torch.mpp.scene import (
    SceneResult,
    run_exact_scene,
    run_exact_scenes_batched,
    run_tiled_scene,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import state_from_arrays
from mpp_cnn_rs_object_detection_torch.mpp.stopping import (
    stopping_from_config,
)
from mpp_cnn_rs_object_detection_torch.mpp.train_weights import (
    _on_device,
    train_integral_criterion,
    train_ordering_criterion,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import rect_to_poly_np
from mpp_cnn_rs_object_detection_torch.parallel.mesh import Mesh, make_mesh
from mpp_cnn_rs_object_detection_torch.utils.config import (
    fetch_data_paths,
    get_inference_path,
    get_model_base_path,
    resolve_model_config_path,
    startup_config,
)
from mpp_cnn_rs_object_detection_torch.utils.display import (
    rectangles_over_image,
    save_image,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    load_results,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import write_png

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_ROOT = os.path.join(REPO_ROOT, "artifacts", "models_storage")
CONFIG_DIR = os.path.join(REPO_ROOT, "model_configs", "mpp")
# config switches of the JAX MPPModel.infer that the port does not have,
# with the value that leaves them off and the ROADMAP.md item that ports
# them (none since the meshes were ported)
_INFERENCE_OFF: Dict[str, Tuple[object, int]] = {}
TRAIN_MODES = ["manual", "integral_criterion", "ordering_criterion"]


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
    """The MPP detector of one configuration, on in-memory images."""

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
        """The scenes' exact chains as one batch, or one scene at a time
        when the config asks for restarts or the tiled mode (as
        ``MPPModel.infer`` runs them)."""
        check_inference_config(self.config)
        inf = self.config["inference"]
        restarts = int(inf.get("restarts", 1))
        if inf.get("scene_mode", "tiled") != "exact":
            return [run_tiled_scene(
                d, self.setup, self.comb, self.params, seed=s,
                max_segments=max_segments, device=self.device,
                **tiled_options(self.config)) for d, s in zip(datas, seeds)]
        if restarts > 1:
            return [run_exact_scene(
                d, self.setup, self.comb, self.params, seed=s,
                restarts=restarts, max_segments=max_segments,
                device=self.device, **chain_options(self.config))
                for d, s in zip(datas, seeds)]
        return run_exact_scenes_batched(
            datas, self.setup, self.comb, self.params, seeds=list(seeds),
            max_segments=max_segments, device=self.device,
            **chain_options(self.config))


def chain_options(config: Dict) -> Dict:
    """The exact chain's options from an MPP config (both entry points)."""
    inf = config["inference"]
    rj = inf["rjmcmc_params"]
    return dict(capacity=config.get("capacity", 256),
                segment_size=int(inf.get("segment_size", 4096)),
                data_moves=bool(rj.get("superstep_data_moves", True)),
                move_switch=bool(rj.get("superstep_move_switch", False)),
                split_merge=bool(rj.get("superstep_split_merge", False)),
                stopping=stopping_from_config(rj.get("stopping")),
                polish_steps=int(inf.get("polish_steps", 0)))


def tiled_options(config: Dict) -> Dict:
    """The tiled mode's options from an MPP config: the tile size, the
    sampler, the sequential mixture's split/merge pair, and the chain's
    (``chain_options`` but the stopping block, which only exact segments
    evaluate; a configured one is ignored with a warning)."""
    inf = config["inference"]
    opts = chain_options(config)
    if opts.pop("stopping") is not None:
        logging.warning("stopping conditions are evaluated on exact-scene "
                        "segments only; ignored in tiled mode")
    return dict(opts, patch_size=config["dataset"].get("patch_size", 256),
                sampler=inf.get("sampler", "sequential"),
                use_split_merge=bool(inf["rjmcmc_params"].get(
                    "use_split_merge", False)))


def check_inference_config(config: Dict) -> None:
    """Raise for a config that turns on a part of the JAX inference path
    the port does not have."""
    inf = config["inference"]
    for key, (off, item) in _INFERENCE_OFF.items():
        if inf.get(key, off) != off:
            raise NotImplementedError(
                f"inference option {key}={inf[key]!r} is not ported "
                f"(ROADMAP.md item {item})")


def visible_mesh(device: torch.device) -> Mesh:
    """The devices a meshed config may use: every visible card for a
    model on the card, the model's own device otherwise (one CPU)."""
    return make_mesh() if device.type == "cuda" else (device,)


def mesh_for_scene(config: Dict, device: torch.device,
                   rows: int) -> Optional[Mesh]:
    """A scene's mesh as the JAX ``MPPModel.infer`` picks it: with
    ``tile_mesh``, or ``scene_mesh`` in exact mode, the exact mode takes
    ``min(devices, max(1, rows // CELL))`` row bands and the tiled mode
    every device; None where that is one device."""
    inf = config["inference"]
    exact = inf.get("scene_mode", "tiled") == "exact"
    if not (inf.get("tile_mesh") or (exact and inf.get("scene_mesh"))):
        return None
    devs = visible_mesh(device)
    n = min(len(devs), max(1, rows // CELL)) if exact else len(devs)
    return devs[:n] if n > 1 else None


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mark_probs_at(param_dist_maps, rows, cols) -> np.ndarray:
    """The (3, n, C) mark distributions at pixels (rows, cols), as float64
    on the host: one gather and one transfer for the stacked maps on the
    device."""
    if isinstance(param_dist_maps, torch.Tensor):
        d = param_dist_maps
        at = d[:, torch.as_tensor(rows, device=d.device),
               torch.as_tensor(cols, device=d.device)]
        return at.cpu().numpy().astype(np.float64)
    return np.stack([_host(d[rows, cols]).astype(np.float64)
                     for d in param_dist_maps])


def extend_detections(centers: np.ndarray, marks: np.ndarray,
                      scores: np.ndarray, data: ImageWMaps, inference: Dict,
                      max_score: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The export-time extensions of the JAX ``MPPModel.infer``, each off by
    default: ``refine_centers`` snaps centers to their detection-map blob;
    ``score_map_blend`` w ranks by ``(papangelou / max_score + w *
    map(center)) / (1 + w)``; ``backfill_threshold`` appends the map's
    local maxima (5 x 5, at or above the threshold) farther than 4 px from
    every detection, with posterior-mean marks (the angle's circular mean
    on the doubled circle) and scores below every chain detection's."""
    refine = bool(inference.get("refine_centers", False))
    blend_w = float(inference.get("score_map_blend", 0.0))
    bf_thr = float(inference.get("backfill_threshold", 0.0))
    if not refine and blend_w <= 0.0 and bf_thr <= 0.0:
        return centers, marks, scores
    dm = _host(data.detection_map)
    if refine:
        centers = snap_centers_to_map(centers, dm)
    if blend_w > 0.0 and len(centers):
        ij = np.clip(np.round(centers).astype(int), 0,
                     np.array(dm.shape) - 1)
        scores = ((scores / max_score + blend_w * dm[ij[:, 0], ij[:, 1]])
                  / (1.0 + blend_w) * max_score)
    if bf_thr > 0.0:
        peaks = (dm == maximum_filter(dm, size=5)) & (dm >= bf_thr)
        pc = np.argwhere(peaks).astype(np.float32)
        if len(pc) and len(centers):
            dmin, _ = cKDTree(centers).query(pc, k=1)
            pc = pc[dmin > 4.0]
        if len(pc):
            ijb = pc.astype(int)
            probs_all = _mark_probs_at(data.param_dist_maps, ijb[:, 0],
                                       ijb[:, 1])
            cols = []
            for m, probs in zip(data.mappings, probs_all):
                centers_v = m.class_to_center_value(
                    np.arange(probs.shape[-1])).astype(np.float64)
                if m.is_cyclic:
                    # the angle lives on [0, pi): the doubled circle
                    z = (probs * np.exp(2j * centers_v)).sum(-1)
                    cols.append((np.angle(z) / 2.0) % np.pi)
                else:
                    cols.append((probs * centers_v).sum(-1)
                                / np.maximum(probs.sum(-1), 1e-9))
            marks_bf = np.stack(cols, axis=-1).astype(np.float32)
            scores_bf = (0.2 * dm[ijb[:, 0], ijb[:, 1]] / (1.0 + blend_w)
                         * max_score)
            centers = np.concatenate([centers, pc])
            marks = np.concatenate([marks, marks_bf])
            scores = np.concatenate([scores, scores_bf])
    return centers, marks, scores


def export_detections(result: SceneResult, max_score: float,
                      data: Optional[ImageWMaps] = None,
                      inference: Optional[Dict] = None
                      ) -> Dict[str, np.ndarray]:
    """A scene's final configuration as ``MPPModel.infer`` exports it:
    every point (with ``data`` and the config's ``inference`` block, after
    ``extend_detections``), its (short, long, angle) rectangle and polygon,
    and the score, also divided by ``max_score`` for the DOTA files."""
    centers = np.asarray(result.centers).reshape(-1, 2)
    marks = np.asarray(result.marks).reshape(-1, 3)
    scores = np.asarray(result.scores).reshape(-1)
    if data is not None and inference:
        centers, marks, scores = extend_detections(
            centers, marks, scores, data, inference, max_score)
    b_long = 2.0 * marks[:, 0] / (1.0 + marks[:, 1])
    params = np.stack([b_long * marks[:, 1], b_long, marks[:, 2]], axis=-1)
    polys = rect_to_poly_np(centers, params[:, 0], params[:, 1],
                            params[:, 2])
    return {"centers": centers, "marks": marks, "params": params,
            "polygons": polys, "scores": scores,
            "scores01": scores / max_score}


def save_overlays(results_dir: str, patch_id: int, image: np.ndarray,
                  det: Dict[str, np.ndarray], labels: Dict) -> None:
    """``NNNN_detection.png``: the exported detections over the image,
    coloured by score over the scene's largest; ``NNNN_gt.png``: the GT
    rectangles in green (the JAX ``MPPModel.infer``'s overlays)."""
    scores = det["scores"]
    save_image(os.path.join(results_dir, f"{patch_id:04}_detection.png"),
               rectangles_over_image(
                   image, det["centers"], det["params"], scores=scores,
                   color="plasma",
                   max_score=(max(1e-6, float(np.max(scores)))
                              if len(scores) else 1.0)))
    save_image(os.path.join(results_dir, f"{patch_id:04}_gt.png"),
               rectangles_over_image(
                   image, np.asarray(labels["centers"]).reshape(-1, 2),
                   np.asarray(labels["parameters"]).reshape(-1, 3),
                   color=(0, 255, 0)))


def _cnn_checkpoint_mtime(model_name: str, kind: str) -> float:
    """mtime of the model's newest weight file (0.0 if none found)."""
    mdir = os.path.join(get_model_base_path(), kind, model_name)
    times = [
        os.path.getmtime(os.path.join(mdir, f))
        for f in (os.listdir(mdir) if os.path.isdir(mdir) else [])
        if f.endswith(".msgpack")
    ]
    return max(times, default=0.0)


def ensure_cnn_inference(dataset: str, subset: str, position_model,
                         shape_model: str, device=None) -> Dict[str, float]:
    """Run PosNet/ShapeNet inference for the images whose result pickles
    are missing or older than their model's newest checkpoint (stale ones
    are deleted first). Returns the seconds spent: ``cnn`` (U-Nets and the
    detection-map kernel) and ``host`` (decoding, NMS, exports), of which
    ``nms`` and ``decode`` (the ShapeNet's marks)."""
    paths = fetch_data_paths(dataset, subset, metadata=False)
    ids = [image_id(p) for p in paths["images"]]
    pos_models = (list(position_model)
                  if isinstance(position_model, (list, tuple))
                  else [position_model])
    seconds = dict.fromkeys(SECONDS_KEYS, 0.0)
    for model_name, kind in [(pm, "posnet") for pm in pos_models] + [
            (shape_model, "shapenet")]:
        res_dir = get_inference_path(model_name, dataset, subset)
        ckpt_mtime = _cnn_checkpoint_mtime(model_name, kind)
        missing = []
        for i in ids:
            pkl = os.path.join(res_dir, f"{i:04}_results.pkl")
            if os.path.exists(pkl):
                if os.path.getmtime(pkl) >= ckpt_mtime:
                    continue
                logging.info(f"{kind}/{model_name} results for image {i} "
                             "predate the newest checkpoint; regenerating")
                os.remove(pkl)
            missing.append(i)
        if not missing:
            continue
        logging.info(f"{kind} results missing for {len(missing)} images; "
                     "running inference")
        with open(resolve_model_config_path(model_name)) as f:
            cfg = json.load(f)
        cls = PosNetModel if kind == "posnet" else ShapeNetModel
        model = cls(cfg, device, load=True, dataset=dataset)
        model.infer(subset=subset, overwrite=False)
        for k in seconds:
            seconds[k] += model.seconds[k]
    return seconds


class MPPModel(BaseModel):
    def __init__(self, config: Dict, phase: str = "infer",
                 overwrite: bool = False, load: bool = False,
                 dataset: Optional[str] = None, device=None):
        """``load``: read the trained combiner and calibration from the
        model store, or -- none stored, and a ``manual`` block in the
        config -- calibrate and build the manual combiner. Without ``load``
        (``phase`` "train"), calibrate; ``train()`` then trains."""
        if not load and phase != "train":
            raise ValueError("MPPModel(load=False) is for phase 'train'")
        self.device = resolve_device(device)
        self.config, self.logger, self.save_path = startup_config(
            config, "mpp", overwrite=overwrite, load_model=load)
        if dataset is not None:
            self.config["dataset"]["dataset"] = dataset
        self.dataset = self.config["dataset"]["dataset"]
        self.position_model = self.config["dataset"]["position_model"]
        self.shape_model = self.config["dataset"]["shape_model"]
        self.patch_size = self.config["dataset"].get("patch_size", 256)
        self.capacity = self.config.get("capacity", 256)
        # every draw of calibration and training in the JAX package's order
        self.rng = np.random.default_rng(0)
        self.energy_setup: EnergySetup = make_energy_setup(self.config)
        self.energy_model: Optional[EnergyCombiner] = None
        # seconds of the last infer/eval by stage: CNN inference (see
        # ensure_cnn_inference), "load" of the maps, "chain", "export" and
        # "eval"
        self.seconds: Dict[str, float] = {}
        # seconds of calibration and training by stage: the train subset's
        # CNN inference (ensure_cnn_inference's keys), "crops" (loading
        # and cropping), "calibrate", and the trainer's stages
        # (train_weights.TRAIN_STAGES)
        self.train_seconds: Dict[str, float] = {}
        # what the last infer exported, by image id: host arrays and counts
        # (no chain state, no maps)
        self.results: Dict[int, SceneResult] = {}
        # the last energy attribution: host "vectors" and "attributions"
        self.attribution: Optional[Dict[str, np.ndarray]] = None
        comb_file = os.path.join(self.save_path,
                                 "energy_combination_model.json")
        if load:
            if os.path.exists(comb_file):
                self.energy_model = load_combiner(comb_file,
                                                  device=self.device)
                self.energy_setup.load_calibration(self.save_path)
            elif self._find_train_mode() == "manual":
                self.calibrate()
                self.train()
            else:
                raise FileNotFoundError(comb_file)
        else:
            self.calibrate()

    def _image_ids(self, subset: str) -> List[int]:
        paths = fetch_data_paths(self.dataset, subset, metadata=False)
        return [image_id(p) for p in paths["images"]]

    def _load_image(self, patch_id: int, subset: str) -> ImageWMaps:
        return load_image_w_maps(patch_id, self.dataset, subset,
                                 self.position_model, self.shape_model)

    def _add_seconds(self, seconds: Dict[str, float]) -> None:
        for k, v in seconds.items():
            self.train_seconds[k] = self.train_seconds.get(k, 0.0) + v

    def _sample_crops(self, subset: str, n_crops: int) -> List[ImageWMaps]:
        """Object-biased fixed-size crops: each centred near a random GT
        object of a random image (jittered by up to a quarter of the crop),
        or placed at random in an image without objects."""
        self._add_seconds(ensure_cnn_inference(
            self.dataset, subset, self.position_model, self.shape_model,
            self.device))
        t0 = time.perf_counter()
        images = [self._load_image(i, subset)
                  for i in self._image_ids(subset)]
        crops = []
        for _ in range(n_crops):
            data = images[self.rng.integers(len(images))]
            h, w = data.shape[:2]
            ph = min(self.patch_size, h)
            if len(data.gt_centers) > 0:
                c = data.gt_centers[self.rng.integers(len(data.gt_centers))]
                jitter = self.rng.integers(-ph // 4, ph // 4 + 1, size=2)
                tl = np.clip(c.astype(int) + jitter - ph // 2, 0,
                             [max(h - ph, 0), max(w - ph, 0)])
            else:
                tl = np.array([self.rng.integers(max(h - ph, 0) + 1),
                               self.rng.integers(max(w - ph, 0) + 1)])
            crops.append(crop_image_w_maps(data, tl, ph))
        self._add_seconds({"crops": time.perf_counter() - t0})
        return crops

    def calibrate(self):
        n_images = (self.config.get("calibration") or {}).get("n_images", 8)
        crops = self._sample_crops("train", n_images)
        t0 = time.perf_counter()
        self.energy_setup.calibrate(crops, self.rng, self.save_path)
        self._add_seconds({"calibrate": time.perf_counter() - t0})
        logging.info("calibration done")

    def _find_train_mode(self) -> Optional[str]:
        modes = [t for t in TRAIN_MODES if t in self.config]
        if len(modes) > 1:
            raise ValueError(f"multiple train modes {modes}")
        return modes[0] if modes else None

    def train(self):
        """Build (``manual``) or train (the ordering or integral criterion)
        the combiner and write ``energy_combination_model.json``."""
        if self.energy_setup.calibration is None:
            try:
                self.energy_setup.load_calibration(self.save_path)
            except FileNotFoundError:
                self.calibrate()
        mode = self._find_train_mode()
        names = self.energy_setup.spec.names
        if mode == "manual":
            manual = self.config["manual"]
            if (self.config.get("energy_setup") or "legacy") == "legacy":
                dp = np.array([manual["Data"], manual["Prior"]], float)
                wd = np.array([manual["PositionEnergy"],
                               manual["ShapeEnergy"]], float)
                wp = np.array([manual["RectangleOverlapEnergy"],
                               manual["ShapeAlignmentEnergy"],
                               manual["AreaPriorEnergy"]], float)
                self.energy_model = hierarchical_fixed(
                    names, weights_data=wd / wd.sum(),
                    weights_prior=wp / wp.sum(),
                    data_prior_weights=dp / dp.sum(),
                    threshold=manual.get("threshold", 0.0),
                    device=self.device)
            else:
                self.energy_model = manual_hierarchical(
                    names, weights_dict=manual["weights"],
                    indicator_energy=manual.get("indicator_energy",
                                                "PositionEnergy"),
                    threshold=manual.get("threshold", 0.0),
                    device=self.device)
        elif mode in ("ordering_criterion", "integral_criterion"):
            cfg = dict(self.config[mode])
            n_crops = cfg.pop("n_crops", 64)
            crops = self._sample_crops("train", n_crops)
            batch_size = (self.config.get("data_loader") or {}).get(
                "batch_size", 8)
            fn = (train_ordering_criterion if mode == "ordering_criterion"
                  else train_integral_criterion)
            self.energy_model = fn(
                crops, self.energy_setup, logger=self.logger,
                save_dir=self.save_path, rng=self.rng, batch_size=batch_size,
                capacity=self.capacity, device=self.device,
                seconds=self.train_seconds, **cfg)
        else:
            raise NotImplementedError(
                f"no train mode in config ({TRAIN_MODES})")
        save_combiner(os.path.join(self.save_path,
                                   "energy_combination_model.json"),
                      self.energy_model)
        logging.info("saved energy_combination_model.json")
        self._dump_attribution_figure(names)

    def _dump_attribution_figure(self, names) -> None:
        """Per-term attribution of the trained combined energy on the GT
        configurations' energy vectors of 8 train crops (the JAX package's
        ``_dump_attribution_figure``: the same draws from ``self.rng``),
        the vectors computed on the model's device, written as
        ``figures/energy_attribution.png``; kept in ``self.attribution``
        (host ``vectors`` and ``attributions``). Crops without GT add no
        row; without any GT nothing is drawn (logged)."""
        t0 = time.perf_counter()
        rows = []
        for c in self._sample_crops("train", 8):
            if len(c.gt_centers) == 0:
                continue
            maps = self.energy_setup.make_maps(_on_device(c, self.device))
            gt = state_from_arrays(c.gt_centers[:self.capacity],
                                   c.gt_marks[:self.capacity],
                                   capacity=self.capacity,
                                   device=self.device)
            vec = energy_vectors(gt, maps, self.energy_setup.spec)
            rows.append(vec[gt.alive])
        if not rows:
            logging.info("no train crop holds a GT object: no energy "
                         "attribution figure")
            return
        flat = torch.cat(rows)
        attr = energy_attribution(self.energy_model, flat)
        fig_dir = os.path.join(self.save_path, "figures")
        make_if_not_exist(fig_dir, recursive=True)
        attribution_summary_plot(
            attr, flat, list(names),
            os.path.join(fig_dir, "energy_attribution.png"))
        self.attribution = {"vectors": flat.cpu().numpy(),
                            "attributions": attr}
        self._add_seconds({"attribution": time.perf_counter() - t0})
        logging.info("saved figures/energy_attribution.png")

    def data_preview(self) -> None:
        """The first 8 train scenes as ``data_preview/preview_{name}_gt.png``
        (the image clipped to [0, 1], as 8 bits)."""
        preview_dir = os.path.join(self.save_path, "data_preview")
        make_if_not_exist(preview_dir)
        for patch_id in self._image_ids("train")[:8]:
            data = self._load_image(patch_id, "train")
            image = np.clip(_host(data.image), 0, 1)
            write_png(os.path.join(preview_dir,
                                   f"preview_{data.name}_gt.png"),
                      (image * 255).astype(np.uint8))

    def infer(self, subset: str = "val", overwrite: bool = True, **kwargs):
        """Chains and export of every val scene. With ``batch_scenes`` (no
        restarts, several pending scenes) the pending scenes are loaded and
        run as one batch; otherwise each scene is loaded, run, exported and
        freed in its turn, so one scene's maps are in memory at a time.
        ``results`` keeps what was exported per scene, on the host."""
        check_inference_config(self.config)
        self.seconds = ensure_cnn_inference(
            self.dataset, subset, self.position_model, self.shape_model,
            self.device)
        self.seconds.update(load=0.0, chain=0.0, export=0.0)
        results_dir = get_inference_path(
            model_name=os.path.split(self.save_path)[1],
            dataset=self.dataset, subset=subset)
        make_if_not_exist(results_dir, recursive=True)
        translators = [
            DOTAResultsTranslator(self.dataset, subset, results_dir,
                                  det_type="obb", all_classes=["vehicle"]),
            DOTAResultsTranslator(self.dataset, subset, results_dir,
                                  det_type="obb", all_classes=["vehicle"],
                                  postfix="-SV")]
        inf = self.config["inference"]
        params = rjmcmc_params_from_config(self.config)
        exact = inf.get("scene_mode", "tiled") == "exact"
        options = (chain_options(self.config) if exact
                   else tiled_options(self.config))
        restarts = int(inf.get("restarts", 1))

        ids = self._image_ids(subset)
        pending = [pid for pid in ids if overwrite or not os.path.exists(
            os.path.join(results_dir, f"{pid:04}_results.pkl"))]
        self.results = {}
        batch: Dict[int, Tuple[ImageWMaps, SceneResult, Tuple]] = {}
        if (inf.get("batch_scenes") and exact and not inf.get("scene_mesh")
                and restarts == 1 and len(pending) > 1):
            # every pending scene at one shared bucket and capacity
            t_stage = time.perf_counter()
            datas = [self._load_image(pid, subset) for pid in pending]
            shapes = [tuple(d.shape) for d in datas]
            self.seconds["load"] += time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            mesh = visible_mesh(self.device) if inf.get("batch_mesh") \
                else ()
            out = run_exact_scenes_batched(
                datas, self.energy_setup, self.energy_model, params,
                seeds=pending, device=self.device,
                checkpoint_path=os.path.join(results_dir,
                                             "batched_chains.ck.npz"),
                mesh=mesh if len(mesh) > 1 else None, **options)
            self.seconds["chain"] += time.perf_counter() - t_stage
            batch = dict(zip(pending, zip(datas, out, shapes)))
            del datas, out

        ann_paths = dict(zip(ids, fetch_data_paths(
            self.dataset, subset, metadata=False)["annotations"]))
        for patch_id in ids:
            out_pkl = os.path.join(results_dir, f"{patch_id:04}_results.pkl")
            if patch_id not in pending:
                # resume: replay the existing result pickle into the freshly
                # rewritten DOTA translations
                logging.info(f"{out_pkl} exists, replaying into translations")
                with open(ann_paths[patch_id], "rb") as f:
                    labels = pickle.load(f)
                prev = load_results(out_pkl)
                self._add_gt(*translators, patch_id, labels)
                prev_scores = (np.asarray(prev["detection_score"]).reshape(-1)
                               / inf.get("max_score", 4.0))
                for trlt in translators:
                    trlt.add_detections(
                        image_id=patch_id, scores=prev_scores,
                        polygons=np.asarray(prev["detection"]).reshape(
                            -1, 4, 2),
                        flip_coor=True,
                        class_names=["vehicle"] * len(prev_scores))
                continue
            self._infer_scene(patch_id, subset, batch.pop(patch_id, None),
                              params, options, restarts, results_dir,
                              translators)
        for trlt in translators:
            trlt.save()
        logging.info("saved dota translation")

    def _infer_scene(self, patch_id: int, subset: str, loaded, params,
                     options: Dict, restarts: int, results_dir: str,
                     translators) -> None:
        """One pending scene: its chain (unless the batch ran it), its
        export, and the host-side record in ``results``. The scene's maps
        and chain live in this call's frame only. The chain checkpoint is
        ``NNNN_chains.ck.npz`` in exact mode and ``NNNN_tiles.ck.npz`` in
        tiled mode. The overlays are drawn over the scene at its own shape
        (the exact chain pads ``data`` to its bucket in place)."""
        if loaded is None:
            t_stage = time.perf_counter()
            data = self._load_image(patch_id, subset)
            shape = tuple(data.shape)
            self.seconds["load"] += time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            mesh = mesh_for_scene(self.config, self.device, shape[0])
            if self.config["inference"].get("scene_mode",
                                            "tiled") != "exact":
                result = run_tiled_scene(
                    data, self.energy_setup, self.energy_model, params,
                    seed=patch_id, device=self.device,
                    checkpoint_path=os.path.join(
                        results_dir, f"{patch_id:04}_tiles.ck.npz"),
                    mesh=mesh, **options)
            else:
                result = run_exact_scene(
                    data, self.energy_setup, self.energy_model, params,
                    seed=patch_id, device=self.device, restarts=restarts,
                    checkpoint_path=os.path.join(
                        results_dir, f"{patch_id:04}_chains.ck.npz"),
                    mesh=mesh, **options)
            self.seconds["chain"] += time.perf_counter() - t_stage
        else:
            data, result, shape = loaded
        t_stage = time.perf_counter()
        inf = self.config["inference"]
        max_score = inf.get("max_score", 4.0)
        det = export_detections(result, max_score, data, inf)
        self._add_gt(*translators, patch_id, data.labels)
        scores01 = det["scores01"]
        if len(scores01) and scores01.max() > 1.0:
            logging.warning(f"pred score exceeds max_score "
                            f"({det['scores'].max():.2f} > {max_score})")
        for trlt in translators:
            trlt.add_detections(
                image_id=patch_id, scores=scores01, polygons=det["polygons"],
                flip_coor=True, class_names=["vehicle"] * len(scores01))
        with open(os.path.join(results_dir, f"{patch_id:04}_results.pkl"),
                  "wb") as f:
            pickle.dump(
                {
                    "detection": det["polygons"],
                    "detection_type": "poly",
                    "detection_center": det["centers"],
                    "detection_score": det["scores"],
                    "detection_params": det["params"],
                    "detection_marks": det["marks"],
                    "mappings": data.mappings,
                },
                f,
            )
        save_overlays(results_dir, patch_id,
                      _host(data.image)[:shape[0], :shape[1]], det,
                      data.labels)
        self.results[patch_id] = dataclasses.replace(
            result, centers=det["centers"], marks=det["marks"],
            scores=det["scores"], chain=None)
        self.seconds["export"] += time.perf_counter() - t_stage

    @staticmethod
    def _add_gt(dota_trlt, dota_trlt_sv, patch_id: int, labels: Dict):
        """The image's GT in both translations; ``-SV`` marks large
        vehicles difficult."""
        centers = np.asarray(labels["centers"]).reshape(-1, 2)
        gt_params = np.asarray(labels["parameters"]).reshape(-1, 3)
        difficulty = np.asarray(labels["difficult"]).reshape(-1)
        categories = np.asarray(labels["categories"]).reshape(-1)
        gt_as_poly = rect_to_poly_np(centers, gt_params[:, 0],
                                     gt_params[:, 1], gt_params[:, 2])
        dota_trlt.add_gt(image_id=patch_id, polygons=gt_as_poly,
                         difficulty=difficulty,
                         categories=["vehicle"] * len(gt_as_poly))
        dota_trlt_sv.add_gt(
            image_id=patch_id, polygons=gt_as_poly,
            difficulty=[bool(d) or c == "large-vehicle"
                        for d, c in zip(difficulty, categories)],
            categories=["vehicle"] * len(gt_as_poly))

    def eval(self):
        t_stage = time.perf_counter()
        dota_eval(model_dir=self.save_path, dataset=self.dataset,
                  subset="val", det_type="obb")
        dota_eval(model_dir=self.save_path, dataset=self.dataset,
                  subset="val", det_type="obb", postfix="-SV")
        self.seconds["eval"] = time.perf_counter() - t_stage
