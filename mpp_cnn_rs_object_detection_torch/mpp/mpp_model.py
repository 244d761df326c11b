"""The MPP facade: image -> CNN maps -> exact chain -> scores -> DOTA.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/mpp_model.py`` on its
exact-scene path:

  - ``MPPModel(config, load=True)`` reads the trained combiner and the
    calibration from the model store; ``infer(subset)`` runs the CNN
    inference the dataset lacks (``ensure_cnn_inference``), assembles each
    image's maps from the result pickles, runs the exact chains -- all
    pending scenes as one batched program with ``batch_scenes``, else one
    scene at a time (loaded, run, exported and freed per turn), with the
    segment checkpoint, the config's stopping block, restarts and polish --
    and exports every scored point of the final configurations -- scores
    divided by ``max_score``, no NMS, and the default-off refine, score
    blend and backfill -- to ``NNNN_results.pkl`` and the DOTA OBB
    translations (plain, and ``-SV`` with large vehicles difficult);
    ``eval()`` computes AP at each IoU threshold;
  - ``SceneInference`` runs the same models on in-memory images.

Not ported: calibration and weight training (``ROADMAP.md`` item 9), the
tiled scene mode (item 10), the superstep's split/merge and move switch
(item 11), the meshes (item 15) and the detection/GT overlay PNGs (item
16); a config that turns one on raises ``NotImplementedError``.
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
    load_combiner,
)
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
    EnergySetup,
    make_energy_setup,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    ImageWMaps,
    load_image_w_maps,
)
from mpp_cnn_rs_object_detection_torch.mpp.refine import snap_centers_to_map
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
from mpp_cnn_rs_object_detection_torch.mpp.scene import (
    SceneResult,
    run_exact_scene,
    run_exact_scenes_batched,
)
from mpp_cnn_rs_object_detection_torch.mpp.stopping import (
    stopping_from_config,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import rect_to_poly_np
from mpp_cnn_rs_object_detection_torch.utils.config import (
    fetch_data_paths,
    get_inference_path,
    get_model_base_path,
    resolve_model_config_path,
    startup_config,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    load_results,
    make_if_not_exist,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS_ROOT = os.path.join(REPO_ROOT, "artifacts", "models_storage")
CONFIG_DIR = os.path.join(REPO_ROOT, "model_configs", "mpp")
# config switches of the JAX MPPModel.infer that the port does not have,
# with the value that leaves them off and the ROADMAP.md item that ports them
_INFERENCE_OFF = {"scene_mesh": (False, 15), "batch_mesh": (False, 15)}
_RJMCMC_OFF = {"superstep_split_merge": (False, 11),
               "superstep_move_switch": (False, 11)}


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
        """The scenes' chains as one batch, or one scene at a time when the
        config asks for restarts (as ``MPPModel.infer`` runs them)."""
        check_inference_config(self.config)
        opts = dict(max_segments=max_segments, device=self.device,
                    **chain_options(self.config))
        restarts = int(self.config["inference"].get("restarts", 1))
        if restarts > 1:
            return [run_exact_scene(d, self.setup, self.comb, self.params,
                                    seed=s, restarts=restarts, **opts)
                    for d, s in zip(datas, seeds)]
        return run_exact_scenes_batched(
            datas, self.setup, self.comb, self.params, seeds=list(seeds),
            **opts)


def chain_options(config: Dict) -> Dict:
    """The exact chain's options from an MPP config (both entry points)."""
    inf = config["inference"]
    rj = inf["rjmcmc_params"]
    return dict(capacity=config.get("capacity", 256),
                segment_size=int(inf.get("segment_size", 4096)),
                data_moves=bool(rj.get("superstep_data_moves", True)),
                stopping=stopping_from_config(rj.get("stopping")),
                polish_steps=int(inf.get("polish_steps", 0)))


def check_inference_config(config: Dict) -> None:
    """Raise for a config that turns on a part of the JAX inference path
    the port does not have."""
    inf = config["inference"]
    if inf.get("scene_mode", "tiled") != "exact":
        raise NotImplementedError("only the exact scene mode is ported; the "
                                  "tiled mode is ROADMAP.md item 10")
    rj = inf["rjmcmc_params"]
    for block, switches in ((inf, _INFERENCE_OFF), (rj, _RJMCMC_OFF)):
        for key, (off, item) in switches.items():
            if block.get(key, off) != off:
                raise NotImplementedError(
                    f"inference option {key}={block[key]!r} is not ported "
                    f"(ROADMAP.md item {item})")


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
        if not load:
            raise NotImplementedError(
                "MPP calibration and weight training are not ported "
                "(ROADMAP.md item 9): load a trained model")
        self.device = resolve_device(device)
        self.config, self.logger, self.save_path = startup_config(
            config, "mpp", overwrite=overwrite, load_model=load)
        if dataset is not None:
            self.config["dataset"]["dataset"] = dataset
        self.dataset = self.config["dataset"]["dataset"]
        self.position_model = self.config["dataset"]["position_model"]
        self.shape_model = self.config["dataset"]["shape_model"]
        self.energy_setup: EnergySetup = make_energy_setup(self.config)
        comb_file = os.path.join(self.save_path,
                                 "energy_combination_model.json")
        if os.path.exists(comb_file):
            self.energy_model = load_combiner(comb_file, device=self.device)
            self.energy_setup.load_calibration(self.save_path)
        elif "manual" in self.config:
            raise NotImplementedError(
                "the manual train mode is not ported (ROADMAP.md item 9)")
        else:
            raise FileNotFoundError(comb_file)
        # seconds of the last infer/eval by stage: CNN inference (see
        # ensure_cnn_inference), "load" of the maps, "chain", "export" and
        # "eval"
        self.seconds: Dict[str, float] = {}
        # what the last infer exported, by image id: host arrays and counts
        # (no chain state, no maps)
        self.results: Dict[int, SceneResult] = {}

    def _image_ids(self, subset: str) -> List[int]:
        paths = fetch_data_paths(self.dataset, subset, metadata=False)
        return [image_id(p) for p in paths["images"]]

    def _load_image(self, patch_id: int, subset: str) -> ImageWMaps:
        return load_image_w_maps(patch_id, self.dataset, subset,
                                 self.position_model, self.shape_model)

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
        options = chain_options(self.config)
        restarts = int(inf.get("restarts", 1))

        ids = self._image_ids(subset)
        pending = [pid for pid in ids if overwrite or not os.path.exists(
            os.path.join(results_dir, f"{pid:04}_results.pkl"))]
        self.results = {}
        batch: Dict[int, Tuple[ImageWMaps, SceneResult]] = {}
        if inf.get("batch_scenes") and restarts == 1 and len(pending) > 1:
            # every pending scene at one shared bucket and capacity
            t_stage = time.perf_counter()
            datas = [self._load_image(pid, subset) for pid in pending]
            self.seconds["load"] += time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            out = run_exact_scenes_batched(
                datas, self.energy_setup, self.energy_model, params,
                seeds=pending, device=self.device,
                checkpoint_path=os.path.join(results_dir,
                                             "batched_chains.ck.npz"),
                **options)
            self.seconds["chain"] += time.perf_counter() - t_stage
            batch = dict(zip(pending, zip(datas, out)))
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
        and chain live in this call's frame only."""
        if loaded is None:
            t_stage = time.perf_counter()
            data = self._load_image(patch_id, subset)
            self.seconds["load"] += time.perf_counter() - t_stage
            t_stage = time.perf_counter()
            result = run_exact_scene(
                data, self.energy_setup, self.energy_model, params,
                seed=patch_id, device=self.device, restarts=restarts,
                checkpoint_path=os.path.join(results_dir,
                                             f"{patch_id:04}_chains.ck.npz"),
                **options)
            self.seconds["chain"] += time.perf_counter() - t_stage
        else:
            data, result = loaded
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
