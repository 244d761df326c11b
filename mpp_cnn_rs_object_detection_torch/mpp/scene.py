"""Exact whole-scene MPP inference on one device.

Counterpart of the exact-scene part of
``mpp_cnn_rs_object_detection_tpu/mpp/scene.py``: pad the maps to the scene
shape bucket, initialise from the thresholded detection map, run ONE global
cell-parallel chain in annealing segments over the full maps, then score
every detection with its papangelou intensity. The superstep budget math is
the JAX package's, verbatim, and so are the stopping check between segments
and the segment checkpoint (``.ck.npz``: the batch's states, progress and a
fingerprint of the budget; resumed when the fingerprint matches, removed at
the end). Restarts, polish and the mesh are not ported; the batched entry
point loops the per-scene chain at the batch's shared bucket and capacity.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.mpp.combinators import EnergyCombiner
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    stack_param_dists,
)
from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import EnergySetup
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import CELL
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    EnergyCache,
    RJMCMCParams,
    build_cache,
    energy_from_cache,
    papangelou,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    state_from_arrays,
    state_to_arrays,
)
from mpp_cnn_rs_object_detection_torch.mpp.stopping import (
    SegmentSummary,
    StoppingCondition,
)
from mpp_cnn_rs_object_detection_torch.ops.nms import nms_distance
from mpp_cnn_rs_object_detection_torch.parallel.sharded_scene import (
    run_exact_scene_chain,
)


def naive_detection(data: ImageWMaps, detection_threshold: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Threshold + distance NMS (6 px) + bin-center argmax marks."""
    det = np.asarray(torch.as_tensor(data.detection_map).cpu())
    centers = np.array(np.where(det >= detection_threshold)).T
    if len(centers) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.float32)
    scores = det[centers[:, 0], centers[:, 1]]
    nms_centers, _ = nms_distance(centers, scores, threshold=6)
    nms_centers = np.asarray(nms_centers).reshape(-1, 2).astype(int)
    cy, cx = nms_centers[:, 0], nms_centers[:, 1]
    cols = []
    for i, m in enumerate(data.mappings):
        d = data.param_dist_maps[i]
        if isinstance(d, torch.Tensor):
            arg = torch.argmax(d[torch.as_tensor(cy, device=d.device),
                                 torch.as_tensor(cx, device=d.device)],
                               dim=-1).cpu().numpy()
        else:
            arg = np.argmax(np.asarray(d)[cy, cx], axis=-1)
        cols.append(m.class_to_center_value(arg))
    marks = np.stack(cols, axis=-1).reshape(-1, 3)
    return nms_centers.astype(np.float32), marks.astype(np.float32)


def _pad(x, ph: int, pw: int):
    """Bottom/right zero pad of the two leading axes (numpy or torch)."""
    if isinstance(x, torch.Tensor):
        pad = [0, 0] * (x.ndim - 2) + [0, pw, 0, ph]
        return F.pad(x, pad)
    x = np.asarray(x)
    return np.pad(x, [(0, ph), (0, pw)] + [(0, 0)] * (x.ndim - 2))


def scene_shape_bucket(h0: int, w0: int, n_dev: int = 1):
    """(target_h, target_w) map padding: 2*CELL quanta for small scenes,
    square power-of-two-times-256 sides for real ones (e.g. 469x753,
    926x958 and 915x925 all land on 1024x1024)."""
    quantum = 2 * CELL if (h0 <= 256 and w0 <= 256) else 256
    mult = int(np.lcm(quantum, max(n_dev, 1)))
    target_h = -(-max(h0, 2 * CELL * n_dev) // mult) * mult
    target_w = -(-max(w0, 2 * CELL) // quantum) * quantum
    if quantum == 256:
        side = max(target_h, target_w)
        pow2 = 256
        while pow2 < side:
            pow2 *= 2
        side = -(-pow2 // mult) * mult
        target_h = target_w = side
    return target_h, target_w


@dataclass
class SuperstepBudget:
    """The superstep schedule of an exact scene (JAX ``run_exact_scene``'s
    budget math): ``total_super`` supersteps in segments of ``seg_super``,
    annealing by ``alpha_super`` per superstep."""

    mps: int          # expected proposals per superstep
    ms_tile: int      # proposals a 256 px tile area gets per superstep
    total_super: int
    seg_super: int
    alpha_super: float
    t_target: float


def superstep_budget(h: int, w: int, params: RJMCMCParams,
                     segment_size: int = 4096) -> SuperstepBudget:
    n_cells = max(h, w) // (2 * CELL) + 1
    mps = max(1, n_cells * n_cells // 2)
    # the per-256px-tile move budget, normalised by the proposals a tile
    # area receives per superstep
    ms_tile = max(1, (256 // (2 * CELL) + 1) ** 2 // 2)
    total_super = max(1, params.total_steps // ms_tile)
    alpha_super = float(np.power(params.resolved_alpha(), ms_tile))
    seg_super = max(1, segment_size // ms_tile)
    # round up to whole segments
    total_super = -(-total_super // seg_super) * seg_super
    return SuperstepBudget(mps=mps, ms_tile=ms_tile, total_super=total_super,
                           seg_super=seg_super, alpha_super=alpha_super,
                           t_target=params.resolved_t_target())


@dataclass
class ChainOutcome:
    """The chain's final device state, kept for checks and diagnostics."""

    state: PointsState
    cache: EnergyCache
    energy: torch.Tensor
    maps: EnergyMaps


@dataclass
class SceneResult:
    centers: np.ndarray  # (N, 2)
    marks: np.ndarray    # (N, 3) size/ratio/angle
    scores: np.ndarray   # (N,) papangelou
    total_moves: int = 0
    supersteps: int = 0          # supersteps run
    planned_supersteps: int = 0  # the full budget
    capacity: int = 0
    seconds: Dict[str, float] = field(default_factory=dict)
    chain: Optional[ChainOutcome] = None
    stopped: bool = False        # a stopping condition ended the anneal


# the batched checkpoint's format tag, the fingerprint's first entry: the
# JAX package writes the same file name into the same inference directory
CHECKPOINT_FORMAT = 1.0
CHECKPOINT_KEYS = {"xy", "marks", "alive", "done", "t0", "stopped",
                   "fingerprint"}


@dataclass
class ChainProgress:
    """Where a scene's anneal stands between segments: what a checkpoint
    stores per scene, and what a resumed run starts from."""

    xy: np.ndarray       # (K, 2)
    marks: np.ndarray    # (K, 3)
    alive: np.ndarray    # (K,)
    done: int = 0        # supersteps run
    t0: float = 1.0      # temperature of the next superstep
    stopped: bool = False

    @classmethod
    def of(cls, state: PointsState, done: int, t0: float,
           stopped: bool = False) -> "ChainProgress":
        return cls(xy=state.xy.cpu().numpy(), marks=state.marks.cpu().numpy(),
                   alive=state.alive.cpu().numpy(), done=done, t0=t0,
                   stopped=stopped)

    def finished(self, total_super: int) -> bool:
        return self.stopped or self.done >= total_super


def segment_seed(seed: int, done: int) -> int:
    """The generator seed of the segment that starts at superstep ``done``
    of the chain seeded ``seed`` (the counterpart of JAX's
    ``fold_in(PRNGKey(seed), done)``): a resumed chain draws what the
    uninterrupted one would have."""
    return int(np.random.SeedSequence([int(seed), int(done)])
               .generate_state(1, np.uint64)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prepare(data: ImageWMaps, setup: EnergySetup, target_hw, init: str,
             device: torch.device):
    """Pad to the bucket, move the maps to ``device`` once, and draw the
    initial configuration. Returns (data, c0, m0, original (h, w))."""
    h0, w0 = data.shape
    ph, pw = max(0, target_hw[0] - h0), max(0, target_hw[1] - w0)
    # the mark maps are the heavy part: one transfer, padded on the device
    data.param_dist_maps = stack_param_dists(data.param_dist_maps, (ph, pw),
                                             device=device)
    data.detection_map = _pad(torch.as_tensor(
        data.detection_map, dtype=torch.float32, device=device), ph, pw)
    data.image = _pad(data.image, ph, pw)
    data.shape = (h0 + ph, w0 + pw)
    if init == "naive":
        c0, m0 = naive_detection(data, setup.detection_threshold)
    elif init == "gt":
        c0, m0 = data.gt_centers, data.gt_marks
    else:
        c0 = np.zeros((0, 2), np.float32)
        m0 = np.zeros((0, 3), np.float32)
    return data, c0, m0, (h0, w0)


def _capacity(h: int, w: int, capacity: int, n_init: int) -> int:
    """Slots scale with the padded area (64 per 256 px tile), with headroom
    over the initial configuration, in multiples of 64."""
    n_areas = -(-h // 256) * -(-w // 256)
    cap = max(capacity, 64 * n_areas, n_init * 3 // 2 + 64)
    return int(-(-cap // 64) * 64)


def _run_prepared(data: ImageWMaps, c0, m0, orig_hw, setup: EnergySetup,
                  comb: EnergyCombiner, params: RJMCMCParams, seed: int,
                  cap: int, segment_size: int,
                  max_segments: Optional[int], data_moves: bool,
                  device: torch.device, prep_s: float,
                  stopping: Optional[StoppingCondition] = None,
                  resume: Optional[ChainProgress] = None,
                  on_segment: Optional[Callable[[ChainProgress], None]] = None,
                  ) -> SceneResult:
    """The chain and scores of one prepared scene; ``prep_s`` is the time
    its ``_prepare`` took, which ``seconds["prep"]`` includes.

    ``stopping`` is checked after every segment but the last; ``resume``
    starts the anneal where a checkpoint left it; ``on_segment`` receives
    the progress after every segment (the checkpoint writer)."""
    t_start = time.perf_counter()
    h, w = data.shape
    c0, m0 = c0[:cap], m0[:cap]
    maps = setup.make_maps(data)
    kd = setup.make_kernel_data(data, intensity=max(1, len(c0)))
    budget = superstep_budget(h, w, params, segment_size)
    done, t0, stopped = 0, float(params.t0), False
    if resume is not None:
        state = PointsState(
            xy=torch.as_tensor(resume.xy, device=device),
            marks=torch.as_tensor(resume.marks, device=device),
            alive=torch.as_tensor(resume.alive, device=device))
        done, t0, stopped = resume.done, resume.t0, resume.stopped
    else:
        state = state_from_arrays(c0, m0, capacity=cap, device=device)
    gen = torch.Generator(device=device)
    _sync(device)
    t_prep = prep_s + time.perf_counter() - t_start

    t_chain = time.perf_counter()
    segments = 0
    cache, stats = None, None
    summaries: List[SegmentSummary] = []
    while done < budget.total_super and not stopped:
        if max_segments is not None and segments >= max_segments:
            break
        t_seg = time.perf_counter()
        n = min(budget.seg_super, budget.total_super - done)
        gen.manual_seed(segment_seed(seed, done))
        state, cache, stats = run_exact_scene_chain(
            gen, state, maps, setup.spec, comb, kd, n_supersteps=n, t0=t0,
            alpha_t=budget.alpha_super, t_target=budget.t_target,
            cache=cache, data_moves=data_moves)
        done += n
        segments += 1
        t0 = max(float(t0 * budget.alpha_super ** n), budget.t_target)
        if stopping is not None:
            summaries.append(SegmentSummary(
                iter=done * budget.mps, energy=float(stats.final_energy),
                n_points=int(stats.final_n_points), temperature=t0,
                accept_rate=float(stats.accepted.sum())
                / max(float(stats.proposed.sum()), 1.0),
                seconds=time.perf_counter() - t_seg))
            stopped = done < budget.total_super and stopping.do_stop(
                summaries)
            if stopped:
                logging.info(
                    f"scene {data.name}: stopping fired at superstep "
                    f"{done}/{budget.total_super} (E={summaries[-1].energy:.2f}"
                    f" acc={summaries[-1].accept_rate:.4f} T={t0:.4g})")
        if on_segment is not None:
            on_segment(ChainProgress.of(state, done, t0, stopped))
    _sync(device)
    t_chain = time.perf_counter() - t_chain

    t_score = time.perf_counter()
    if cache is None:  # no segment ran here (resumed at its end)
        cache = build_cache(state, maps, setup.spec)
        energy = energy_from_cache(state, maps, setup.spec, comb, cache)
    else:
        energy = stats.final_energy
    scores_k = papangelou(state, maps, setup.spec, comb).cpu().numpy()
    xy, marks = state_to_arrays(state)
    alive = state.alive.cpu().numpy()
    t_score = time.perf_counter() - t_score
    centers_np = np.asarray(xy).reshape(-1, 2)
    marks_np = np.asarray(marks).reshape(-1, 3)
    scores_np = scores_k[alive].reshape(-1)
    # keep detections whose center lies in the original scene extent
    h0, w0 = orig_hw
    keep = ((centers_np[:, 0] < h0) & (centers_np[:, 1] < w0)
            & (centers_np >= 0).all(axis=1))
    return SceneResult(
        centers=centers_np[keep], marks=marks_np[keep],
        scores=scores_np[keep], total_moves=done * budget.mps,
        supersteps=done, planned_supersteps=budget.total_super, capacity=cap,
        seconds={"prep": t_prep, "chain": t_chain, "score": t_score},
        chain=ChainOutcome(state=state, cache=cache, energy=energy,
                           maps=maps),
        stopped=stopped,
    )


def run_exact_scene(data: ImageWMaps, setup: EnergySetup,
                    comb: EnergyCombiner, params: RJMCMCParams,
                    seed: int = 0, capacity: int = 256, init: str = "naive",
                    segment_size: int = 4096,
                    max_segments: Optional[int] = None,
                    data_moves: bool = True, device=None) -> SceneResult:
    """EXACT whole-scene MPP: one global cell-parallel chain over the full
    (bucket-padded) maps, then papangelou scores.

    ``max_segments`` stops the anneal after that many segments and scores
    the state reached (a bounded run; ``supersteps`` says how far it got)."""
    device = resolve_device(device)
    t_start = time.perf_counter()
    target = scene_shape_bucket(*data.shape, 1)
    data, c0, m0, orig = _prepare(data, setup, target, init, device)
    cap = _capacity(*data.shape, capacity, len(c0))
    return _run_prepared(data, c0, m0, orig, setup, comb, params, seed, cap,
                         segment_size, max_segments,
                         data_moves, device, time.perf_counter() - t_start)


def run_exact_scenes_batched(datas: List[ImageWMaps], setup: EnergySetup,
                             comb: EnergyCombiner, params: RJMCMCParams,
                             seeds: List[int], capacity: int = 256,
                             init: str = "naive",
                             segment_size: int = 4096,
                             max_segments: Optional[int] = None,
                             data_moves: bool = True,
                             device=None,
                             checkpoint_path: Optional[str] = None,
                             stopping: Optional[StoppingCondition] = None,
                             ) -> List[SceneResult]:
    """Exact scenes over a batch sharing ONE bucket and ONE capacity (the
    JAX batched run's signature), run scene by scene: scene i equals
    ``run_exact_scene`` at that bucket and capacity with ``seeds[i]``.

    ``stopping`` is evaluated per scene, on that scene's segment summaries;
    the JAX batched run evaluates it jointly (mean energy, summed accepts
    over the batch). With ``max_iter`` the two stop at the same superstep.

    ``checkpoint_path``: after every segment, the batch's states and
    progress go to this ``.npz`` with a fingerprint of the budget (its
    supersteps, segment, annealing, capacity, bucket, batch size and
    seeds); a run that finds a matching file resumes each scene where it
    stood, and the file is removed once every scene is done. The layout
    differs from the JAX package's batched checkpoint (per-scene progress),
    and the fingerprint's leading ``CHECKPOINT_FORMAT`` makes it one entry
    longer, so each package restarts on the other's file."""
    assert len(datas) > 0
    device = resolve_device(device)
    target_h = max(scene_shape_bucket(*d.shape, 1)[0] for d in datas)
    target_w = max(scene_shape_bucket(*d.shape, 1)[1] for d in datas)
    prepared, prep_s = [], []
    for d in datas:
        t_start = time.perf_counter()
        prepared.append(_prepare(d, setup, (target_h, target_w), init,
                                 device))
        prep_s.append(time.perf_counter() - t_start)
    cap = max(_capacity(target_h, target_w, capacity, len(p[1]))
              for p in prepared)
    budget = superstep_budget(target_h, target_w, params, segment_size)
    fingerprint = np.array(
        [CHECKPOINT_FORMAT, budget.total_super, budget.seg_super,
         budget.alpha_super, budget.t_target, cap, target_h, target_w,
         len(datas)] + [int(s) for s in seeds], np.float64)

    progress: List[Optional[ChainProgress]] = [None] * len(datas)
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if (CHECKPOINT_KEYS <= set(ck.files)
                and ck["fingerprint"].shape == fingerprint.shape
                and bool(np.allclose(ck["fingerprint"], fingerprint))
                and ck["done"].shape == (len(datas),)):
            progress = [ChainProgress(
                xy=ck["xy"][i], marks=ck["marks"][i], alive=ck["alive"][i],
                done=int(ck["done"][i]), t0=float(ck["t0"][i]),
                stopped=bool(ck["stopped"][i])) for i in range(len(datas))]
            logging.info(f"batched scenes: resuming at supersteps "
                         f"{[p.done for p in progress]}")
        else:
            logging.warning("batched scenes: checkpoint mismatch - restart")
    # what the checkpoint holds per scene: its progress, or its initial
    # configuration until its first segment has run
    record = [p if p is not None else ChainProgress.of(
        state_from_arrays(c0[:cap], m0[:cap], capacity=cap), 0,
        float(params.t0)) for p, (_, c0, m0, _) in zip(progress, prepared)]

    def checkpoint(i: int, prog: ChainProgress) -> None:
        record[i] = prog
        if all(r.finished(budget.total_super) for r in record):
            return
        np.savez(checkpoint_path,
                 xy=np.stack([r.xy for r in record]),
                 marks=np.stack([r.marks for r in record]),
                 alive=np.stack([r.alive for r in record]),
                 done=np.array([r.done for r in record]),
                 t0=np.array([r.t0 for r in record]),
                 stopped=np.array([r.stopped for r in record]),
                 fingerprint=fingerprint)

    results = []
    for i, ((d, c0, m0, orig), seed, t_prep) in enumerate(
            zip(prepared, seeds, prep_s)):
        on_segment = None
        if checkpoint_path:
            on_segment = lambda prog, i=i: checkpoint(i, prog)  # noqa: E731
        results.append(_run_prepared(
            d, c0, m0, orig, setup, comb, params, seed, cap, segment_size,
            max_segments, data_moves, device, t_prep, stopping=stopping,
            resume=progress[i], on_segment=on_segment))
    if checkpoint_path and os.path.exists(checkpoint_path) and all(
            r.finished(budget.total_super) for r in record):
        os.remove(checkpoint_path)
    return results
