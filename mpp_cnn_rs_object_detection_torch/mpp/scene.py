"""Scene-level MPP inference on one device: exact and tiled.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/scene.py``.

Exact mode (``run_exact_scene``, ``run_exact_scenes_batched``): pad the
maps to the scene shape bucket, initialise from the thresholded detection
map, run ONE global cell-parallel chain in annealing segments over the
full maps, then score every detection with its papangelou intensity. The
superstep budget math is the JAX package's, verbatim, and so are the joint
stopping check between segments and the segment checkpoint (``.ck.npz``:
the lanes' states, the progress and a fingerprint of the budget; resumed
when the fingerprint matches, removed at the end). The lanes of the chain
are the scenes of a batch or the restarts of one scene; either way one
launch sequence per superstep serves them all.

Tiled mode (``run_tiled_scene``, the JAX package's default): overlapping
tiles of the scene run as the lanes of one sequential (or cell-parallel)
chain, their detections merged with a 3 px dedup and rescored on the
scene's maps. The meshes are not ported.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
    ImageWMaps,
    merge_patch_results,
    split_image,
)
from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import CELL
from mpp_cnn_rs_object_detection_torch.mpp.polish import polish_state
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    EnergyCache,
    RJMCMCParams,
    build_cache,
    energy_from_cache,
    papangelou,
    run_chain,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    expand_lanes,
    lane,
    stack_lanes,
    state_from_arrays,
    state_to_arrays,
)
from mpp_cnn_rs_object_detection_torch.mpp.stopping import (
    SegmentSummary,
    StoppingCondition,
    batch_summary,
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
    """A scene's chain at its end, before any polish: its lane of the final
    device state, the carried cache, the energy and the maps (views into
    the batch), kept for checks and diagnostics."""

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
    # chain steps run and budgeted: supersteps of the cell-parallel
    # sampler, single moves of the sequential one
    supersteps: int = 0
    planned_supersteps: int = 0
    capacity: int = 0
    seconds: Dict[str, float] = field(default_factory=dict)
    chain: Optional[ChainOutcome] = None
    stopped: bool = False        # a stopping condition ended the anneal
    lane_energies: List[float] = field(default_factory=list)  # restarts
    best_lane: int = 0           # the restart lane kept
    polish_energies: Optional[Tuple[float, float]] = None  # U before, after
    n_tiles: int = 1             # lanes of the tiled mode
    samples: int = 0             # post-burn-in samples collected per tile
    # the exact chain's accepted proposals by kind in this run (no-op =
    # rejected, birth, death, move, split, merge), of the kept lane
    accepted_by_kind: List[int] = field(default_factory=list)


# the chain checkpoint's format tag, the fingerprint's first entry: the JAX
# package writes files of the same names into the same inference directory
# (format 1 kept progress per scene; format 2 holds the batch's single
# progress, as the batch stops jointly)
CHECKPOINT_FORMAT = 2.0
CHECKPOINT_KEYS = {"xy", "marks", "alive", "done", "t0", "fingerprint"}


def segment_seed(seed: int, done: int, lane: int = 0) -> int:
    """The generator seed of the segment that starts at superstep ``done``
    of the chain seeded ``seed`` (the counterpart of JAX's
    ``fold_in(PRNGKey(seed), done)``; restart lane r > 0 folds in r too):
    a resumed chain draws what the uninterrupted one would have, and lane 0
    draws what a one-lane run draws."""
    key = [int(seed), int(done)] + ([int(lane)] if lane else [])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


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


@dataclass
class _Anneal:
    """Where the lanes' anneal ended."""

    state: PointsState
    cache: Optional[EnergyCache]
    energy: Optional[torch.Tensor]  # (B,)
    done: int
    t0: float
    stopped: bool
    by_kind: Optional[torch.Tensor] = None  # (B, 6) accepted by kind


def _anneal(state: PointsState, maps: EnergyMaps, kd, setup: EnergySetup,
            comb: EnergyCombiner, budget: SuperstepBudget,
            lane_seeds: Sequence[Tuple[int, int]], done: int, t0: float,
            moves: Dict[str, bool], device: torch.device,
            stopping: Optional[StoppingCondition],
            max_segments: Optional[int],
            on_segment: Optional[Callable[[PointsState, int, float], None]],
            name: str) -> _Anneal:
    """Segments of the laned chain from superstep ``done``: lane b's
    generator is reseeded per segment from ``lane_seeds[b]`` = (seed,
    restart lane); ``moves`` holds the superstep's ``data_moves``,
    ``move_switch`` and ``split_merge``. ``stopping`` is evaluated once
    per segment, jointly over the lanes (``stopping.batch_summary``), so
    every lane stops at the same superstep; ``on_segment(state, done,
    t0)`` follows every segment after which the anneal goes on (the
    checkpoint writer)."""
    gens = [torch.Generator(device=device) for _ in lane_seeds]
    cache = energy = by_kind = None
    stopped = False
    segments = 0
    summaries: List[SegmentSummary] = []
    while done < budget.total_super and not stopped:
        if max_segments is not None and segments >= max_segments:
            break
        t_seg = time.perf_counter()
        n = min(budget.seg_super, budget.total_super - done)
        for g, (seed, r) in zip(gens, lane_seeds):
            g.manual_seed(segment_seed(seed, done, r))
        state, cache, stats = run_exact_scene_chain(
            gens, state, maps, setup.spec, comb, kd, n_supersteps=n, t0=t0,
            alpha_t=budget.alpha_super, t_target=budget.t_target,
            cache=cache, **moves)
        energy = stats.final_energy
        by_kind = (stats.accepted_by_kind if by_kind is None
                   else by_kind + stats.accepted_by_kind)
        done += n
        segments += 1
        t0 = max(float(t0 * budget.alpha_super ** n), budget.t_target)
        if stopping is not None:
            summaries.append(batch_summary(
                stats.final_energy.cpu().numpy(),
                stats.final_n_points.cpu().numpy(),
                stats.accepted.cpu().numpy(), stats.proposed.cpu().numpy(),
                iter=done * budget.mps, temperature=t0,
                seconds=time.perf_counter() - t_seg))
            stopped = done < budget.total_super and stopping.do_stop(
                summaries)
            if stopped:
                s = summaries[-1]
                logging.info(
                    f"{name}: stopping fired at superstep {done}/"
                    f"{budget.total_super} (E={s.energy:.2f} "
                    f"acc={s.accept_rate:.4f} T={t0:.4g})")
        if on_segment is not None and done < budget.total_super \
                and not stopped:
            on_segment(state, done, t0)
    return _Anneal(state=state, cache=cache, energy=energy, done=done, t0=t0,
                   stopped=stopped, by_kind=by_kind)


def _run_lanes(prepared, setup: EnergySetup, comb: EnergyCombiner,
               params: RJMCMCParams, seeds: Sequence[int], restarts: int,
               cap: int, segment_size: int, max_segments: Optional[int],
               moves: Dict[str, bool], device: torch.device,
               checkpoint_path: Optional[str],
               stopping: Optional[StoppingCondition], polish_steps: int,
               name: str) -> List[SceneResult]:
    """The chains of prepared scenes, one lane per (scene, restart): scene
    i's lanes are seeded ``seeds[i]``, each keeps its lane of lowest final
    energy, is polished, and is scored by papangelou. A batch of scenes
    stacks their maps; the restarts of one scene share its maps as views.

    ``checkpoint_path``: after every segment the lanes' states, the single
    progress (``done``, ``t0``) and a fingerprint of the budget (its
    supersteps, segment, annealing, capacity, bucket, lane count and seeds)
    go to this ``.npz``; a run that finds a matching file resumes there,
    and the file is removed once the anneal has ended (budget spent or
    stopping fired)."""
    t_start = time.perf_counter()
    n_scenes = len(prepared)
    assert n_scenes == 1 or restarts == 1, "restarts run one scene at a time"
    n_lanes = n_scenes * restarts
    lane_seeds = [(int(seeds[i]), r) for i in range(n_scenes)
                  for r in range(restarts)]
    h, w = prepared[0][0].shape
    budget = superstep_budget(h, w, params, segment_size)

    def lane_data(i):
        return prepared[i // restarts]

    if restarts == 1:
        maps = stack_lanes(lambda i: setup.make_maps(prepared[i][0]),
                           n_lanes)
        kd = stack_lanes(lambda i: setup.make_kernel_data(
            prepared[i][0], intensity=max(1, len(prepared[i][1][:cap]))),
            n_lanes)
    else:
        data, c0 = prepared[0][0], prepared[0][1]
        maps = expand_lanes(setup.make_maps(data), n_lanes)
        kd = expand_lanes(setup.make_kernel_data(
            data, intensity=max(1, len(c0[:cap]))), n_lanes)
    fingerprint = np.array(
        [CHECKPOINT_FORMAT, budget.total_super, budget.seg_super,
         budget.alpha_super, budget.t_target, cap, h, w, n_lanes]
        + [int(s) for s in seeds], np.float64)
    done, t0 = 0, float(params.t0)
    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if (CHECKPOINT_KEYS <= set(ck.files)
                and ck["fingerprint"].shape == fingerprint.shape
                and bool(np.allclose(ck["fingerprint"], fingerprint))):
            state = PointsState(
                xy=torch.as_tensor(ck["xy"], device=device),
                marks=torch.as_tensor(ck["marks"], device=device),
                alive=torch.as_tensor(ck["alive"], device=device))
            done, t0 = int(ck["done"]), float(ck["t0"])
            logging.info(f"{name}: resuming at superstep {done}")
        else:
            logging.warning(f"{name}: checkpoint mismatch - restart")
    if state is None:
        state = stack_lanes(lambda i: state_from_arrays(
            lane_data(i)[1][:cap], lane_data(i)[2][:cap], capacity=cap,
            device=device), n_lanes)

    def checkpoint(st: PointsState, done_v: int, t0_v: float) -> None:
        np.savez(checkpoint_path, xy=st.xy.cpu().numpy(),
                 marks=st.marks.cpu().numpy(),
                 alive=st.alive.cpu().numpy(), done=done_v, t0=t0_v,
                 fingerprint=fingerprint)

    _sync(device)
    t_prep = time.perf_counter() - t_start
    t_chain = time.perf_counter()
    run = _anneal(state, maps, kd, setup, comb, budget, lane_seeds, done, t0,
                  moves, device, stopping, max_segments,
                  checkpoint if checkpoint_path else None, name)
    _sync(device)
    t_chain = time.perf_counter() - t_chain
    ended = run.stopped or run.done >= budget.total_super
    if checkpoint_path and ended and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    cache, energy = run.cache, run.energy
    if cache is None:  # no segment ran here (resumed at its end)
        cache = build_cache(run.state, maps, setup.spec)
        energy = energy_from_cache(run.state, maps, setup.spec, comb, cache)

    results = []
    u_lanes = energy.cpu().numpy().reshape(n_scenes, restarts)
    for i, (data, _, _, orig_hw, prep_s) in enumerate(prepared):
        t_score = time.perf_counter()
        best = int(np.argmin(u_lanes[i]))
        b = i * restarts + best
        if restarts > 1:
            logging.info(f"scene {data.name}: best-of-{restarts} restarts - "
                         f"energies {np.round(u_lanes[i], 2).tolist()} -> "
                         f"lane {best}")
        outcome = ChainOutcome(state=lane(run.state, b), cache=lane(cache, b),
                               energy=energy[b], maps=lane(maps, b))
        st, polished, t_polish = outcome.state, None, 0.0
        if polish_steps > 0:
            st, (u_pre, u_post) = polish_state(st, outcome.maps, setup.spec,
                                               comb, n_steps=polish_steps)
            polished = (float(u_pre), float(u_post))
            t_polish = time.perf_counter() - t_score
            logging.info(f"scene {data.name}: polish {polish_steps} steps "
                         f"U {polished[0]:.2f} -> {polished[1]:.2f}")
        scores_k = papangelou(st, outcome.maps, setup.spec,
                              comb).cpu().numpy()
        xy, marks = state_to_arrays(st)
        alive = st.alive.cpu().numpy()
        centers_np = np.asarray(xy).reshape(-1, 2)
        marks_np = np.asarray(marks).reshape(-1, 3)
        scores_np = scores_k[alive].reshape(-1)
        # keep detections whose center lies in the original scene extent
        h0, w0 = orig_hw
        keep = ((centers_np[:, 0] < h0) & (centers_np[:, 1] < w0)
                & (centers_np >= 0).all(axis=1))
        results.append(SceneResult(
            centers=centers_np[keep], marks=marks_np[keep],
            scores=scores_np[keep], total_moves=run.done * budget.mps,
            supersteps=run.done, planned_supersteps=budget.total_super,
            capacity=cap,
            seconds={"prep": prep_s + t_prep, "chain": t_chain,
                     "polish": t_polish,
                     "score": time.perf_counter() - t_score - t_polish},
            chain=outcome, stopped=run.stopped,
            lane_energies=[float(u) for u in u_lanes[i]], best_lane=best,
            polish_energies=polished,
            accepted_by_kind=([] if run.by_kind is None
                              else run.by_kind[b].tolist())))
    logging.info(f"{name}: {run.done} supersteps x ~{budget.mps} cells in "
                 f"{n_lanes} lane(s) (K={cap}) [prep={t_prep:.1f}s "
                 f"chain={t_chain:.1f}s]")
    return results


def run_exact_scene(data: ImageWMaps, setup: EnergySetup,
                    comb: EnergyCombiner, params: RJMCMCParams,
                    seed: int = 0, capacity: int = 256, init: str = "naive",
                    segment_size: int = 4096,
                    max_segments: Optional[int] = None,
                    data_moves: bool = True, device=None,
                    checkpoint_path: Optional[str] = None,
                    stopping: Optional[StoppingCondition] = None,
                    restarts: int = 1, polish_steps: int = 0,
                    move_switch: bool = False,
                    split_merge: bool = False) -> SceneResult:
    """EXACT whole-scene MPP: one global cell-parallel chain over the full
    (bucket-padded) maps, then papangelou scores.

    ``restarts``: N independent anneals of the scene as N lanes of one
    launch sequence (lane 0 is the one-lane chain), keeping the lane of
    lowest final energy; ``polish_steps``: gradient polish of the kept
    configuration (``mpp/polish.py``); ``data_moves``, ``move_switch`` and
    ``split_merge`` choose the superstep's moves (``make_parallel_step``).
    ``checkpoint_path`` and ``stopping`` as in
    ``run_exact_scenes_batched``; ``max_segments`` stops the anneal after
    that many segments and scores the state reached (a bounded run;
    ``supersteps`` says how far it got)."""
    device = resolve_device(device)
    t_start = time.perf_counter()
    target = scene_shape_bucket(*data.shape, 1)
    data, c0, m0, orig = _prepare(data, setup, target, init, device)
    cap = _capacity(*data.shape, capacity, len(c0))
    prepared = [(data, c0, m0, orig, time.perf_counter() - t_start)]
    moves = dict(data_moves=data_moves, move_switch=move_switch,
                 split_merge=split_merge)
    return _run_lanes(prepared, setup, comb, params, [seed],
                      max(1, int(restarts)), cap, segment_size, max_segments,
                      moves, device, checkpoint_path, stopping,
                      int(polish_steps), f"scene {data.name}")[0]


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
                             polish_steps: int = 0,
                             move_switch: bool = False,
                             split_merge: bool = False,
                             ) -> List[SceneResult]:
    """Exact scenes over a batch sharing ONE bucket and ONE capacity, as
    one program: the B scenes are the lanes of one launch sequence per
    superstep, and scene i equals ``run_exact_scene`` at that bucket and
    capacity with ``seeds[i]``, draw for draw (the JAX batched run's
    contract).

    ``stopping`` is evaluated once per segment over the batch, on JAX's
    summary (mean final energy, largest point count, summed accepts over
    summed proposals), so every scene stops at the same superstep.

    ``checkpoint_path``: the batch's states and its single progress after
    every segment, with a fingerprint led by ``CHECKPOINT_FORMAT``; the
    JAX package's file of the same name has no format tag and another
    length, so each package restarts on the other's file. ``polish_steps``
    polishes each scene's final configuration before scoring."""
    assert len(datas) > 0
    device = resolve_device(device)
    target_h = max(scene_shape_bucket(*d.shape, 1)[0] for d in datas)
    target_w = max(scene_shape_bucket(*d.shape, 1)[1] for d in datas)
    prepared = []
    for d in datas:
        t_start = time.perf_counter()
        d, c0, m0, orig = _prepare(d, setup, (target_h, target_w), init,
                                   device)
        prepared.append((d, c0, m0, orig, time.perf_counter() - t_start))
    cap = max(_capacity(target_h, target_w, capacity, len(p[1]))
              for p in prepared)
    moves = dict(data_moves=data_moves, move_switch=move_switch,
                 split_merge=split_merge)
    return _run_lanes(prepared, setup, comb, params, seeds, 1, cap,
                      segment_size, max_segments, moves, device,
                      checkpoint_path, stopping, int(polish_steps),
                      f"batched scenes x{len(datas)}")


# ------------------------------------------------------------------ tiled


def pad_image_w_maps(data: ImageWMaps, target: int) -> ImageWMaps:
    """Zero-pad the image and maps (bottom/right, numpy or torch) so each
    side reaches ``target`` px; in place, and returned."""
    h, w = data.shape
    ph, pw = max(0, target - h), max(0, target - w)
    if ph == 0 and pw == 0:
        return data
    data.image = _pad(data.image, ph, pw)
    data.detection_map = _pad(data.detection_map, ph, pw)
    data.param_dist_maps = [_pad(p, ph, pw) for p in data.param_dist_maps]
    data.shape = tuple(data.image.shape[:2])
    return data


# the tiled checkpoint's format tag (the fingerprint's first entry). The
# port writes it as ``NNNN_tiles.ck.npz``, a name the JAX package never
# reads, and the JAX package's tiled file has a shorter fingerprint.
TILED_CHECKPOINT_FORMAT = 3.0
TILED_CHECKPOINT_KEYS = {"xy", "marks", "alive", "done", "t0", "fingerprint",
                         "s_xy", "s_marks", "s_alive", "s_count"}
SAMPLERS = ("sequential", "parallel")
_STATE_FIELDS = ("xy", "marks", "alive")


def _keep_last_samples(kept: PointsState, n_kept: int, new: PointsState,
                       n_new: int, n_samp: int) -> PointsState:
    """The last ``n_samp`` of a tile's kept samples followed by a
    segment's: laned (B, n_samp, ...) buffers with the valid entries at
    the end (the counts are host ints, the same for every tile)."""
    v_old, v_new = min(n_kept, n_samp), min(n_new, n_samp)
    out = {}
    for f in _STATE_FIELDS:
        old, seg = getattr(kept, f), getattr(new, f)
        cat = torch.cat([old[:, n_samp - v_old:], seg[:, n_samp - v_new:]],
                        dim=1)[:, -n_samp:]
        buf = old.clone()
        buf[:, n_samp - cat.shape[1]:] = cat
        out[f] = buf
    return PointsState(**out)


def tile_lanes(patches: List[ImageWMaps], setup: EnergySetup,
               capacity: int, init: str, use_split_merge: bool,
               device: torch.device):
    """The tiles as lanes: stacked energy maps, kernel data and initial
    states (naive detection, GT or empty, at most ``capacity`` points;
    each tile's intensity is its initial point count)."""
    inits = []
    for p in patches:
        if init == "naive":
            c0, m0 = naive_detection(p, setup.detection_threshold)
        elif init == "gt":
            c0, m0 = p.gt_centers, p.gt_marks
        else:
            c0 = np.zeros((0, 2), np.float32)
            m0 = np.zeros((0, 3), np.float32)
        inits.append((c0[:capacity], m0[:capacity]))
    n = len(patches)
    maps = stack_lanes(lambda i: setup.make_maps(patches[i]), n)
    kd = stack_lanes(lambda i: setup.make_kernel_data(
        patches[i], intensity=max(1, len(inits[i][0])),
        use_split_merge=use_split_merge), n)
    state = stack_lanes(lambda i: state_from_arrays(
        *inits[i], capacity=capacity, device=device), n)
    return maps, kd, state


def run_tiled_scene(data: ImageWMaps, setup: EnergySetup,
                    comb: EnergyCombiner, params: RJMCMCParams,
                    seed: int = 0, patch_size: int = 256,
                    min_overlap: int = 32, capacity: int = 256,
                    init: str = "naive", use_split_merge: bool = False,
                    sampler: str = "sequential",
                    checkpoint_path: Optional[str] = None,
                    segment_size: int = 4096,
                    max_segments: Optional[int] = None,
                    polish_steps: int = 0, data_moves: bool = True,
                    move_switch: bool = False, split_merge: bool = False,
                    device=None) -> Optional[SceneResult]:
    """TILED MPP inference (the JAX ``run_mpp_on_scene`` default): pad the
    scene to ``patch_size``, split it into overlapping tiles, run every
    tile's chain as a lane of ONE program, offset the tiles' detections
    to the scene and deduplicate them within 3 px, optionally polish, and
    score them by papangelou on the scene's maps.

    ``sampler``: ``"sequential"`` runs ``params.total_steps`` moves of the
    sequential chain per tile (``rjmcmc.run_chain``, one generator for all
    tiles), collecting the post-burn-in samples of the config; a tile's
    result is then its last sample. ``"parallel"`` runs the same budget in
    cell-parallel supersteps (``data_moves``, ``move_switch``,
    ``split_merge``; one generator per tile) and keeps the final state.
    ``use_split_merge`` gives the sequential mixture its split/merge pair.

    The chains run in segments of ``segment_size`` moves, reseeded per
    segment from (``seed``, moves done[, tile]) and threading the
    temperature as ``max(t0 * alpha ** n, t_target)``. ``checkpoint_path``:
    every tile's state, sample buffer and the progress after each
    unfinished segment (``TILED_CHECKPOINT_FORMAT``), resumed when its
    fingerprint matches and removed at the end. ``max_segments``: stop
    after that many segments and return None, as a killed run would (a
    resume then continues from the checkpoint)."""
    assert sampler in SAMPLERS, sampler
    device = resolve_device(device)
    t_start = time.perf_counter()
    data = pad_image_w_maps(data, patch_size)
    data.param_dist_maps = stack_param_dists(data.param_dist_maps,
                                             device=device)
    data.detection_map = torch.as_tensor(data.detection_map,
                                         dtype=torch.float32, device=device)
    patches = split_image(data, patch_size, min_overlap)
    n_tiles = len(patches)
    maps, kd, state = tile_lanes(patches, setup, capacity, init,
                                 use_split_merge, device)
    spec = setup.spec
    alpha = params.resolved_alpha()
    t_target = params.resolved_t_target()
    if sampler == "parallel":
        mps = max(1, (patch_size // (2 * CELL) + 1) ** 2 // 2)
        alpha_step = float(np.power(alpha, mps))
        total = max(1, params.total_steps // mps)
        seg = max(1, segment_size // mps)
        n_samp = 0
    else:
        alpha_step, total, seg = alpha, params.total_steps, segment_size
        n_samp = max(0, int(params.n_samples))
    interval = params.resolved_interval
    fingerprint = np.array(
        [TILED_CHECKPOINT_FORMAT, SAMPLERS.index(sampler), total, seg,
         alpha_step, t_target, capacity, n_samp, interval, n_tiles, seed],
        np.float64)
    done, t0 = 0, float(params.t0)
    samples = PointsState(**{
        f: torch.zeros((n_tiles, n_samp) + getattr(state, f).shape[1:],
                       dtype=getattr(state, f).dtype, device=device)
        for f in _STATE_FIELDS})
    s_count = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if (TILED_CHECKPOINT_KEYS <= set(ck.files)
                and ck["fingerprint"].shape == fingerprint.shape
                and bool(np.allclose(ck["fingerprint"], fingerprint))
                and int(ck["done"]) < total):
            state = PointsState(**{f: torch.as_tensor(ck[f], device=device)
                                   for f in _STATE_FIELDS})
            samples = PointsState(**{
                f: torch.as_tensor(ck["s_" + f], device=device)
                for f in _STATE_FIELDS})
            done, t0 = int(ck["done"]), float(ck["t0"])
            s_count = int(ck["s_count"])
            logging.info(f"scene {data.name}: resuming tiles at move {done}")
        else:
            logging.warning(f"scene {data.name}: tiled checkpoint mismatch "
                            "- restart")

    def checkpoint():
        np.savez(checkpoint_path, done=done, t0=t0, fingerprint=fingerprint,
                 s_count=s_count,
                 **{f: getattr(state, f).cpu().numpy() for f in _STATE_FIELDS},
                 **{"s_" + f: getattr(samples, f).cpu().numpy()
                    for f in _STATE_FIELDS})

    _sync(device)
    t_prep = time.perf_counter() - t_start
    t_chain = time.perf_counter()
    gen = torch.Generator(device=device)
    segments = 0
    while done < total:
        n = min(seg, total - done)
        if sampler == "parallel":
            gens = [torch.Generator(device=device).manual_seed(
                segment_seed(seed, done, t)) for t in range(n_tiles)]
            state, _, _ = run_exact_scene_chain(
                gens, state, maps, spec, comb, kd, n_supersteps=n, t0=t0,
                alpha_t=alpha_step, t_target=t_target, data_moves=data_moves,
                move_switch=move_switch, split_merge=split_merge)
        else:
            gen.manual_seed(segment_seed(seed, done))
            out = run_chain(gen, state, maps, spec, comb, kd, n_steps=n,
                            t0=t0, alpha_t=alpha, t_target=t_target,
                            n_samples=n_samp, samples_interval=interval,
                            burn_in=params.burn_in, step_offset=done)
            state = out[0]
            if n_samp > 0 and out[3] > 0:
                samples = _keep_last_samples(samples, s_count, out[2],
                                             out[3], n_samp)
                s_count += out[3]
        done += n
        t0 = max(float(t0 * alpha_step ** n), t_target)
        segments += 1
        if done < total:
            if checkpoint_path:
                checkpoint()
            if max_segments is not None and segments >= max_segments:
                return None
    _sync(device)
    t_chain = time.perf_counter() - t_chain
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    t_score = time.perf_counter()
    if s_count > 0:
        # the reference keeps a tile's LAST collected sample
        state = PointsState(**{f: getattr(samples, f)[:, -1]
                               for f in _STATE_FIELDS})
    centers_l, marks_l, scores_l = [], [], []
    for t in range(n_tiles):
        st = lane(state, t)
        scores_t = papangelou(st, lane(maps, t), spec, comb).cpu().numpy()
        xy, mk = state_to_arrays(st)
        centers_l.append(xy)
        marks_l.append(mk)
        scores_l.append(scores_t[st.alive.cpu().numpy()])
    centers, marks, scores = merge_patch_results(patches, centers_l, marks_l,
                                                 scores_l, distance=3.0)
    polished, t_polish = None, 0.0
    if len(centers) > 0:
        # the global rescore on the scene's maps, capacity bucketed to 64
        scene_maps = setup.make_maps(data)
        cap_b = -(-len(centers) // 64) * 64
        scene_state = state_from_arrays(centers, marks, capacity=cap_b,
                                        device=device)
        if polish_steps > 0:
            t_p = time.perf_counter()
            scene_state, (u_pre, u_post) = polish_state(
                scene_state, scene_maps, spec, comb, n_steps=polish_steps)
            centers, marks = state_to_arrays(scene_state)
            polished = (float(u_pre), float(u_post))
            t_polish = time.perf_counter() - t_p
            logging.info(f"scene {data.name}: polish {polish_steps} steps "
                         f"U {polished[0]:.2f} -> {polished[1]:.2f}")
        scores = papangelou(scene_state, scene_maps, spec,
                            comb).cpu().numpy()[:len(centers)]
    logging.info(f"scene {data.name}: {n_tiles} tiles x {done} {sampler} "
                 f"steps -> {len(centers)} detections [prep={t_prep:.1f}s "
                 f"chain={t_chain:.1f}s]")
    return SceneResult(
        centers=np.asarray(centers).reshape(-1, 2),
        marks=np.asarray(marks).reshape(-1, 3),
        scores=np.asarray(scores).reshape(-1),
        total_moves=n_tiles * params.total_steps, supersteps=done,
        planned_supersteps=total, capacity=capacity,
        seconds={"prep": t_prep, "chain": t_chain, "polish": t_polish,
                 "score": time.perf_counter() - t_score - t_polish},
        polish_energies=polished, n_tiles=n_tiles, samples=s_count)
