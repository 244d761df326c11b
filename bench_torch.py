#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one NVIDIA GPU: the secondary stages of
``bench.py`` (which benchmarks the JAX package and stays as it is), with
their workloads, on the port.

    python3 bench_torch.py [--full]
    python3 bench_torch.py --device cpu --small   # CPU smoke, tiny shapes

Stages:
  cnn            the PosNet detection-map forward (hidden_dims [32, 64, 128,
                 256], bf16 convolutions, then the detection-map kernel) on
                 8 tiles of 256^2: tiles/s, and its MFU (the forward's FLOPs
                 from ``torch.utils.flop_counter.FlopCounterMode`` against
                 the H100's dense bf16 peak);
  scene          one 1024^2 synthetic scene with 200 objects
                 (``_scene_data``), ``NoCalibrationEnergySetup`` calibrated
                 on its GT, the ``sum`` combiner, capacity 256 (K = 1024 at
                 the 1024 bucket): naive init, exact chain, papangelou;
  scene_batched  B = 3 of those scenes as one batched program
                 (``run_exact_scenes_batched``);
  superstep      ms per superstep of the one-lane chain at the 1024 bucket
                 with K = 1024 (``bench.py``'s ``bench_superstep_cost``
                 inputs: ``LEGACY_SPEC``, an empty state);
  sequential     ``bench.py``'s ``jax`` stage on the port: 16 sequential
                 chains of one 256^2 tile (80 blobs) as the lanes of
                 ``rjmcmc.run_chains_batch``, 3,000 steps from an empty
                 state at K = 256: moves/s, median of 3 runs;
  baseline       ``bench.py``'s ``baseline`` stage: a sequential chain in
                 plain Python and numpy on the host (an object list, local
                 dU with per-pair polygon clipping), 1,200 steps, median
                 of 3 runs.

The scene chains are depth-cut by default to their first segment (341 of
the 2,728 supersteps of the budget); the scene seconds are then projected
to the full budget from the measured ms per superstep. ``--full`` runs the
whole budget.

Prints one JSON line last: the headline ``scene_seconds_per_scene_batched3``
(projected) and, under ``extra``, every stage, the B = 1 and B = 3 ms per
superstep, the sequential chains' moves/s against the baseline's, the
card's ``nvidia-smi`` name and power limit, and whether the run was
depth-cut. Without a CUDA device it raises unless ``--device cpu``
is given; a CPU run's numbers are CPU times, not device metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# NVIDIA H100 SXM data sheet, dense bf16 (at the full 700 W power limit)
H100_BF16_FLOPS = 989e12
BATCH_SCENES = 3


def build_tile(h=256, w=256, n_obj=80, n_classes=32, seed=0):
    """``bench.py``'s synthetic maps: Gaussian blobs at random centers, and
    mark distributions peaked at a quarter of the classes."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[:h, :w]
    det = np.zeros((h, w))
    centers = rng.integers(8, [h - 8, w - 8], size=(n_obj, 2))
    for c in centers:
        det += np.exp(-((gy - c[0]) ** 2 + (gx - c[1]) ** 2) / (2 * 2.0**2))
    det = np.clip(det, 0, 1)
    dist = np.full((h, w, n_classes), 1.0, np.float32)
    dist[..., n_classes // 4] = 4.0
    dist /= dist.sum(-1, keepdims=True)
    return det.astype(np.float32), [dist] * 3


def _scene_data(h, w, n_obj, seed):
    """``bench.py``'s synthetic scene, in the port's types."""
    from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
    from mpp_cnn_rs_object_detection_torch.ops.mappings import (
        default_mappings,
    )

    rng = np.random.default_rng(seed)
    det, dists = build_tile(h, w, n_obj=n_obj, seed=seed)
    mappings = default_mappings(dists[0].shape[-1], 0, 32)
    centers = rng.integers(8, [h - 8, w - 8], size=(n_obj, 2)).astype(
        np.float32)
    return ImageWMaps(
        image=np.stack([det] * 3, -1), name=f"bench{seed}", shape=(h, w),
        detection_map=det, param_dist_maps=list(dists), mappings=mappings,
        labels={"centers": centers,
                "parameters": np.tile(np.asarray([[4.0, 9.0, 0.4]],
                                                 np.float32), (n_obj, 1)),
                "categories": np.zeros(n_obj, np.int32),
                "difficult": np.zeros(n_obj, bool)},
        gt_centers=centers,
        gt_marks=np.tile(np.asarray([[6.5, 0.44, 0.4]], np.float32),
                         (n_obj, 1)),
    )


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_cnn(device, size: int, batch: int, hidden, reps: int) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mpp_cnn_rs_object_detection_torch.models.unet import PosNet
    from mpp_cnn_rs_object_detection_torch.ops.detection_kernel import (
        detection_map,
    )

    torch.manual_seed(0)
    net = PosNet(hidden, out_channels=3, dtype=torch.bfloat16).to(
        device).eval()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (batch, 3, size, size), np.float32)).to(device)

    @torch.no_grad()
    def fwd():
        out = net(x)
        return detection_map((out[:, 0].contiguous(),
                              out[:, 1].contiguous()),
                             out[:, 2].contiguous(), mask_is_logit=True)

    fwd()
    _sync(device)
    with FlopCounterMode(display=False) as counter:
        fwd()
    flops = float(counter.get_total_flops())
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd()
    _sync(device)
    dt = time.perf_counter() - t0
    out = {"tiles_per_s": batch * reps / dt, "tile": [size, size],
           "batch": batch, "hidden_dims": list(hidden),
           "flops_per_forward": flops, "mfu": None}
    if device.type == "cuda":
        out["mfu"] = flops * reps / dt / H100_BF16_FLOPS
        out["mfu_peak"] = "989 TFLOP/s dense bf16 (H100 SXM data sheet)"
    return out


def _energy_model(datas):
    from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
        EnergyCombiner,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
        NoCalibrationEnergySetup,
    )

    setup = NoCalibrationEnergySetup()
    setup.calibrate(datas, None, save_path="")
    return setup, EnergyCombiner(kind="sum", names=setup.spec.names)


def _scene_numbers(results, seconds: float) -> dict:
    """Measured seconds and the projection to the full budget: everything
    but the chain (every scene's prep and scores) as measured over the
    whole call, the chain at the measured ms per superstep."""
    r = results[0]
    ms = 1e3 * r.seconds["chain"] / max(r.supersteps, 1)
    other = seconds - r.seconds["chain"]
    projected = (other + ms * r.planned_supersteps / 1e3) / len(results)
    return {"scenes": len(results), "seconds": seconds,
            "chain_seconds": r.seconds["chain"], "supersteps": r.supersteps,
            "planned_supersteps": r.planned_supersteps,
            "ms_per_superstep": ms, "capacity": r.capacity,
            "seconds_per_scene_projected": projected,
            "detections": [len(x.centers) for x in results],
            "moves_per_s": (r.total_moves * len(results)
                            / max(r.seconds["chain"], 1e-9))}


def stage_scene(device, size: int, n_obj: int, n_scenes: int,
                segment_size: int, full: bool) -> dict:
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        run_exact_scenes_batched,
    )

    seeds = list(range(n_scenes))

    def datas():
        return [_scene_data(size, size, n_obj, seed=s + 1) for s in seeds]

    setup, comb = _energy_model(datas())
    kw = dict(seeds=seeds, capacity=256, device=device)
    # warm-up: a 10-superstep budget at the same shapes
    run_exact_scenes_batched(
        datas(), setup, comb, RJMCMCParams(n_steps=120, alpha_t=0.99,
                                           n_samples=0, samples_interval=1),
        segment_size=120, **kw)
    _sync(device)
    params = RJMCMCParams(n_steps=30000, alpha_t=0.999, n_samples=0,
                          samples_interval=1)
    inputs = datas()
    t0 = time.perf_counter()
    results = run_exact_scenes_batched(
        inputs, setup, comb, params, segment_size=segment_size,
        max_segments=None if full else 1, **kw)
    _sync(device)
    return _scene_numbers(results, time.perf_counter() - t0)


def stage_superstep(device, size: int, capacity: int, n_super: int) -> dict:
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
        EnergyCombiner,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.energies import (
        LEGACY_SPEC,
        make_energy_maps,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.kernels import (
        make_kernel_data,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import (
        run_parallel_chain,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import empty_state
    from mpp_cnn_rs_object_detection_torch.ops.mappings import (
        default_mappings,
    )

    det, dists = build_tile(size, size, n_obj=200, seed=2)
    mappings = default_mappings(dists[0].shape[-1], 0, 32)
    dists_t = [torch.from_numpy(d).to(device) for d in dists]
    det_t = torch.from_numpy(det).to(device)
    maps = make_energy_maps(det_t, [-d for d in dists_t], 0.5, 4.0, 200.0,
                            mappings)
    kd = make_kernel_data(det_t, dists_t, mappings, intensity=200.0)
    comb = EnergyCombiner(kind="sum", names=LEGACY_SPEC.names)

    def run(n):
        gen = torch.Generator(device=device).manual_seed(0)
        final, stats = run_parallel_chain(
            gen, empty_state(capacity, device), maps, LEGACY_SPEC, comb, kd,
            n_supersteps=n, alpha_t=0.999)
        float(stats.final_energy)
        return final

    run(4)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    final = run(n_super)
    _sync(device)
    dt = time.perf_counter() - t0
    return {"ms_per_superstep": dt / n_super * 1e3, "supersteps": n_super,
            "bucket": [size, size], "capacity": capacity,
            "n_points": int(final.n_points)}


def stage_sequential(device, size: int, n_chains: int, n_steps: int,
                     capacity: int, n_runs: int) -> dict:
    """``bench.py``'s ``bench_jax``: B sequential chains of one tile as
    lanes, moves/s over ``n_runs`` timed runs (median, and every run)."""
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
        manual_hierarchical,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.energies import (
        LEGACY_SPEC,
        make_energy_maps,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.kernels import (
        make_kernel_data,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
        run_chains_batch,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import (
        empty_state,
        expand_lanes,
    )
    from mpp_cnn_rs_object_detection_torch.ops.mappings import (
        default_mappings,
    )

    det, dists = build_tile(size, size)
    mappings = default_mappings(dists[0].shape[-1], 0, 32)
    dists_t = [torch.from_numpy(d).to(device) for d in dists]
    det_t = torch.from_numpy(det).to(device)
    maps = make_energy_maps(det_t, [-d for d in dists_t], 0.5, 4.0, 200.0,
                            mappings)
    kd = make_kernel_data(det_t, dists_t, mappings, intensity=80.0)
    comb = manual_hierarchical(LEGACY_SPEC.names, {
        "PositionEnergy": 0.4, "ShapeEnergy": 0.1,
        "RectangleOverlapEnergy": 0.3, "ShapeAlignmentEnergy": 0.025,
        "AreaPriorEnergy": 0.1}, device=device)
    init = expand_lanes(empty_state(capacity, device), n_chains)

    def run(seed, steps):
        gen = torch.Generator(device=device).manual_seed(seed)
        _, stats = run_chains_batch(gen, init, maps, LEGACY_SPEC, comb, kd,
                                    n_steps=steps, alpha_t=0.999)
        _sync(device)
        return stats

    run(0, 20)  # warm-up
    runs, stats = [], None
    for i in range(n_runs):
        t0 = time.perf_counter()
        stats = run(1 + i, n_steps)
        runs.append(n_chains * n_steps / (time.perf_counter() - t0))
    return {"moves_per_s": float(np.median(runs)), "runs": runs,
            "chains": n_chains, "steps": n_steps, "capacity": capacity,
            "tile": [size, size],
            "ms_per_step": 1e3 * n_chains / float(np.median(runs)),
            "n_found": float(stats.final_n_points.float().mean())}


def baseline_chain(det, n_steps: int, seed: int = 0) -> tuple:
    """``bench.py``'s ``bench_python_baseline``: a sequential chain in
    plain Python -- births from the detection map, deaths and moves, local
    dU with the overlap of every neighbour within 32 px by polygon
    clipping. Returns (moves/s, final point count)."""
    from mpp_cnn_rs_object_detection_torch.metrics.polyiou import (
        poly_intersection_plain,
    )

    rng = np.random.default_rng(seed)
    h, w = det.shape
    flat = (det / det.sum()).ravel()
    points = []  # dicts: x, y, size, ratio, angle

    def poly_of(p):
        length = 2 * p["size"] / (1 + p["ratio"])
        width = p["ratio"] * length
        a = p["angle"] + np.pi / 2
        c, s = np.cos(a), np.sin(a)
        hx, hy = length / 2, width / 2
        corners = np.array([[hx, hy], [hx, -hy], [-hx, -hy], [-hx, hy]])
        return corners @ np.array([[c, s], [-s, c]]) + np.array(
            [p["x"], p["y"]])

    def area(p):
        return p["size"] ** 2 * 4 * p["ratio"] / (1 + p["ratio"]) ** 2

    def local_energy(p, others):
        e = -2.0 * (det[int(p["x"]), int(p["y"])] - 0.5)
        pa = poly_of(p)
        best_ov = 0.0
        for q in others:
            if q is p:
                continue
            if np.hypot(p["x"] - q["x"], p["y"] - q["y"]) <= 32:
                inter = poly_intersection_plain(pa, poly_of(q))
                best_ov = max(best_ov,
                              inter / (min(area(p), area(q)) + 1e-6))
        return e + best_ov

    t0 = time.perf_counter()
    for _ in range(n_steps):
        kind = rng.random()
        if kind < 0.4 or not points:  # birth
            idx = rng.choice(len(flat), p=flat)
            p = {"x": idx // w, "y": idx % w, "size": rng.uniform(2, 16),
                 "ratio": rng.uniform(0.2, 1), "angle": rng.uniform(0, np.pi)}
            if np.log(rng.random() + 1e-16) < -local_energy(p, points):
                points.append(p)
        elif kind < 0.7:  # death
            i = rng.integers(len(points))
            if np.log(rng.random() + 1e-16) < local_energy(points[i],
                                                           points):
                points.pop(i)
        else:  # move
            i = rng.integers(len(points))
            p = dict(points[i])
            p["x"] = int(np.clip(p["x"] + rng.normal(0, 2), 0, h - 1))
            p["y"] = int(np.clip(p["y"] + rng.normal(0, 2), 0, w - 1))
            delta = local_energy(p, points) - local_energy(points[i], points)
            if np.log(rng.random() + 1e-16) < -delta:
                points[i] = p
    return n_steps / (time.perf_counter() - t0), len(points)


def stage_baseline(size: int, n_steps: int, n_runs: int) -> dict:
    det, _ = build_tile(size, size)
    runs = [baseline_chain(det, n_steps, seed=s)[0] for s in range(n_runs)]
    return {"moves_per_s": float(np.median(runs)), "runs": runs,
            "steps": n_steps, "protocol": f"{n_steps} steps x {n_runs} "
            "runs, median, on the host CPU"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only if named)")
    ap.add_argument("--full", action="store_true",
                    help="run the whole superstep budget (no depth cut)")
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes, for a smoke run on the CPU")
    args = ap.parse_args(argv)

    import torch

    from mpp_cnn_rs_object_detection_torch.device import (
        nvidia_smi_line,
        resolve_device,
    )

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        kind = torch.cuda.get_device_name(device)
        smi = nvidia_smi_line()
    else:
        kind, smi = "cpu", None
    if args.small:
        cnn = dict(size=64, batch=2, hidden=[8, 16], reps=2)
        scene = dict(size=128, n_obj=10, segment_size=600)
        sstep = dict(size=128, capacity=64, n_super=8)
        seq = dict(size=64, n_chains=2, n_steps=10, capacity=16, n_runs=1)
        base = dict(size=64, n_steps=30, n_runs=1)
    else:
        cnn = dict(size=256, batch=8, hidden=[32, 64, 128, 256], reps=10)
        scene = dict(size=1024, n_obj=200, segment_size=4096)
        sstep = dict(size=1024, capacity=1024, n_super=128)
        seq = dict(size=256, n_chains=16, n_steps=3000, capacity=256,
                   n_runs=3)
        base = dict(size=256, n_steps=1200, n_runs=3)

    stages = {}
    t_all = time.perf_counter()
    for name, fn in (
            ("cnn", lambda: stage_cnn(device, **cnn)),
            ("scene", lambda: stage_scene(device, n_scenes=1, full=args.full,
                                          **scene)),
            ("scene_batched", lambda: stage_scene(
                device, n_scenes=BATCH_SCENES, full=args.full, **scene)),
            ("superstep", lambda: stage_superstep(device, **sstep)),
            ("sequential", lambda: stage_sequential(device, **seq)),
            ("baseline", lambda: stage_baseline(**base))):
        t0 = time.perf_counter()
        stages[name] = fn()
        print(f"# stage {name}: {time.perf_counter() - t0:.3f} s "
              f"{json.dumps(stages[name])}", file=sys.stderr, flush=True)
    headline = stages["scene_batched"]["seconds_per_scene_projected"]
    extra = {
        "device": kind, "nvidia_smi": smi, "depth_cut": not args.full,
        "small": args.small, "torch": torch.__version__,
        "ms_per_superstep": {
            "B1": stages["scene"]["ms_per_superstep"],
            f"B{BATCH_SCENES}": stages["scene_batched"]["ms_per_superstep"]},
        "scene_seconds_per_scene": stages["scene"][
            "seconds_per_scene_projected"],
        "sequential_moves_per_s": stages["sequential"]["moves_per_s"],
        "sequential_vs_baseline": (stages["sequential"]["moves_per_s"]
                                   / stages["baseline"]["moves_per_s"]),
        "stages": stages,
        "seconds": time.perf_counter() - t_all,
    }
    print(json.dumps({
        "metric": f"scene_seconds_per_scene_batched{BATCH_SCENES}",
        "value": headline,
        "unit": "s/scene, projected to the full superstep budget"
                + ("" if args.full else " from its first segment"),
        "vs_baseline": None, "extra": extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
