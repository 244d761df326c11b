#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship scene goes, on one GPU.

Loads the flagship configuration (``mpp_log_r12ttapar``) with all three of
its trained U-Net checkpoints through ``SceneInference.from_storage`` (a
missing checkpoint raises), makes a synthetic 958x926 scene, times its CNN
maps and counts their detection-map kernel launches, and profiles a window
of chain supersteps at the 1024 bucket with K = 1024 with
``torch.profiler``: wall time per superstep, device kernel
time and kernel launches per superstep, the device's idle share (device
kernel time against the unprofiled wall time), and the kernels that take
the most device time.

    python3 scripts/torch_profile_chain.py [--seed 0] [--lanes 1]

``--lanes B`` runs the scene as B lanes of one program (the restarts'
layout: the maps shared as views, one generator per lane), so launches and
device time per superstep can be read against B.

Prints one JSON summary line last. Needs a CUDA device and the trained
checkpoints under ``artifacts/models_storage/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MPP_CONFIG = "mpp_log_r12ttapar"
HEIGHT, WIDTH, OBJECTS = 958, 926, 150
DEVICE = "cuda:0"
# supersteps run before the profiled window, and in it
WARMUP, WINDOW = 20, 20


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=1)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpp_cnn_rs_object_detection_torch import native
    from mpp_cnn_rs_object_detection_torch.data.synth import synthetic_scene
    from mpp_cnn_rs_object_detection_torch.device import nvidia_smi_line
    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model
    from mpp_cnn_rs_object_detection_torch.mpp import scene
    from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import (
        CELL,
        make_parallel_step,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
        build_cache,
        energy_from_cache,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import (
        expand_lanes,
        stack_lanes,
        state_from_arrays,
    )
    from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)

    def sync():
        torch.cuda.synchronize(dev)

    native.load("detection_map")
    config = mpp_model.load_mpp_config(MPP_CONFIG)
    inf = mpp_model.SceneInference.from_storage(config, device=dev)
    setup, comb = inf.setup, inf.comb
    image, _, _ = synthetic_scene(HEIGHT, WIDTH, OBJECTS, seed=args.seed)

    inf.cnn_maps(image)  # warm-up (cuDNN algorithm choice)
    sync()
    dk.KERNEL.launches = 0
    t0 = time.perf_counter()
    data = inf.cnn_maps(image)
    sync()
    cnn_s = time.perf_counter() - t0
    cnn_launches = dk.KERNEL.launches

    target = scene.scene_shape_bucket(*data.shape)
    data, c0, m0, _ = scene._prepare(data, setup, target, "naive", dev)
    cap = scene._capacity(*data.shape, config.get("capacity", 256), len(c0))
    lanes = args.lanes
    maps = expand_lanes(setup.make_maps(data), lanes)
    kd = expand_lanes(setup.make_kernel_data(data, intensity=max(1, len(c0))),
                      lanes)
    state = stack_lanes(lambda _: state_from_arrays(
        c0[:cap], m0[:cap], capacity=cap, device=dev), lanes)
    budget = scene.superstep_budget(*data.shape, inf.params)
    h, w = data.shape
    step = make_parallel_step(maps, setup.spec, comb, kd, budget.alpha_super,
                              budget.t_target, max(h, w) // (2 * CELL) + 1)
    cache = build_cache(state, maps, setup.spec)
    carry = (state, cache, energy_from_cache(state, maps, setup.spec, comb,
                                             cache), 1.0)
    gen = [torch.Generator(device=dev).manual_seed(args.seed + i)
           for i in range(lanes)]
    for _ in range(WARMUP):
        carry, _ = step(carry, gen)
    sync()

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(WINDOW):
            carry, _ = step(carry, gen)
        sync()
    wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(WINDOW):
        carry, _ = step(carry, gen)
    sync()
    wall_unprofiled_s = time.perf_counter() - t0

    events = prof.key_averages()
    kernels = [e for e in events if device_us(e) > 0 and e.device_type is not
               None and "cuda" in str(e.device_type).lower()]
    dev_us = sum(device_us(e) for e in kernels)
    launches = sum(int(e.count) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    n = WINDOW
    summary = {
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": nvidia_smi_line(),
        "bucket": list(target), "capacity": cap, "lanes": lanes,
        "cells_per_superstep": (max(h, w) // (2 * CELL) + 1) ** 2,
        "cnn_maps_s": cnn_s,
        "detection_map_launches_per_scene": cnn_launches,
        "superstep_wall_ms": 1e3 * wall_unprofiled_s / n,
        "superstep_wall_ms_profiled": 1e3 * wall_s / n,
        "superstep_device_ms": dev_us / 1e3 / n,
        # against the unprofiled wall: the profiler itself slows the host
        "device_idle_share": 1.0 - (dev_us / 1e6 / n) / (wall_unprofiled_s
                                                          / n),
        "kernel_launches_per_superstep": launches / n,
        "top_kernels": [{"name": e.key[:80], "device_ms_per_superstep":
                         device_us(e) / 1e3 / n,
                         "calls_per_superstep": e.count / n} for e in top],
    }
    print(json.dumps(summary))
    return 0 if bool(torch.isfinite(carry[2]).all()) else 1


if __name__ == "__main__":
    sys.exit(main())
