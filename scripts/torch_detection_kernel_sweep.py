#!/usr/bin/env python3
"""Ring depth and block size of the detection-map kernel, swept on one GPU.

Builds ``native/detection_map.cu`` once per (STAGES, THREADS) pair below,
with only those two constants changed, into ``native/build/sweep/`` (one
``nvcc`` per variant, all started together), checks each variant against
the plain version, and times it on the device at the main-path launch (8
views of 958x926 from (3, 1024, 1024) head planes, DivClassifier epilogue,
logit mask) and at 8 views of 1024^2 in both epilogues. The variant
marked ``no_pixel_work`` skips every output pixel (its maps are wrong and
not checked) but keeps the loads, waits, barriers and stores: its time is
what the data movement alone takes. As a yardstick the script times one
``copy_`` that moves as many bytes as the main-path launch must.

    python3 scripts/torch_detection_kernel_sweep.py [--seed 0]

Prints one JSON line per variant, the card's name and power limit, and a
summary JSON line last. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (STAGES, THREADS, pixel work); the shipped kernel is (2, 512, True)
VARIANTS = [(2, 512, True), (2, 512, False), (3, 512, True), (1, 512, True),
            (2, 256, True), (3, 256, True), (2, 1024, True)]
PIXEL_TEST = "      if (a < 0 || a >= h || b < 0 || b >= w) continue;"


def build(native, stages: int, threads: int, pixel_work: bool):
    """Start nvcc on the variant's source; returns (process, library)."""
    with open(os.path.join(native.SRC_DIR, "detection_map.cu")) as f:
        src = f.read()
    for name, value in (("STAGES", stages), ("THREADS", threads)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    if not pixel_work:
        assert src.count(PIXEL_TEST) == 1
        src = src.replace(PIXEL_TEST, "      continue;")
    out_dir = os.path.join(native.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, f"detection_map_s{stages}_t{threads}"
                                 f"{'' if pixel_work else '_no_pixel_work'}")
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.Popen(
        [native.nvcc_path(), *native.NVCC_FLAGS, "-o", stem + ".so",
         stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, stem + ".so"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import ctypes

    import torch

    import chip_smoke as cs
    from mpp_cnn_rs_object_detection_torch import native
    from mpp_cnn_rs_object_detection_torch.device import nvidia_smi_line
    from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    builds = [(s, t, w) + build(native, s, t, w) for s, t, w in VARIANTS]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    main_views = cs.noisy_views(cs.HEIGHT, cs.WIDTH, 8, 1024, gen, dev)
    full_views = cs.noisy_views(1024, 1024, 8, 1024, gen, dev)
    cases = [("main", main_views, (cs.HEIGHT, cs.WIDTH), "div_clf"),
             ("1024_div_clf", full_views, (1024, 1024), "div_clf"),
             ("1024_detection", full_views, (1024, 1024), "detection")]
    bounds = {name: cs.stencil_bound_ms(
        sum(v.crop[0] * v.crop[1] for v in views), hw[0] * hw[1])
        for name, views, hw, _ in cases}
    results = []
    for stages, threads, pixel_work, proc, lib_path in builds:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the variant {stages}, "
                               f"{threads}:\n{log}")
        fn = ctypes.CDLL(lib_path).detection_map_tta_launch
        fn.argtypes = dk.KERNEL.function().argtypes
        fn.restype = ctypes.c_int
        dk.KERNEL._fn = fn
        row = {"stages": stages, "threads": threads,
               "no_pixel_work": not pixel_work, "ptxas": " | ".join(
                   ln.strip() for ln in log.splitlines()
                   if "registers" in ln)}
        for name, views, hw, epilogue in cases:
            kw = dict(mask_is_logit=True, epilogue=epilogue, clf_w=-3.0,
                      clf_b=0.5)
            err = float((dk.detection_map_tta(views, hw, **kw)
                         - dk.detection_map_tta_plain(views, hw, **kw))
                        .abs().max())
            if pixel_work and not err <= 1e-5:
                raise AssertionError(f"variant {stages}, {threads} "
                                     f"disagrees with the plain version")
            ms = cs.cuda_time_ms(lambda: dk.detection_map_tta(views, hw,
                                                              **kw), reps=50)
            row[name] = {"ms": ms, "share_of_bound": bounds[name] / ms,
                         "max_abs_err": err}
        print(json.dumps(row), flush=True)
        results.append(row)
    dk.KERNEL._fn = None

    n_bytes = int(cs.stencil_bound_ms(
        sum(v.crop[0] * v.crop[1] for v in main_views),
        cs.HEIGHT * cs.WIDTH) * 1e-3 * cs.H100_BYTES_PER_S)
    src = torch.empty(n_bytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = cs.cuda_time_ms(lambda: dst.copy_(src), reps=50)
    best = min((r for r in results if not r["no_pixel_work"]),
               key=lambda r: r["main"]["ms"])
    print(nvidia_smi_line())
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev),
        "bound_ms": bounds, "copy_ms_same_bytes": copy_ms,
        "copy_rate_tb_s": n_bytes / (copy_ms * 1e-3) / 1e12,
        "best_main": [best["stages"], best["threads"], best["main"]["ms"]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
