#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA device and the CUDA toolkit (``nvcc``); without a device it
exits with code 2 and prints no result.

Phases (each prints one line with its seconds; any failure raises):
  1. device, ``nvidia-smi`` name and power limit, and the build of the
     port's CUDA kernel from its source (``nvcc``, sm_90a);
  2. the kernel against its plain PyTorch version on the card, in both
     epilogues and both mask modes: fused over the 8 TTA views of a 958x926
     frame from (3, 1024, 1024) head planes whose padding holds large
     noise, over the single view of that frame (the launch of a ShapeNet's
     un-augmented ``pos_model`` in phase 6), over 8 views at 1024^2, and one
     2-row view; and through the
     batched single-view entry point at (8, 1024, 1024), a ragged
     (3, 469, 753) and a 2-row case. Then the times of the main-path launch
     (8 views of 958x926, DivClassifier epilogue, logit mask): the kernel
     on the device, the same call paced by the host, the plain version and
     the bytes bound;
  3. CNN maps of one synthetic 958x926 scene (numpy, ``--seed``) at full
     width: the flagship's two PosNets (8-way TTA, max-combined) and its
     ShapeNet; the kernel must launch once per PosNet. Weights: see
     ``CHECKPOINTED_MODEL``;
  4. the exact whole-scene chain at the 1024 bucket with K = 1024 for
     ``--max-segments`` segments of 341 supersteps: ms per superstep, the
     projected full-budget seconds, a finite energy, and the carried cache
     and energy against a rebuild; then the same scene as a batch of B = 1
     and of B = 2 lanes (one program, seeds ``--seed`` and ``--seed`` + 1)
     for one segment each: ms per superstep of both, and lane 0 of B = 2
     against B = 1 -- identical detections, or, where the card's reductions
     differ in the last bit between the two shapes, the same first
     superstep (accept set and states) and final energies within the
     chains' spread (it prints which check held);
  5. papangelou scores (finite, positive) and the detection count: every
     point of the final configuration, as the export writes it;
  6. the port's command line on a dataset, from a temporary directory with
     its own ``paths_config.json``: ``make_synth_dataset`` writes 2 val
     scenes of 958x926 with 150 rectangles each (``--seed``), the model
     store holds ``CHECKPOINTED_MODEL`` (linked) and the flagship's other
     U-Nets (``pos_r2_tta``, ``shape_r5ls_tta`` and its ``pos_r2cp``) with
     weights drawn from ``--seed`` and written with the port's msgpack
     writer, and a copy of the flagship config whose only change is a
     ``max_iter`` stopping block of one 341-superstep segment per scene.
     ``-p infereval -m mpp`` must launch the detection-map kernel 3 times
     per scene, run both scenes as one batched program that stops them at
     the same superstep, write both result pickles, ``dota/`` and
     ``dota-SV/`` and every metrics JSON with finite APs and the 5 PR
     curves at the JAX package's canvas (every eval below is checked the
     same way), and remove its chain checkpoint;
  7. on phase 6's workspace (its CNN results reused), ``-p infereval -m mpp
     -c mpp_log_r12tta``: the trained combiner and calibration of that
     model store with the same depth cut, refine, score blend and backfill
     on; DOTA files and finite APs;
  8. a copy of that config with ``restarts: 2`` and ``polish_steps: 64``,
     one segment of ``CUT_SEG`` supersteps per scene, which takes the
     per-image path (one scene in memory at a time): per scene the lanes'
     energies, the lane kept (the least energy) and U
     before and after polish, which must not rise;
  9. on phase 6's workspace, ``-p train -m mpp`` on a copy of the flagship
     config (depth cut: ``TRAIN_EPOCHS`` of its 8 epochs on
     ``TRAIN_CROPS`` of its 64 crops): the train subset's CNN inference (3
     kernel launches per scene), calibration, the ordering criterion over
     kernel perturbations, and both files in the JAX package's format, a
     finite loss per epoch and moved weights, and the energy attribution
     figure (the card's attribution against the CPU's within
     ``ATTRIBUTION_TOL``, and complete); then one batch alone (the
     launches of one laned move, the peak memory of its vectors) and ``-p
     infereval`` with the trained combiner: finite APs;
  10. a copy of ``MANUAL_CONFIG`` (the legacy setup's manual mode) on the
     flagship's CNNs: ``-p infereval`` calibrates (a finite threshold),
     builds ``hierarchical_fixed`` (weights summing to 1 per group) and
     runs one segment of ``CUT_SEG`` supersteps per scene: finite APs;
  11. a copy of ``TILED_CONFIG`` (tiled scene mode, sequential chain,
     manual mode) on the flagship's CNNs, depth-cut to ``TILED_BURN_IN``
     burn-in moves in segments of ``TILED_SEGMENT``: every scene's 25
     tiles as the lanes of one chain, its post-burn-in samples, finite
     APs and no checkpoint left; ms per step, the launches and device ms
     of one step, the projected full-budget seconds; then one scene killed
     after its first segment resumes from its checkpoint to the end;
  12. a copy of ``SPLIT_MERGE_CONFIG`` (exact, batched, the superstep's
     split/merge pair) with its trained calibration and combiner on the
     flagship's CNNs for one ``CUT_SEG``-superstep segment: accepted moves by
     kind, the carried cache and energy against a rebuild, finite APs;
     then on phase 3's scene with the flagship's model one in-memory
     segment of ``SM_MEMORY_SEG`` supersteps with the split/merge pair
     and one with the switched move type (their energies against a
     rebuild; splits and merges accepted),
     and the launches and device ms of one superstep with each move set;
  13. CNN training on the device-resident patch pipeline at full width
     (U-Net [32, 64, 128, 256], bf16 convolutions, patches of 128^2,
     batches of 64, 208 objects per patch, copy-paste): a synthetic
     dataset of ``CNN_TRAIN_SCENES`` train and ``CLI_SCENES`` val scenes of
     ``CNN_SCENE``^2 with about ``CNN_OBJECTS`` objects each (``--seed``);
     copies of ``CNN_CONFIGS`` cut to ``CNN_CUT`` (the depth cut: 1,024 of
     16,384 patches, so 16 steps per epoch, 256 val patches, 3 of 136
     epochs, the train stack regenerated once, after epoch 1). ``-p train
     -m posnet``, then the same config at 4 epochs with ``-r`` (it resumes
     at epoch 3 with adam's count at 48), then ``-p train -m shapenet``;
     finite losses, the last epoch's mean train loss below the first's;
     one step on the card against the same step on the CPU (float32 copies
     of the trained state, TF32 off, the same batch and variates); one
     profiled step (launches, device ms, wall ms, the device's idle share,
     peak memory, MFU; adam's launches and the augmentation and targets'
     alone); then ``-p infer -m posnet`` on the val scenes with the trained
     model: one detection-map launch per scene, and one launch held
     against its plain version;
  14. CNN training on the host patch pipeline, the reference's own recipes
     at full width, on phase 13's dataset: copies of ``HOST_CONFIGS``
     (``config_pos``: U-Net [32, 64, 128, 256] in bf16, the div head,
     batches of 64 x 128^2, ``strong`` augmentation with histogram
     matching, hard mining; ``config_shape`` the same without mining) cut
     to ``HOST_CUT`` (256 of 16,384 patches, 128 val patches, 3 of 256
     epochs, a regeneration after epochs 1 and 2, the PosNet mining after
     epoch 2, the last). ``-p train -m posnet``: the regeneration
     sequence, one error-map PNG per train scene, the last train set drawn
     through a ``DensitySampler``, the temporary patch set gone at the
     end; then on a fresh patch set one host batch's float32 loss on the
     card against the CPU, one val epoch timed and one train epoch timed
     under the profiler (the loader's waits per batch, device ms per step,
     the device's idle share), projected to the full ``config_pos`` (its
     epochs, steps, regenerations and mining passes); ``-p train -m
     shapenet``; and
     ``-p infer -m posnet`` with the trained PosNet: one detection-map
     launch per val scene, one held against its plain version;
  15. in the same workspace: ``-p translate_dota`` on a raw DOTA tree
     written here (``RAW_DOTA``: 2 train and 2 val synthetic scenes of
     ``RAW_DOTA_HW``, GSD 0.30, 0.25 and 0.5 and one banned source; the
     translated counts, shapes and objects), ``-p translate_cowc`` on a
     raw COWC tree of ``COWC_SCENES`` scenes, ``-p check_div`` (its one
     kernel launch against the plain version within the tolerance), ``-p
     infereval -m oracle`` on the translated val set (AP 1.000 at every
     IoU), then the CNN-free data term (``CONTRAST_SETUP``: craciun2,
     manual weights) on the flagship's CNN results: a copy of
     ``MANUAL_CONFIG`` for one ``CUT_SEG``-superstep segment per scene (finite
     APs; the launches and device ms of one superstep alone) and a copy
     of ``TILED_CONFIG`` for ``CONTRAST_TILED`` sequential steps;
  16. the baseline detectors on phase 13's dataset: copies of
     ``DETECTOR_CONFIGS`` at full width (``config_fasterrcnn``: ResNet-50,
     FPN 256, box head 1024, bf16, batches of 32 x 128^2;
     ``config_bba_vec``: ResNet-101, head_conv 256, bf16, batches of 4)
     cut to ``DETECTOR_CUT`` (the patch counts and epochs only). Per
     detector ``-p train`` (finite losses, the device pipeline whatever
     the config says), a float32 step on the card against the CPU (the
     loss terms), one profiled bf16 step (launches, device and wall ms,
     the idle share, the greedy NMS's host ms, peak memory), the
     projected full training, then ``-p infereval`` (result pickles,
     DOTA files, finite APs).
  17. the meshes on one card, as ``[cuda:0] * n``: phase 3's scene in
     memory for ``MESH_SUPERSTEPS`` supersteps in 1, 2 and 4 row bands
     (and 1 and 2 with the split/merge pair) from one generator seed: the
     same alive set, states within ``MESH_XY_TOL``, accepts and energy,
     the carried cache and energy against a rebuild, ms per superstep,
     and the launches of one 2-band superstep; ``tile_mesh`` (the scene's
     25 tiles, 64 sequential moves, unsplit and in 2 groups) and
     ``batch_mesh`` (phase 6's val scenes as B = 2, on one device and
     over 2): identical, or phase 4's check; the flagship PosNet in
     float32 over 4 bands with a 64-row halo against the whole scene
     zero-padded by the halo (rtol 2e-4, atol 2e-5), then one kernel
     launch on the banded planes against the plain version on the whole
     scene's; and ``-p infereval`` on a copy of ``MESH_CONFIG``
     (``scene_mesh: true``, a no-op with one visible card) on the
     flagship's CNNs, one segment of ``MESH_SEG_SUPER`` supersteps per
     scene, with both overlay PNGs per scene (which phases 6-12 and 15
     check too);
  18. the figures: ``-p data_preview -m mpp`` on phase 6's workspace and
     ``-m posnet`` on phase 14's ``config_pos`` copy (host pipeline: 8
     patches and masks of its first batch); the papangelou field of phase
     3's scene (stride ``PAP_STRIDE``, timed; on a ``PAP_CROP`` crop the
     card's field against the CPU's within ``PAP_RTOL``); the interaction
     figure (its pairs equal to the chain's cache) and the energy cross
     plots (histograms equal to numpy's) of phase 4's final state; a GIF of
     phase 6's two detection overlays; phase 7's 10 PR curves (~36,800
     points each) timed.
Then one JSON line per kernel table (its launches: every path's, each
counted from 0 -- phases 3, 6, 9, 13, 14, 15's ``check_div`` and 17's
banded PosNet; the others reuse CNN results), the card's name and power
limit, and the result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time

MPP_CONFIG = "mpp_log_r12ttapar"
# phase 9: the flagship trained for TRAIN_EPOCHS of its 8 epochs on
# TRAIN_CROPS of its 64 crops (the depth cut; widths as configured)
TRAIN_EPOCHS, TRAIN_CROPS = 2, 16
# phase 10: the legacy manual mode in exact scene mode
MANUAL_CONFIG = "mpp_exact_smoke"
# phase 11: the tiled scene mode, depth-cut (the full budget is 30,000
# burn-in moves and 2 sampling intervals of 128, in segments of 4,096);
# 128 burn-in moves in segments of 128 since phase 18 was added (256 in
# segments of 256 since phase 16, 512 since phase 15, 1,024 before), to
# keep the script within its 600 s
TILED_CONFIG = "mpp_hrcM"
TILED_BURN_IN, TILED_SEGMENT = 128, 128
# its resume check: 128 burn-in moves + 2 x 128, killed after 128 (256
# and 256 before phase 18)
RESUME_BURN_IN, RESUME_SEGMENT = 128, 128
# phase 12: the superstep's split/merge pair, trained; its in-memory
# segments with the pair and with the move switch run SM_MEMORY_SEG of the
# flagship's 341 supersteps since phase 17 was added (341 before)
SPLIT_MERGE_CONFIG = "mpp_log_r10sm"
SM_MEMORY_SEG = 128
# phases 8, 10 and 15's exact CLI copies, and phase 12's since phase 18
# was added: one segment of CUT_SEG of the configs' 341 supersteps per
# scene since phase 17 was added (341 before), to keep the script within
# its 600 s
CUT_SEG = 170
# phases 7 and 8: the trained extension config on the same CNNs
EXT_CONFIG = "mpp_log_r12tta"
RESTARTS, POLISH_STEPS = 2, 64
# lane 0 of a B = 2 batch against the B = 1 run, where they are not
# identical: the first superstep's states, and the final energies of two
# chains of one scene from the same draws (relative)
FIRST_STEP_TOL = 1e-4
CHAIN_ENERGY_RTOL = 0.1
# the synthetic scene: the flagship's shape (pads to the 1024 bucket and
# exercises the crop) and a DOTA-like vehicle count
HEIGHT, WIDTH, OBJECTS = 958, 926, 150
# phase 6: the val scenes of the synthetic dataset
CLI_SCENES = 2
# The exported tree carries the trained weights of one flagship U-Net (each
# flagship checkpoint is 23 MB, and the export is kept small): this one
# loads from its checkpoint through the port's msgpack reader, and a missing
# file raises. The flagship's other two U-Nets run at full width with
# weights drawn from --seed in every run, whether or not their checkpoints
# are on disk, so every run of this script measures the same workload.
# scripts/torch_profile_chain.py runs the flagship with all three
# checkpoints.
CHECKPOINTED_MODEL = "pos_r2cp_tta"
# kernel vs plain: fp32 stencil arithmetic in another association order
RTOL, ATOL = 1e-5, 1e-5
# carried chain cache vs a rebuild: the same fp32 formulas, rows computed
# against different slot subsets
CACHE_TOL = 1e-4
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
# phase 13: CNN training, depth-cut copies of the trained configs
CNN_CONFIGS = {"posnet": "pos_r2cp", "shapenet": "shape_r5ls"}
CNN_CUT = {"n_patches": 1024, "val_patches": 256, "n_epochs": 3,
           "dataset_update_interval": 1}
CNN_TRAIN_SCENES, CNN_SCENE, CNN_OBJECTS = 8, 512, 100
# one float32 train step on the card against the CPU: the loss terms, and
# the parameters after one adam step of at most the learning rate (1e-3);
# the biases BatchNorm re-centres follow float noise, up to two steps
STEP_RTOL, STEP_PARAM_TOL, STEP_NOISE_TOL = 1e-4, 1e-4, 2e-3
# phase 14: CNN training on the host patch pipeline, depth-cut copies of
# the reference's recipes (full width; val patches are n_patches // 2);
# 256 patches since phase 16 was added (512 before), to keep the script
# within its 600 s
HOST_CONFIGS = {"posnet": "config_pos", "shapenet": "config_shape"}
HOST_CUT = {"n_patches": 256, "n_epochs": 3, "dataset_update_interval": 1,
            "error_update_interval": 2}
# phase 15: raw DOTA scenes (subset, GSD, source): a fractional rescale
# (0.30), an integer one (0.25), none (0.5) and a banned source
RAW_DOTA = [("train", "0.30", "GoogleEarth"), ("train", "0.25", "GF-2"),
            ("val", "0.5", "GoogleEarth"), ("val", "0.30", "Aerial")]
RAW_DOTA_HW, RAW_DOTA_OBJECTS = (1500, 1600), 120
COWC_SCENES, COWC_HW, COWC_CARS = 3, (1000, 1200), 50
# the CNN-free data term: craciun2 contrast, manual weights over its names
CONTRAST_SETUP = {
    "energy_setup": "contrast",
    "energy_setup_params": {"contrast_type": "craciun2"},
    "manual": {"threshold": 0.0, "indicator_energy": "ContrastEnergy",
               "weights": {"ContrastEnergy": 1.0, "OverlapPriorEnergy": 0.6,
                           "AlignmentPriorEnergy": 0.05,
                           "AreaPriorEnergy": 0.2,
                           "RatioPriorEnergy": 0.1}}}
# its tiled copy: steps in all (one segment), burn-in, sample interval
CONTRAST_TILED = (256, 128, 64)
# phase 16: the baseline detectors at full width, depth-cut (the configs
# train 16,384 patches, 2,048 val patches, for 256 and 50 epochs)
DETECTOR_CONFIGS = {"fasterrcnn": "config_fasterrcnn",
                    "bbavec": "config_bba_vec"}
DETECTOR_CUT = {"fasterrcnn": {"n_patches": 512, "val_patches": 128,
                               "n_epochs": 2},
                "bbavec": {"n_patches": 128, "val_patches": 64,
                           "n_epochs": 2}}
# the copies export at the *_quick configs' floor: two epochs leave few
# scores above the configs' default (0.25 / 0.2), and AP needs no floor
DETECTOR_MIN_CONFIDENCE = 0.02
# their float32 step card vs CPU: the loss terms (proposal selection and
# the greedy NMS on both sides of the same float noise), on the first
# DETECTOR_CPU_BATCH patches of a batch (the CPU's share of the phase)
DETECTOR_STEP_RTOL, DETECTOR_CPU_BATCH = 1e-3, 8
# phase 17: the meshes on one card, as ``[cuda:0] * n`` (the same
# arithmetic and copies as n cards, but for the copies between distinct
# cards): the banded chain for MESH_SUPERSTEPS supersteps at MESH_BANDS,
# the tile and batch splits over 2 for MESH_SUPERSTEPS steps and
# supersteps (64 each, and MESH_SEG_SUPER 128, until the phase took 71.7 s
# alone on an H100; cut to fit it in 45 s), the banded PosNet (halo
# MESH_HALO)
# at the tolerance of tests/test_parallel.py:72, and a copy of
# MESH_CONFIG (scene_mesh: true) cut to one segment of MESH_SEG_SUPER
# supersteps per scene
MESH_SUPERSTEPS, MESH_BANDS, MESH_HALO = 32, (2, 4), 64
MESH_CONFIG, MESH_SEG_SUPER = "mpp_r2", 64
MESH_XY_TOL, MESH_ENERGY_RTOL = 1e-5, 1e-4
UNET_RTOL, UNET_ATOL = 2e-4, 2e-5
# the kernel on the banded planes against the plain version on the whole
# scene's planes, which differ within UNET_RTOL / UNET_ATOL
MESH_MAP_TOL = 1e-4
# ~50 ms of the card's clock: longer than the host takes to queue a timed
# run of calls
SLEEP_CYCLES = 100_000_000
# every eval's PR curves: the JAX package's canvas, a figsize (8, 4)
# matplotlib figure at 100 dpi, RGBA
IOUS = (0.05, 0.1, 0.25, 0.5, 0.75)
PR_CURVE_SHAPE = (400, 800, 4)
# phase 9: the energy attribution on the card against the CPU, and its
# completeness (rows sum to f(x) - f(0)) within rtol |f(x) - f(0)| + atol
ATTRIBUTION_TOL = 1e-5
COMPLETENESS_RTOL, COMPLETENESS_ATOL = 5e-2, 5e-3
# phase 18: the papangelou field's probe marks (size, ratio, angle), its
# stride, the crop held card vs CPU and that tolerance
PAP_MARKS = (5.0, 0.5, 0.3)
PAP_STRIDE = 4
PAP_CROP = 128
PAP_RTOL = 1e-5


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the card sleeps while the host
    queues all ``reps`` calls, so the events between them time the card,
    not the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_paced_ms(fn, reps: int = 50) -> float:
    """Wall time of one call of ``fn`` called back to back, synchronised at
    the end: what a caller waits when the host sets the pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def stencil_bound_ms(view_pixels: int, out_pixels: int) -> float:
    """12 B per view pixel (two vector components and the mask read once)
    and 4 B per output pixel (written once) over the memory rate; ~30
    flop per view pixel is far below the fp32 rate, so bytes bound it."""
    return (12.0 * view_pixels + 4.0 * out_pixels) / H100_BYTES_PER_S * 1e3


def noisy_views(h: int, w: int, n_views: int, pad: int, gen, device):
    """Head planes of the first ``n_views`` dihedral views of an (h, w)
    frame, drawn on the card from the seeded generator ``gen``: standard
    normal [vx, vy, mask] in each view's crop, large noise (+-1e3) in the
    (pad, pad) planes around it, which the kernel must never read."""
    import torch

    from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk
    from mpp_cnn_rs_object_detection_torch.ops.dihedral import D4_ELEMENTS

    views = []
    for k, flip in D4_ELEMENTS[:n_views]:
        crop = (w, h) if k % 2 else (h, w)
        planes = torch.empty((3, pad, pad), device=device).uniform_(
            -1e3, 1e3, generator=gen)
        planes[:, :crop[0], :crop[1]] = torch.randn(
            (3,) + crop, device=device, generator=gen)
        views.append(dk.View(planes, crop, (k, flip)))
    return views


def compare(name, got, want):
    """Max abs / rel error of the kernel against its plain version; raises
    outside the tolerance."""
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    print(f"  kernel {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol=atol {ATOL} + rtol {RTOL}", flush=True)
    if not bool((err <= ATOL + RTOL * want.abs()).all()):
        raise AssertionError(f"detection_map kernel disagrees with its "
                             f"plain version: {name}")
    return max_abs


def kernel_vs_plain(device, seed: int):
    """Phase 2: returns the worst absolute error seen."""
    import numpy as np
    import torch

    from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    worst = 0.0
    modes = [(e, lg) for e in ("detection", "div_clf") for lg in (True, False)]
    for (h, w), n_views, pad in [((HEIGHT, WIDTH), 8, 1024),
                                 ((HEIGHT, WIDTH), 1, 1024),
                                 ((1024, 1024), 8, 1024), ((2, 517), 1, 520)]:
        views = noisy_views(h, w, n_views, pad, gen, device)
        probs = [v._replace(planes=torch.cat(
            [v.planes[:2], torch.sigmoid(v.planes[2:])])) for v in views]
        for epilogue, mask_is_logit in modes:
            vs = views if mask_is_logit else probs
            kw = dict(mask_is_logit=mask_is_logit, epilogue=epilogue,
                      clf_w=-3.0, clf_b=0.5)
            worst = max(worst, compare(
                f"tta {epilogue:9s} logit={int(mask_is_logit)} {n_views} "
                f"views of {(h, w)}", dk.detection_map_tta(vs, (h, w), **kw),
                dk.detection_map_tta_plain(vs, (h, w), **kw)))
        del views, probs
    for shape in [(8, 1024, 1024), (3, 469, 753), (1, 2, 517)]:
        vec = torch.from_numpy(rng.normal(size=shape + (2,)).astype(
            np.float32)).to(device)
        logit = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)
        for epilogue, mask_is_logit in modes:
            mask = logit if mask_is_logit else torch.sigmoid(logit)
            kw = dict(mask_is_logit=mask_is_logit, epilogue=epilogue,
                      clf_w=-3.0, clf_b=0.5)
            worst = max(worst, compare(
                f"batched {epilogue:9s} logit={int(mask_is_logit)} {shape}",
                dk.detection_map(vec, mask, **kw),
                dk.detection_map_plain(vec, mask, **kw)))
    return worst


def main_path_kernel_times(device, seed: int):
    """Times at the launch the main path makes: the 8 TTA views of one
    HEIGHT x WIDTH scene from (3, 1024, 1024) head planes, DivClassifier
    epilogue, logit mask. Returns (device ms, host-paced ms, plain ms,
    bound ms)."""
    import torch

    from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk

    views = noisy_views(HEIGHT, WIDTH, 8, 1024, torch.Generator(
        device=device).manual_seed(seed + 1), device)
    hw = (HEIGHT, WIDTH)
    kw = dict(mask_is_logit=True, epilogue="div_clf", clf_w=-3.0, clf_b=0.5)
    k_ms = cuda_time_ms(lambda: dk.detection_map_tta(views, hw, **kw),
                        reps=50)
    host_ms = host_paced_ms(lambda: dk.detection_map_tta(views, hw, **kw))
    p_ms = cuda_time_ms(lambda: dk.detection_map_tta_plain(views, hw, **kw),
                        reps=5)
    bound = stencil_bound_ms(sum(v.crop[0] * v.crop[1] for v in views),
                             HEIGHT * WIDTH)
    return k_ms, host_ms, p_ms, bound


def seeded_weights_(module, generator) -> None:
    """Fill every parameter of ``module`` from ``generator``: He-scaled
    normal conv kernels, other weights ``1 + 0.1 z``, biases ``0.1 z``;
    BatchNorm keeps identity statistics."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=generator, dtype=torch.float32)
            if p.ndim == 4:
                p.copy_(z * (2.0 / (p.shape[1] * p.shape[2] * p.shape[3]))
                        ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)


def _build_model(cls, kind, name, device, gen, config=None):
    """``name``'s network from its stored config (or ``config``): the
    trained checkpoint for ``CHECKPOINTED_MODEL``, else weights drawn from
    ``gen``."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import MODELS_ROOT

    model_dir = os.path.join(MODELS_ROOT, kind, name)
    if name == CHECKPOINTED_MODEL:
        return cls.from_model_dir(model_dir, device), "trained checkpoint " \
            "via the msgpack reader"
    if config is None:
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
    model = cls(config, device=device)
    for module in (model.net, getattr(model, "div_clf", None)):
        if module is not None:
            seeded_weights_(module, gen)
    return model, "weights drawn from the seed"


def load_models(config, device, seed: int):
    """The flagship's PosNets and ShapeNet (see ``CHECKPOINTED_MODEL``)."""
    import torch

    from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
        PosNetModel,
    )
    from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
        ShapeNetModel,
    )

    gen = torch.Generator().manual_seed(seed)
    names = config["dataset"]["position_model"]
    wanted = [(PosNetModel, "posnet", n) for n in names]
    wanted.append((ShapeNetModel, "shapenet", config["dataset"]["shape_model"]))
    models = []
    for cls, kind, name in wanted:
        model, source = _build_model(cls, kind, name, device, gen)
        print(f"  {kind} {name}: hidden_dims "
              f"{model.config['model']['hidden_dims']}, {source} {seed}",
              flush=True)
        models.append(model)
    if CHECKPOINTED_MODEL not in names:
        raise AssertionError(f"{MPP_CONFIG} no longer uses "
                             f"{CHECKPOINTED_MODEL}")
    return models[:-1], models[-1]


def mpp_config_copy(root: str, base: str, name: str, store: bool = True,
                    blocks=None, seg_super: int = 341, **inference) -> str:
    """``model_configs/mpp/<base>.json`` for the synthetic dataset under
    ``root``, named ``name``, with the depth cut -- a ``max_iter`` stopping
    block of one segment per scene, of ``seg_super`` supersteps (the
    configs' own 341, or a shorter segment) -- the config's blocks
    updated from ``blocks`` (block name -> entries) and its ``inference``
    block from ``inference``. With ``store``, the model store gets
    ``base``'s trained calibration and combiner. Returns the config's
    path."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import (
        MODELS_ROOT,
        load_mpp_config,
        rjmcmc_params_from_config,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        scene_shape_bucket,
        superstep_budget,
    )

    cfg = load_mpp_config(base)
    h, w = scene_shape_bucket(HEIGHT, WIDTH)
    budget = superstep_budget(h, w, rjmcmc_params_from_config(cfg),
                              cfg["inference"].get("segment_size", 4096))
    assert budget.seg_super == 341, budget
    cfg["model_name"] = name
    cfg["dataset"]["dataset"] = "synth_smoke"
    if seg_super != budget.seg_super:
        cfg["inference"]["segment_size"] = seg_super * budget.ms_tile
    cfg["inference"]["rjmcmc_params"]["stopping"] = {
        "kind": "max_iter", "max_iter": seg_super * budget.mps}
    cfg["inference"].update(inference)
    for block, entries in (blocks or {}).items():
        cfg[block].update(entries)
    if store:
        store_dir = os.path.join(root, "models", "mpp", name)
        os.makedirs(store_dir)
        for f in ("calibration.json", "energy_combination_model.json"):
            shutil.copy(os.path.join(MODELS_ROOT, "mpp", base, f), store_dir)
        with open(os.path.join(store_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
    path = os.path.join(root, name + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def cli_workspace(root: str, config, device, seed: int) -> str:
    """Phase 6's dataset, model store and config under ``root``; returns
    the config's path."""
    import torch

    from mpp_cnn_rs_object_detection_torch.data.synth import (
        make_synth_dataset,
    )
    from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
        PosNetModel,
    )
    from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
        ShapeNetModel,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import (
        MODELS_ROOT,
        REPO_ROOT,
    )

    data, models = os.path.join(root, "data"), os.path.join(root, "models")
    with open(os.path.join(root, "paths_config.json"), "w") as f:
        json.dump({"dataset_path": [data], "model_path": [models]}, f)
    make_synth_dataset(name="synth_smoke", n_items=CLI_SCENES,
                       shape=(HEIGHT, WIDTH), n_rect=OBJECTS, seed=seed,
                       base_dir=data)

    def model_config(kind, name):
        # the config the CLI resolves the name to (model_configs/)
        with open(os.path.join(REPO_ROOT, "model_configs", kind,
                               name + ".json")) as f:
            return json.load(f)

    shape_name = config["dataset"]["shape_model"]
    shape_pos = model_config("shapenet", shape_name)["inference"]["pos_model"]
    gen = torch.Generator().manual_seed(seed)
    wanted = [(PosNetModel, "posnet", n)
              for n in config["dataset"]["position_model"] + [shape_pos]]
    wanted.append((ShapeNetModel, "shapenet", shape_name))
    for cls, kind, name in wanted:
        dst = os.path.join(models, kind, name)
        os.makedirs(dst)
        cfg = model_config(kind, name)
        with open(os.path.join(dst, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
        if name == CHECKPOINTED_MODEL:
            os.symlink(os.path.join(MODELS_ROOT, kind, name, "model.msgpack"),
                       os.path.join(dst, "model.msgpack"))
            source = "trained checkpoint, linked"
        else:
            model, source = _build_model(cls, kind, name, device, gen, cfg)
            model.save_path = dst
            model.save()
            source += f" {seed}, written by the msgpack writer"
        print(f"  store {kind}/{name}: {source}", flush=True)
    return mpp_config_copy(root, config["model_name"], config["model_name"])


@contextlib.contextmanager
def inside(root: str):
    """Run from ``root``, whose ``paths_config.json`` the port reads."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        yield
    finally:
        os.chdir(cwd)


def run_procedure(root: str, argv, device):
    """The port's command line with ``argv`` from ``root``; returns what
    it returned and the seconds it took."""
    from mpp_cnn_rs_object_detection_torch.__main__ import main as cli_main

    with inside(root):
        t0 = time.perf_counter()
        out = cli_main(list(argv), device=device)
        return out, time.perf_counter() - t0


def run_cli(root: str, cfg_path: str, device, procedure: str = "infereval"):
    """``-p procedure -m mpp -c cfg_path`` from ``root``; returns the model
    and the seconds it took."""
    return run_procedure(root, ["-p", procedure, "-m", "mpp", "-c",
                                cfg_path], device)


def check_exports(root: str, model, name: str) -> dict:
    """Both scenes' result pickles, their detection and GT overlays (RGB
    PNGs of the scene's shape), ``dota/`` and ``dota-SV/`` with every
    metrics JSON, finite APs, and no chain checkpoint left. Returns the
    APs."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.utils.config import (
        get_inference_path,
    )
    from mpp_cnn_rs_object_detection_torch.utils.png import png_header

    with inside(root):
        results_dir = get_inference_path(name, "synth_smoke", "val")
    assert sorted(model.results) == list(range(CLI_SCENES)), model.results
    for i in range(CLI_SCENES):
        assert os.path.exists(os.path.join(results_dir,
                                           f"{i:04}_results.pkl"))
        for kind in ("detection", "gt"):
            shape = png_header(os.path.join(results_dir,
                                            f"{i:04}_{kind}.png"))
            assert shape == (HEIGHT, WIDTH, 3), (kind, shape)
        for kind in ("chains", "tiles"):
            assert not os.path.exists(os.path.join(
                results_dir, f"{i:04}_{kind}.ck.npz")), kind
    assert not os.path.exists(os.path.join(results_dir,
                                           "batched_chains.ck.npz"))
    aps = {}
    for postfix in ("", "-SV"):
        dota = os.path.join(results_dir, "dota" + postfix)
        for sub in ("det/vehicle.txt", "imageSet.txt") + tuple(
                f"gt/{i:04}.txt" for i in range(CLI_SCENES)):
            assert os.path.exists(os.path.join(dota, sub)), sub
        for iou in IOUS:
            with open(os.path.join(dota, f"metrics{iou:.2f}.json")) as f:
                aps[postfix, iou] = json.load(f)["vehicle"]["ap"]
        check_pr_curves(dota)
    assert np.isfinite(list(aps.values())).all(), aps
    return aps


def check_pr_curves(dota: str) -> None:
    """The 5 PR-curve PNGs of an eval, at the JAX package's canvas."""
    from mpp_cnn_rs_object_detection_torch.utils.png import png_header

    for iou in IOUS:
        shape = png_header(os.path.join(dota, f"prec_rec_curve_{iou:.2f}.png"))
        if shape != PR_CURVE_SHAPE:
            raise AssertionError(f"{dota}: PR curve at {iou}: {shape}")


def ap_line(model, aps) -> str:
    n_det = sum(len(r.scores) for r in model.results.values())
    return (f"{n_det} detections over {CLI_SCENES} scenes; AP@0.05 "
            f"{aps['', 0.05]:.4f} (SV {aps['-SV', 0.05]:.4f}), AP@0.5 "
            f"{aps['', 0.5]:.4f} (SV {aps['-SV', 0.5]:.4f})")


def cli_phase(root: str, config, device, seed: int) -> int:
    """Phase 6; returns the detection-map kernel launches it counted."""
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )

    t0 = time.perf_counter()
    cfg_path = cli_workspace(root, config, device, seed)
    print(f"  workspace (dataset, model store, config): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    dk.KERNEL.launches = 0
    model, t_cli = run_cli(root, cfg_path, device)
    launches = dk.KERNEL.launches
    sec = model.seconds
    print(f"  CLI -p infereval -m mpp: {t_cli:.3f} s; "
          f"ensure_cnn_inference {sec['cnn'] + sec['host']:.3f} s "
          f"(U-Net + kernel {sec['cnn']:.3f} s, host {sec['host']:.3f} s"
          f" of which distance NMS {sec['nms']:.3f} s and ShapeNet mark "
          f"decoding {sec['decode']:.3f} s); load maps "
          f"{sec['load']:.3f} s; chains (one batched program) "
          f"{sec['chain']:.3f} s; export {sec['export']:.3f} s + eval "
          f"{sec['eval']:.3f} s = {sec['export'] + sec['eval']:.3f} s",
          flush=True)
    n_pos = len(config["dataset"]["position_model"]) + 1
    if launches != n_pos * CLI_SCENES:
        raise AssertionError(f"expected {n_pos * CLI_SCENES} detection-"
                             f"map launches, counted {launches}")
    stops = {(r.supersteps, r.stopped) for r in model.results.values()}
    if stops != {(341, True)}:
        raise AssertionError(f"the batch did not stop jointly after its "
                             f"first segment: {stops}")
    aps = check_exports(root, model, config["model_name"])
    print(f"  {launches} detection-map launches ({n_pos} per scene); both "
          f"scenes stopped at superstep 341; {ap_line(model, aps)}",
          flush=True)
    return launches


def extensions_phase(root: str, device) -> None:
    """Phase 7: the trained extension config on phase 6's workspace."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import (
        load_mpp_config,
    )
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )

    base = load_mpp_config(EXT_CONFIG)["inference"]
    on = {k: base[k] for k in ("refine_centers", "score_map_blend",
                               "backfill_threshold")}
    assert on["refine_centers"] and on["score_map_blend"] > 0 \
        and on["backfill_threshold"] > 0, on
    cfg_path = mpp_config_copy(root, EXT_CONFIG, EXT_CONFIG)
    dk.KERNEL.launches = 0
    model, t_cli = run_cli(root, cfg_path, device)
    sec = model.seconds
    stops = {(r.supersteps, r.stopped) for r in model.results.values()}
    if stops != {(341, True)}:
        raise AssertionError(f"{EXT_CONFIG}: the batch did not stop "
                             f"jointly after its first segment: {stops}")
    aps = check_exports(root, model, EXT_CONFIG)
    print(f"  CLI -c {EXT_CONFIG} ({on}): {t_cli:.3f} s; load maps "
          f"{sec['load']:.3f} s; chains {sec['chain']:.3f} s; export "
          f"(refine, blend, backfill) {sec['export']:.3f} s; eval "
          f"{sec['eval']:.3f} s; detection-map launches "
          f"{dk.KERNEL.launches} (CNN results reused); {ap_line(model, aps)}",
          flush=True)


def restarts_phase(root: str, device) -> None:
    """Phase 8: restarts and polish on the per-image path."""
    import numpy as np

    name = f"{EXT_CONFIG}_restarts"
    cfg_path = mpp_config_copy(root, EXT_CONFIG, name, restarts=RESTARTS,
                               polish_steps=POLISH_STEPS, seg_super=CUT_SEG)
    model, t_cli = run_cli(root, cfg_path, device)
    sec = model.seconds
    aps = check_exports(root, model, name)
    for pid, r in sorted(model.results.items()):
        u = np.asarray(r.lane_energies)
        u_pre, u_post = r.polish_energies
        print(f"  scene {pid}: lane energies {u.tolist()} -> lane "
              f"{r.best_lane}; polish {POLISH_STEPS} steps U {u_pre:.4f} -> "
              f"{u_post:.4f} in {r.seconds['polish']:.3f} s; "
              f"{r.supersteps} supersteps, chain {r.seconds['chain']:.3f} s "
              f"({1e3 * r.seconds['chain'] / r.supersteps:.3f} ms/superstep"
              f" for {RESTARTS} lanes)", flush=True)
        if len(u) != RESTARTS or r.best_lane != int(np.argmin(u)):
            raise AssertionError(f"scene {pid}: restart lanes {u}, kept "
                                 f"{r.best_lane}")
        if not u_post <= u_pre:
            raise AssertionError(f"scene {pid}: polish raised U "
                                 f"{u_pre} -> {u_post}")
    print(f"  CLI -c {name} (restarts {RESTARTS}, polish_steps "
          f"{POLISH_STEPS}, per-image path): {t_cli:.3f} s; load maps "
          f"{sec['load']:.3f} s; chains + polish {sec['chain']:.3f} s; "
          f"export {sec['export']:.3f} s; eval {sec['eval']:.3f} s; "
          f"{ap_line(model, aps)}", flush=True)


def profiled(fn, top: int = 0):
    """One call of ``fn`` under ``torch.profiler``: (device kernel
    launches, device ms), and with ``top`` the ``top`` kernels by device
    time as (name, launches, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and "cuda" in str(e.device_type).lower()]
    totals = (sum(int(e.count) for e in kernels),
              sum(device_us(e) for e in kernels) / 1e3)
    if not top:
        return totals
    kernels.sort(key=device_us, reverse=True)
    return totals + ([(e.key[:90], int(e.count), device_us(e) / 1e3)
                      for e in kernels[:top]],)


def train_batch_probe(model, device, seed: int) -> dict:
    """One batch of the ordering criterion at the trained config's widths,
    alone: the kernel launches and device time of one laned move (the
    batch's B x S lanes), the batch's perturbation and vector seconds, and
    the peak device memory of its vectors (GT and perturbed configurations
    in one laned call)."""
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp import kernels
    from mpp_cnn_rs_object_detection_torch.mpp import train_weights as ttw
    from mpp_cnn_rs_object_detection_torch.mpp.perturbations import (
        sample_lanes,
    )

    oc = model.config["ordering_criterion"]
    n_samples = oc["samples_per_image"]
    batch = model.config["data_loader"]["batch_size"]
    crops = model._sample_crops("train", batch)
    setup = model.energy_setup
    maps_b, kd_b, gt_b = ttw.prepare_batch(crops, setup, model.capacity,
                                           device)
    n_moves = max(1, int(oc["neg_pert_config"]["iter_per_point"] * max(
        1, max(len(c.gt_centers) for c in crops))))
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes = sample_lanes(gt_b, n_samples)
    lanes = kernels.apply_proposal(lanes, kernels.sample_proposal(
        gen, lanes, kd_b))  # warm
    launches, dev_ms = profiled(lambda: kernels.apply_proposal(
        lanes, kernels.sample_proposal(gen, lanes, kd_b)))
    seconds = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vecs = ttw.ordering_vectors(gen, maps_b, kd_b, gt_b, setup.spec, n_moves,
                                n_samples, ttw._Stages(seconds, device))
    peak = torch.cuda.max_memory_allocated()
    assert all(bool(torch.isfinite(v).all()) for v in vecs[::2])
    return {"lanes": tuple(lanes.alive.shape[:2]), "n_moves": n_moves,
            "capacity": model.capacity, "launches_per_move": launches,
            "device_ms_per_move": dev_ms,
            "perturb_s": seconds["perturb"], "vectors_s": seconds["vectors"],
            "peak_gb": peak / 1e9, "peak_over_base_gb": (peak - base) / 1e9,
            "pairs": vecs[2].shape[0] * (vecs[2].shape[1] + 1)
            * model.capacity ** 2}


def train_phase(root: str, config, device, seed: int) -> int:
    """Phase 9: ``-p train -m mpp`` on a copy of the flagship config (depth
    cut: ``TRAIN_EPOCHS`` epochs of ``TRAIN_CROPS`` crops), then ``-p
    infereval`` with what it trained. Returns the detection-map launches
    of the train (the train subset's CNN inference)."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )

    name = f"{MPP_CONFIG}_trained"
    cfg_path = mpp_config_copy(root, MPP_CONFIG, name, store=False, blocks={
        "ordering_criterion": {"n_epochs": TRAIN_EPOCHS,
                               "n_crops": TRAIN_CROPS}})
    base = config["ordering_criterion"]
    print(f"  train config: n_epochs {TRAIN_EPOCHS} of {base['n_epochs']}, "
          f"n_crops {TRAIN_CROPS} of 64 (the depth cut); samples_per_image "
          f"{base['samples_per_image']}, batch_size "
          f"{config['data_loader']['batch_size']}, capacity "
          f"{config['capacity']}, patch_size "
          f"{config['dataset']['patch_size']}, iter_per_point "
          f"{base['neg_pert_config']['iter_per_point']}", flush=True)
    dk.KERNEL.launches = 0
    model, t_train = run_cli(root, cfg_path, device, "train")
    launches = dk.KERNEL.launches
    n_pos = len(config["dataset"]["position_model"]) + 1
    if launches != n_pos * CLI_SCENES:
        raise AssertionError(f"train: expected {n_pos * CLI_SCENES} "
                             f"detection-map launches, counted {launches}")
    store = os.path.join(root, "models", "mpp", name)
    with open(os.path.join(store, "energy_combination_model.json")) as f:
        trained = json.load(f)
    with open(os.path.join(store, "calibration.json")) as f:
        cal = json.load(f)
    losses = model.logger.log["loss"]
    weights = np.asarray(trained["params"]["weights"])
    moved = max(float(np.abs(weights - 1.0).max()),
                abs(trained["params"]["bias"]))
    print(f"  -p train: {t_train:.3f} s; combiner {trained['kind']} "
          f"version {trained['version']}, weights moved by up to "
          f"{moved:.4f} from their initial ones; losses {losses}; "
          f"calibration {cal}", flush=True)
    if trained["version"] != 2 or trained["kind"] != "logistic":
        raise AssertionError(f"trained combiner {trained}")
    if len(losses) != TRAIN_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    if not moved > 0.0:
        raise AssertionError("the logistic weights did not move")
    sec = model.train_seconds
    print("  train seconds by stage: train-subset CNN inference "
          f"{sec['cnn'] + sec['host']:.3f} (U-Net + kernel {sec['cnn']:.3f},"
          f" host {sec['host']:.3f}); loading and cropping "
          f"{sec['crops']:.3f}; calibration {sec['calibrate']:.3f}; batch "
          f"maps {sec['prepare']:.3f}; perturbations {sec['perturb']:.3f}; "
          f"vectors {sec['vectors']:.3f}; steps {sec['steps']:.3f}; "
          f"attribution figure (its 8 crops included) "
          f"{sec['attribution']:.3f}", flush=True)
    check_attribution(model, store)
    with inside(root):
        probe = train_batch_probe(model, device, seed)
    print(f"  one batch alone: {probe}", flush=True)
    dk.KERNEL.launches = 0
    model, t_inf = run_cli(root, cfg_path, device)
    stops = {(r.supersteps, r.stopped) for r in model.results.values()}
    if stops != {(341, True)}:
        raise AssertionError(f"{name}: the batch did not stop jointly "
                             f"after its first segment: {stops}")
    aps = check_exports(root, model, name)
    sec = model.seconds
    print(f"  -p infereval with the trained combiner: {t_inf:.3f} s; chains "
          f"{sec['chain']:.3f} s; eval {sec['eval']:.3f} s; detection-map "
          f"launches {dk.KERNEL.launches} (CNN results reused); "
          f"{ap_line(model, aps)}", flush=True)
    return launches


def check_attribution(model, store: str) -> None:
    """Phase 9: ``figures/energy_attribution.png`` written; the trained
    combiner's attribution on the card (``model.attribution``) against
    the same on the CPU within ``ATTRIBUTION_TOL``, and complete: each
    row's sum within ``COMPLETENESS_RTOL`` |f(x) - f(0)| +
    ``COMPLETENESS_ATOL`` of f(x) - f(0)."""
    import numpy as np
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp.combinators import combine
    from mpp_cnn_rs_object_detection_torch.mpp.figures import (
        energy_attribution,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import to_device
    from mpp_cnn_rs_object_detection_torch.utils.png import png_header

    path = os.path.join(store, "figures", "energy_attribution.png")
    if model.attribution is None or not os.path.exists(path):
        raise AssertionError("-p train wrote no energy attribution figure")
    vec, card = (model.attribution[k] for k in ("vectors", "attributions"))
    cpu_comb = to_device(model.energy_model, "cpu")
    t0 = time.perf_counter()
    cpu = energy_attribution(cpu_comb, vec)
    t_cpu = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    x = torch.as_tensor(vec)
    gap = (combine(cpu_comb, x) - combine(cpu_comb, torch.zeros_like(x))
           ).numpy()
    off = np.abs(card.sum(-1) - gap)
    slack = COMPLETENESS_RTOL * np.abs(gap) + COMPLETENESS_ATOL - off
    print(f"  energy attribution: {vec.shape[0]} GT vectors of "
          f"{vec.shape[1]} terms, figure {png_header(path)}; card vs CPU "
          f"max abs {err:.3e} (tol {ATTRIBUTION_TOL}; CPU {t_cpu:.3f} s); "
          f"completeness: |row sum - (f(x) - f(0))| max {off.max():.3e}, "
          f"least slack {slack.min():.3e}", flush=True)
    if not err <= ATTRIBUTION_TOL:
        raise AssertionError(f"attribution card vs CPU off by {err}")
    if not (slack >= 0).all():
        raise AssertionError(f"attribution not complete: {off.max()}")


def manual_phase(root: str, config, device) -> None:
    """Phase 10: the legacy manual mode, a copy of ``MANUAL_CONFIG`` on the
    flagship's CNNs (phases 6 and 9's results reused): ``-p infereval``
    calibrates, builds ``hierarchical_fixed`` and runs the exact chain of
    each scene for one segment (the per-image path)."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )

    name = f"{MANUAL_CONFIG}_flagship_cnns"
    cfg_path = mpp_config_copy(root, MANUAL_CONFIG, name, store=False,
                               blocks={"dataset": {
                                   k: config["dataset"][k] for k in
                                   ("position_model", "shape_model")}},
                               seg_super=CUT_SEG)
    dk.KERNEL.launches = 0
    model, t_cli = run_cli(root, cfg_path, device)
    comb = model.energy_model
    sums = {k: float(comb.params[k].sum()) for k in
            ("data_weight", "prior_weight", "data_prior_weight")}
    with open(os.path.join(root, "models", "mpp", name,
                           "calibration.json")) as f:
        cal = json.load(f)
    print(f"  calibration {cal}; combiner {comb.kind}, weight sums {sums}",
          flush=True)
    if comb.kind != "hierarchical_fixed" or any(
            abs(v - 1.0) > 1e-6 for v in sums.values()):
        raise AssertionError(f"manual combiner {comb.kind} {sums}")
    if not np.isfinite(cal["detection_threshold"]):
        raise AssertionError(f"detection threshold {cal}")
    stops = {(r.supersteps, r.stopped) for r in model.results.values()}
    if stops != {(CUT_SEG, True)}:
        raise AssertionError(f"{name}: not one segment per scene: {stops}")
    aps = check_exports(root, model, name)
    sec, tsec = model.seconds, model.train_seconds
    caps = [r.capacity for r in model.results.values()]
    print(f"  CLI -c {name}: {t_cli:.3f} s; calibration crops "
          f"{tsec['crops']:.3f} s, calibration {tsec['calibrate']:.3f} s; "
          f"load maps {sec['load']:.3f} s; chains {sec['chain']:.3f} s "
          f"(capacities {caps}); eval {sec['eval']:.3f} s; detection-map "
          f"launches {dk.KERNEL.launches} (CNN results reused); "
          f"{ap_line(model, aps)}", flush=True)


def check_carried(chain, setup, comb, what: str) -> tuple:
    """A chain's carried cache and energy against a rebuild on its final
    state; returns (carried energy, rebuilt energy)."""
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
        build_cache,
        energy_from_cache,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import expand_lanes

    state1, maps1 = expand_lanes(chain.state, 1), expand_lanes(chain.maps, 1)
    fresh = build_cache(state1, maps1, setup.spec)
    alive = chain.state.alive
    pair = alive[:, None] & alive[None, :]
    for f in ("dist", "overlap", "align"):
        a, b = getattr(chain.cache, f)[pair], getattr(fresh, f)[0][pair]
        diff = float((a - b).abs().max()) if a.numel() else 0.0
        if diff > CACHE_TOL * max(1.0, float(b.abs().max()) if b.numel()
                                  else 1.0):
            raise AssertionError(f"{what}: carried cache {f} off by {diff}")
    energy = float(chain.energy)
    u_fresh = float(energy_from_cache(state1, maps1, setup.spec, comb,
                                      fresh)[0])
    if abs(u_fresh - energy) > 1e-3 * max(1.0, abs(u_fresh)):
        raise AssertionError(f"{what}: carried energy {energy} against "
                             f"{u_fresh} rebuilt")
    return energy, u_fresh


def sequential_step_probe(model, setup, comb, pid: int, device) -> dict:
    """One sequential step of a scene's tiles as lanes, alone: its kernel
    launches and device ms (``torch.profiler``), after two warm steps."""
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp.energies import (
        stack_param_dists,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.image_data import split_image
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
        build_cache,
        energy_from_cache,
        make_step_fn,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        pad_image_w_maps,
        tile_lanes,
    )

    patch = model.config["dataset"].get("patch_size", 256)
    data = pad_image_w_maps(model._load_image(pid, "val"), patch)
    data.param_dist_maps = stack_param_dists(data.param_dist_maps,
                                             device=device)
    data.detection_map = torch.as_tensor(data.detection_map, device=device)
    patches = split_image(data, patch, 32)
    maps, kd, state = tile_lanes(patches, setup, model.capacity, "naive",
                                 False, device)
    step = make_step_fn(maps, setup.spec, comb, kd, 0.999, 0.0)
    cache = build_cache(state, maps, setup.spec)
    carry = (state, cache, energy_from_cache(state, maps, setup.spec, comb,
                                             cache), 1.0)
    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(2):
        carry, _ = step(carry, gen)
    launches, dev_ms = profiled(lambda: step(carry, gen))
    return {"tiles": len(patches), "launches_per_step": launches,
            "device_ms_per_step": dev_ms}


def tiled_phase(root: str, config, device) -> None:
    """Phase 11: the tiled scene mode of a manual config on the flagship's
    CNNs (phases 6 and 9's results reused), its chains depth-cut; then a
    killed scene's resume from its checkpoint."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model
    from mpp_cnn_rs_object_detection_torch.mpp.scene import run_tiled_scene
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )

    name = f"{TILED_CONFIG}_flagship_cnns"
    full = mpp_model.rjmcmc_params_from_config(
        mpp_model.load_mpp_config(TILED_CONFIG))
    cfg_path = mpp_config_copy(root, TILED_CONFIG, name, store=False,
                               blocks={"dataset": {
                                   k: config["dataset"][k] for k in
                                   ("position_model", "shape_model")}},
                               segment_size=TILED_SEGMENT)
    with open(cfg_path) as f:
        cfg = json.load(f)
    rj = cfg["inference"]["rjmcmc_params"]
    rj.pop("stopping")  # exact segments only
    rj["burn_in"] = TILED_BURN_IN
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    params = mpp_model.rjmcmc_params_from_config(cfg)
    patch = cfg["dataset"].get("patch_size", 256)
    # the tile grid of split_image (32 px overlap): 25 tiles at 958x926
    n_tiles = math.prod(-(-max(n, patch) // (patch - 32))
                        for n in (HEIGHT, WIDTH))
    dk.KERNEL.launches = 0
    model, t_cli = run_cli(root, cfg_path, device)
    aps = check_exports(root, model, name)
    results = [model.results[i] for i in sorted(model.results)]
    for r in results:
        if (r.n_tiles, r.supersteps, r.samples) != (
                n_tiles, params.total_steps, 2):
            raise AssertionError(f"{name}: tiles {r.n_tiles}, steps "
                                 f"{r.supersteps} of {params.total_steps}, "
                                 f"samples {r.samples}")
        assert np.isfinite(r.scores).all() and (r.scores > 0).all()
    ms_step = [1e3 * r.seconds["chain"] / r.supersteps for r in results]
    with inside(root):
        probe = sequential_step_probe(model, model.energy_setup,
                                      model.energy_model, 0, device)
    sec = model.seconds
    print(f"  CLI -c {name} (tiled, sequential, manual; burn_in "
          f"{TILED_BURN_IN} of {full.burn_in}, segments of {TILED_SEGMENT}):"
          f" {t_cli:.3f} s; load maps {sec['load']:.3f} s; chains "
          f"{sec['chain']:.3f} s; eval {sec['eval']:.3f} s; "
          f"{results[0].n_tiles} tiles per scene (K = {model.capacity}), "
          f"{params.total_steps} steps, {results[0].samples} samples "
          f"collected per tile; detection-map launches {dk.KERNEL.launches} "
          f"(CNN results reused); {ap_line(model, aps)}", flush=True)
    print(f"  sequential step: {ms_step[0]:.3f} and {ms_step[1]:.3f} ms per "
          f"step of {probe['tiles']} tile lanes (chain seconds / steps); one"
          f" step alone: {probe['launches_per_step']} launches, "
          f"{probe['device_ms_per_step']:.3f} device ms; projected full "
          f"budget ({full.total_steps} steps): "
          f"{np.mean(ms_step) * full.total_steps / 1e3:.1f} s per scene",
          flush=True)
    # a killed scene (one segment) resumes from its checkpoint to its
    # uninterrupted run's detections
    ck = os.path.join(root, "tiled_resume.ck.npz")
    short = dataclasses.replace(params, n_steps=RESUME_BURN_IN)
    kw = dict(seed=0, patch_size=patch, capacity=model.capacity,
              segment_size=RESUME_SEGMENT, device=device)
    with inside(root):
        def run(**extra):
            return run_tiled_scene(model._load_image(0, "val"),
                                   model.energy_setup, model.energy_model,
                                   short, **kw, **extra)

        whole = run()
        killed = run(checkpoint_path=ck, max_segments=1)
        written = os.path.exists(ck)
        resumed = run(checkpoint_path=ck)
    if killed is not None or not written or os.path.exists(ck) or \
            resumed.supersteps != short.total_steps:
        raise AssertionError(f"tiled resume: killed {killed}, checkpoint "
                             f"written {written}, left {os.path.exists(ck)}")
    for f in ("centers", "marks", "scores"):
        if not np.array_equal(getattr(resumed, f), getattr(whole, f)):
            raise AssertionError(f"tiled resume: {f} differ from the "
                                 "uninterrupted run")
    print(f"  tiled checkpoint: a run of {short.total_steps} steps killed "
          f"after its first segment of {RESUME_SEGMENT} wrote it and resumed"
          f" to step {resumed.supersteps}, then removed it; the resumed "
          f"centers, marks and scores ({len(resumed.centers)} detections, "
          f"{resumed.samples} samples) equal the uninterrupted run's",
          flush=True)


def superstep_probe(setup, comb, capacity: int, data, moves: dict,
                    device) -> dict:
    """One exact superstep of ``data`` alone with the ``moves`` flags: its
    kernel launches and device ms, after two warm supersteps."""
    import torch

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
        state_from_arrays,
    )

    target = scene.scene_shape_bucket(*data.shape)
    data, c0, m0, _ = scene._prepare(data, setup, target, "naive", device)
    cap = scene._capacity(*data.shape, capacity, len(c0))
    maps = expand_lanes(setup.make_maps(data), 1)
    kd = expand_lanes(setup.make_kernel_data(data, max(1, len(c0))), 1)
    state = expand_lanes(state_from_arrays(c0[:cap], m0[:cap], capacity=cap,
                                           device=device), 1)
    h, w = data.shape
    step = make_parallel_step(maps, setup.spec, comb, kd, 0.999, 0.0,
                              max(h, w) // (2 * CELL) + 1, **moves)
    cache = build_cache(state, maps, setup.spec)
    carry = (state, cache, energy_from_cache(state, maps, setup.spec, comb,
                                             cache), 1.0)
    gens = [torch.Generator(device=device).manual_seed(0)]
    types = [torch.Generator().manual_seed(0)]
    for _ in range(2):
        carry, _ = step(carry, gens, types)
    launches, dev_ms = profiled(lambda: step(carry, gens, types))
    return {"launches": launches, "device_ms": dev_ms}


def split_merge_phase(root: str, config, device, inference, data) -> None:
    """Phase 12: the trained split/merge config in exact batched mode on
    the flagship's CNNs, one segment; then, on phase 3's scene with the
    flagship's model (a populated configuration), one in-memory segment
    with the split/merge pair and one with the switched move type, and
    one superstep of each move set alone."""
    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        run_exact_scene,
        superstep_budget,
    )

    name = f"{SPLIT_MERGE_CONFIG}_flagship_cnns"
    base = mpp_model.load_mpp_config(SPLIT_MERGE_CONFIG)
    assert base["inference"]["rjmcmc_params"]["superstep_split_merge"]
    cfg_path = mpp_config_copy(root, SPLIT_MERGE_CONFIG, name,
                               blocks={"dataset": {
                                   k: config["dataset"][k] for k in
                                   ("position_model", "shape_model")}},
                               seg_super=CUT_SEG)
    captured = []
    batched = mpp_model.run_exact_scenes_batched

    def keep(*a, **k):
        out = batched(*a, **k)
        captured.extend(out)
        return out

    mpp_model.run_exact_scenes_batched = keep
    try:
        model, t_cli = run_cli(root, cfg_path, device)
    finally:
        mpp_model.run_exact_scenes_batched = batched
    aps = check_exports(root, model, name)
    if len(captured) != CLI_SCENES:
        raise AssertionError(f"{name}: not one batch: {len(captured)}")
    for i, r in enumerate(captured):
        u, u_fresh = check_carried(r.chain, model.energy_setup,
                                   model.energy_model, f"{name} scene {i}")
        print(f"  scene {i}: {r.supersteps} supersteps, "
              f"{int(r.chain.state.n_points)} points at the end; accepted by"
              f" kind (rejected, birth, death, move, split, merge) "
              f"{r.accepted_by_kind}; carried energy {u:.4f} vs rebuilt "
              f"{u_fresh:.4f}", flush=True)
        if r.supersteps != CUT_SEG:
            raise AssertionError(f"{name} scene {i}: {r.supersteps} "
                                 "supersteps")
    sec = model.seconds
    print(f"  CLI -c {name} (exact, batched, split/merge, trained): "
          f"{t_cli:.3f} s; chains {sec['chain']:.3f} s; eval "
          f"{sec['eval']:.3f} s; {ap_line(model, aps)}", flush=True)
    # phase 3's scene, in memory, one segment with each new move set
    opts = mpp_model.chain_options(inference.config)
    opts["stopping"] = None
    opts["segment_size"] = SM_MEMORY_SEG * superstep_budget(
        *data.shape, inference.params).ms_tile
    kinds = {}
    for label, moves in (("split/merge", dict(split_merge=True)),
                         ("move switch", dict(move_switch=True))):
        r = run_exact_scene(data, inference.setup, inference.comb,
                            inference.params, seed=0, max_segments=1,
                            device=device, **dict(opts, **moves))
        u, u_fresh = check_carried(r.chain, inference.setup, inference.comb,
                                   label)
        kinds[label] = r.accepted_by_kind
        print(f"  {label} in memory: {r.supersteps} supersteps in "
              f"{r.seconds['chain']:.3f} s "
              f"({1e3 * r.seconds['chain'] / r.supersteps:.3f} "
              f"ms/superstep), {int(r.chain.state.n_points)} points; "
              f"accepted by kind {r.accepted_by_kind}; carried energy "
              f"{u:.4f} vs rebuilt {u_fresh:.4f}", flush=True)
    # the split/merge segment itself accepts both; the switched one, with
    # split/merge off, neither
    sm, sw = kinds["split/merge"], kinds["move switch"]
    if sm[4] <= 0 or sm[5] <= 0 or sw[4] or sw[5]:
        raise AssertionError(f"accepted splits and merges: {kinds}")
    probes = {label: superstep_probe(
        inference.setup, inference.comb, inference.config.get(
            "capacity", 256), data, moves, device)
        for label, moves in (("default", {}),
                             ("split_merge", dict(split_merge=True)),
                             ("move_switch", dict(move_switch=True)))}
    base_l = max(1, probes["default"]["launches"])
    print("  one superstep of phase 3's scene alone: " + "; ".join(
        f"{k} {v['launches']} launches ({v['launches'] / base_l:.3f}x), "
        f"{v['device_ms']:.3f} device ms" for k, v in probes.items()),
        flush=True)


def lane_phase(inference, data, seed: int) -> None:
    """Phase 4, second part: the scene as B = 1 and B = 2 lanes of one
    program, one segment each."""
    import numpy as np
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import (
        chain_options,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        run_exact_scenes_batched,
    )

    def run(n_lanes, segment_size=None):
        kw = chain_options(inference.config)
        if segment_size is not None:
            kw["segment_size"] = segment_size
        torch.cuda.synchronize()
        out = run_exact_scenes_batched(
            [data] * n_lanes, inference.setup, inference.comb,
            inference.params, seeds=[seed + i for i in range(n_lanes)],
            max_segments=1, device=inference.device, **kw)
        torch.cuda.synchronize()
        return out

    one = run(1)[0]
    two = run(2)
    ms = [1e3 * r.seconds["chain"] / r.supersteps for r in (one, two[0])]
    print(f"  lanes: B = 1 {ms[0]:.3f} ms/superstep, B = 2 {ms[1]:.3f} "
          f"ms/superstep ({ms[1] / ms[0]:.3f}x) over {one.supersteps} "
          f"supersteps", flush=True)
    lane0 = two[0]
    same = (np.array_equal(one.centers, lane0.centers)
            and np.array_equal(one.marks, lane0.marks)
            and np.array_equal(one.scores, lane0.scores))
    if same:
        print(f"  lane check: lane 0 of B = 2 identical to B = 1 "
              f"({len(one.centers)} detections, energy "
              f"{float(one.chain.energy):.4f})", flush=True)
        return
    # the first superstep of both, from the same draws
    s1 = run(1, segment_size=12)[0].chain.state
    s2 = run(2, segment_size=12)[0].chain.state
    if not torch.equal(s1.alive, s2.alive):
        raise AssertionError("lane 0 of B = 2: another accept set in the "
                             "first superstep than B = 1")
    for f in ("xy", "marks"):
        err = float((getattr(s1, f) - getattr(s2, f)).abs().max())
        if err > FIRST_STEP_TOL:
            raise AssertionError(f"lane 0 of B = 2: first superstep {f} off "
                                 f"by {err}")
    e1, e2 = float(one.chain.energy), float(lane0.chain.energy)
    if abs(e1 - e2) > CHAIN_ENERGY_RTOL * abs(e1):
        raise AssertionError(f"lane 0 of B = 2: energy {e2} against {e1}")
    print(f"  lane check: not identical after {one.supersteps} supersteps "
          f"(the card's reductions differ in the last bit between the two "
          f"shapes); the first superstep's accept set agrees and its states "
          f"within {FIRST_STEP_TOL}; energies {e1:.4f} and {e2:.4f} within "
          f"{CHAIN_ENERGY_RTOL:.0%}", flush=True)


def cnn_workspace(root: str, seed: int) -> dict:
    """Phase 13's dataset and depth-cut config copies under ``root`` (whose
    ``paths_config.json`` phase 6 wrote); returns {kind: config}."""
    from mpp_cnn_rs_object_detection_torch.data.synth import (
        make_synth_dataset,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import REPO_ROOT

    data = os.path.join(root, "data")
    # make_synth_dataset writes as many val scenes as train scenes: keep
    # the first CLI_SCENES
    make_synth_dataset(name="synth_cnn", n_items=CNN_TRAIN_SCENES,
                       shape=(CNN_SCENE, CNN_SCENE),
                       n_rect=CNN_OBJECTS + CNN_OBJECTS // 20, seed=seed,
                       base_dir=data)
    val = os.path.join(data, "synth_cnn", "val")
    for sub, ext in (("images", "png"), ("annotations", "pkl"),
                     ("metadata", "json")):
        for i in range(CLI_SCENES, CNN_TRAIN_SCENES):
            os.remove(os.path.join(val, sub, f"{i:04}.{ext}"))
    configs = {}
    for kind, base in CNN_CONFIGS.items():
        with open(os.path.join(REPO_ROOT, "model_configs", kind,
                               base + ".json")) as f:
            cfg = json.load(f)
        cfg["model_name"] = f"{base}_smoke"
        dl = cfg["data_loader"]
        dl["dataset"] = "synth_cnn"
        dl["dataset_update_interval"] = CNN_CUT["dataset_update_interval"]
        dl["patch_maker_params"].update(n_patches=CNN_CUT["n_patches"],
                                        val_patches=CNN_CUT["val_patches"])
        cfg["trainer"]["n_epochs"] = CNN_CUT["n_epochs"]
        configs[kind] = cfg
    return configs


def run_cnn_cli(root: str, kind: str, cfg: dict, device, procedure: str,
                *flags):
    """``-p procedure -m kind`` on ``cfg`` (written to ``root``) from
    ``root``; returns the model and the seconds it took."""
    from mpp_cnn_rs_object_detection_torch.__main__ import main as cli_main

    path = os.path.join(root, cfg["model_name"] + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    with inside(root):
        t0 = time.perf_counter()
        model = cli_main(["-p", procedure, "-m", kind, "-c", path, *flags],
                         device=device)
        return model, time.perf_counter() - t0


def check_cnn_training(model, kind: str, seconds: float) -> None:
    """Finite losses, a last epoch whose mean train loss is below the
    first's; prints the epochs' and the stack builds' seconds."""
    import numpy as np

    log = model.logger.log
    losses = np.asarray(log["train_loss"] + log["val_loss"])
    pm = model.config["data_loader"]["patch_maker_params"]
    b = model.batch_size
    per_epoch = (pm["n_patches"] // b + max(pm["val_patches"], 64) // b) * b
    rates = [per_epoch / s for s in model.epoch_seconds]
    print(f"  -p train -m {kind} ({model.config['model_name']}): "
          f"{seconds:.3f} s; epochs {log['epoch']}; train loss "
          f"{log['train_loss']}; val loss {log['val_loss']}; seconds per "
          f"epoch {model.epoch_seconds} ({rates} train + val "
          f"patches/s); host seconds of build_patch_stack "
          f"{model.stack_seconds}; adam count {model.state.opt.count}",
          flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: non-finite losses {losses}")
    if not log["train_loss"][-1] < log["train_loss"][0]:
        raise AssertionError(f"{kind}: the train loss did not fall: "
                             f"{log['train_loss']}")


def cnn_step_vs_cpu(model, device, seed: int) -> None:
    """One train step of float32 copies of ``model``'s state on the card
    and on the CPU (TF32 off since phase 1), the same batch and
    variates."""
    import torch

    from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
        AugmentVariates,
        draw_augment_variates,
    )
    from mpp_cnn_rs_object_detection_torch.models.train_utils import (
        recentred_bias,
    )

    assert not torch.backends.cudnn.allow_tf32
    b = model.batch_size
    stack = model.train_stack
    idx = torch.arange(b, device=device)
    batch = stack.batch(idx, int(max(1, stack.counts[:b].max())))
    v = draw_augment_variates(torch.Generator(device=device).manual_seed(
        seed), b, stack.images.shape[1], device)
    card, cpu = model.train_replica(device), model.train_replica("cpu")
    t0 = time.perf_counter()
    got = card.train_batch(batch, v)
    want = cpu.train_batch(tuple(t.cpu() for t in batch),
                           AugmentVariates(*(t.cpu() for t in v)))
    worst = {"loss": 0.0, "param": 0.0, "recentred": 0.0}
    for k, w in want.items():
        g = float(got[k])
        worst["loss"] = max(worst["loss"], abs(g - float(w)) / abs(float(w)))
    for name, p in cpu.state.params.items():
        d = float((card.state.params[name].detach().cpu() - p.detach())
                  .abs().max())
        key = "recentred" if recentred_bias(name) else "param"
        worst[key] = max(worst[key], d)
    print(f"  one float32 step, card vs CPU ({time.perf_counter() - t0:.3f}"
          f" s): losses {({k: float(x) for k, x in got.items()})}; "
          f"max rel loss diff {worst['loss']:.3e} (tol {STEP_RTOL}); max "
          f"param diff {worst['param']:.3e} (tol {STEP_PARAM_TOL}); "
          f"re-centred biases {worst['recentred']:.3e} (tol "
          f"{STEP_NOISE_TOL})", flush=True)
    if worst["loss"] > STEP_RTOL or worst["param"] > STEP_PARAM_TOL \
            or worst["recentred"] > STEP_NOISE_TOL:
        raise AssertionError(f"the train step on the card disagrees with "
                             f"the CPU: {worst}")


def cnn_step_probe(model, device, seed: int) -> dict:
    """One bf16 train step of ``model`` at full width, alone: its launches,
    device ms and costliest kernels under the profiler; its wall ms and
    peak memory unprofiled, and the device's idle share, 1 - device ms /
    that wall; adam's launches, and the
    augmentation's and targets' launches and device ms; the step's MFU
    (the forward's FLOPs counted from the conv shapes, x3 for the
    backward, over the wall ms, against the dense bf16 peak)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
        augment_batch,
        draw_augment_variates,
    )

    b = model.batch_size
    stack = model.train_stack
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.arange(b, device=device)
    width = int(max(1, stack.counts[:b].max()))
    batch = stack.batch(idx, width)
    p = stack.images.shape[1]

    def step():
        return model.train_batch(batch, draw_augment_variates(
            gen, b, p, device))

    def data():
        x, cen, par, val = augment_batch(*batch, draw_augment_variates(
            gen, b, p, device))
        return model.targets(cen, par, val)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    peak = torch.cuda.max_memory_allocated()
    launches, dev_ms, kernels = profiled(step, top=10_000)
    d_launches, d_ms = profiled(data)
    torch.cuda.synchronize()
    base_d = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    data()
    torch.cuda.synchronize()
    peak_d = torch.cuda.max_memory_allocated()
    grads = [torch.zeros_like(t) for t in model.state.params.values()]
    a_launches, a_ms = profiled(lambda: model.state.apply_gradients(grads))
    x = torch.rand((b, 3, p, p), device=device)
    model.state.train(True)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.state.modules["net" if "net" in model.state.modules
                            else ""](x)
    flops = 3.0 * float(counter.get_total_flops())
    return {"objects_per_patch_width": width, "launches": launches,
            "device_ms": dev_ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - dev_ms / wall_ms,
            "peak_gb": peak / 1e9, "peak_over_base_gb": (peak - base) / 1e9,
            "adam_launches": a_launches, "adam_device_ms": a_ms,
            "aug_targets_launches": d_launches, "aug_targets_device_ms": d_ms,
            "aug_targets_peak_over_base_gb": (peak_d - base_d) / 1e9,
            "step_tflop": flops / 1e12,
            "mfu": flops / (wall_ms / 1e3) / H100_BF16_FLOPS,
            "device_ms_by_kind": kernel_kinds(kernels),
            "top_kernels": kernels[:6]}


# kernel-name fragments -> kind, first match wins (layout conversions run
# inside cuDNN's convolution calls, so they come before "cudnn")
KERNEL_KINDS = (("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("reflect pad", ("reflection_pad",)),
                ("convolution", ("cudnn", "xmma", "cutlass", "gemm", "conv",
                                 "sm90_")),
                ("reduction", ("reduce_kernel",)),
                ("pooling", ("pool",)),
                ("elementwise", ("elementwise", "index", "cat",
                                 "multi_tensor")))


def kernel_kinds(kernels) -> dict:
    """(name, launches, ms) per kernel -> {kind: [launches, ms]}."""
    out = {}
    for name, n, ms in kernels:
        kind = next((k for k, frags in KERNEL_KINDS
                     if any(f in name for f in frags)), "other")
        acc = out.setdefault(kind, [0, 0.0])
        acc[0] += n
        acc[1] += ms
    return out


def cnn_train_phase(root: str, device, seed: int) -> int:
    """Phase 13; returns the detection-map launches of its inference."""
    import torch

    from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
        read_checkpoint,
    )
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )
    from mpp_cnn_rs_object_detection_torch.utils.png import read_unit_image

    t0 = time.perf_counter()
    configs = cnn_workspace(root, seed)
    print(f"  dataset ({CNN_TRAIN_SCENES} train, {CLI_SCENES} val scenes of "
          f"{CNN_SCENE}^2): {time.perf_counter() - t0:.3f} s; cut "
          f"{CNN_CUT} of the configs' 16,384 patches, 2,048 val patches, "
          f"136 epochs and a regeneration every 8", flush=True)
    pos = configs["posnet"]
    model, sec = run_cnn_cli(root, "posnet", pos, device, "train", "-o")
    check_cnn_training(model, "posnet", sec)
    if [s for s, _ in model.stack_seconds] != ["train", "val", "train"]:
        raise AssertionError(f"expected one regeneration: "
                             f"{model.stack_seconds}")
    store = os.path.join(root, "models", "posnet", pos["model_name"])
    steps = CNN_CUT["n_patches"] // model.batch_size
    count = int(read_checkpoint(os.path.join(store, "model.msgpack"))[
        "opt_state"]["0"]["count"])
    resumed = dict(pos, trainer=dict(pos["trainer"], n_epochs=4))
    model, sec = run_cnn_cli(root, "posnet", resumed, device, "train", "-r")
    print(f"  -r at 4 epochs: {sec:.3f} s; resumed at epoch "
          f"{model.last_epoch} from adam count {count}, now "
          f"{model.state.opt.count}", flush=True)
    if model.last_epoch != 3 or count != 3 * steps \
            or model.state.opt.count != 4 * steps:
        raise AssertionError(f"resume: epoch {model.last_epoch}, counts "
                             f"{count} -> {model.state.opt.count}")
    cnn_step_vs_cpu(model, device, seed)
    probe = cnn_step_probe(model, device, seed)
    patch = pos["data_loader"]["patch_maker_params"]["patch_size"]
    print(f"  one {str(model.state.modules['net'].dtype)[6:]} step alone "
          f"({model.batch_size} x {patch}^2): {probe}", flush=True)
    shape, sec = run_cnn_cli(root, "shapenet", configs["shapenet"], device,
                             "train", "-o")
    check_cnn_training(shape, "shapenet", sec)

    dk.KERNEL.launches = 0
    inf, sec = run_cnn_cli(root, "posnet", pos, device, "infer")
    torch.cuda.synchronize()
    launches = dk.KERNEL.launches
    if launches != CLI_SCENES:
        raise AssertionError(f"-p infer -m posnet: expected {CLI_SCENES} "
                             f"detection-map launches, counted {launches}")
    img = read_unit_image(os.path.join(root, "data", "synth_cnn", "val",
                                       "images", "0000.png"))
    views = [dk.View(inf.head_planes(img), img.shape[:2], (0, False))]
    kw = dict(mask_is_logit=True, **inf._epilogue())
    err = compare("trained PosNet's launch on val scene 0",
                  dk.detection_map_tta(views, img.shape[:2], **kw),
                  dk.detection_map_tta_plain(views, img.shape[:2], **kw))
    print(f"  -p infer -m posnet (trained weights, {kw['epilogue']} "
          f"epilogue): {sec:.3f} s; {launches} detection-map launches; "
          f"kernel vs plain max_abs {err:.3e}", flush=True)
    return launches


def host_configs() -> dict:
    """Phase 14's depth-cut copies of ``HOST_CONFIGS`` on phase 13's
    dataset; returns {kind: config}."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import REPO_ROOT

    configs = {}
    for kind, base in HOST_CONFIGS.items():
        with open(os.path.join(REPO_ROOT, "model_configs", kind,
                               base + ".json")) as f:
            cfg = json.load(f)
        cfg["model_name"] = f"{base}_smoke"
        dl = cfg["data_loader"]
        dl["dataset"] = "synth_cnn"
        dl["dataset_update_interval"] = HOST_CUT["dataset_update_interval"]
        if "error_update_interval" in dl:
            dl["error_update_interval"] = HOST_CUT["error_update_interval"]
        dl["patch_maker_params"]["n_patches"] = HOST_CUT["n_patches"]
        cfg["trainer"]["n_epochs"] = HOST_CUT["n_epochs"]
        configs[kind] = cfg
    return configs


def full_schedule(kind: str) -> dict:
    """The uncut config's training: epochs, train and val steps per epoch,
    patches per set, regenerations and mining passes, counted as its
    epoch loop counts them."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import REPO_ROOT

    with open(os.path.join(REPO_ROOT, "model_configs", kind,
                           HOST_CONFIGS[kind] + ".json")) as f:
        cfg = json.load(f)
    dl, tr = cfg["data_loader"], cfg["trainer"]
    n = dl["patch_maker_params"]["n_patches"]
    regen = [e for e in range(tr["n_epochs"])
             if e % dl["dataset_update_interval"] == 0 and e != 0]
    eui = dl.get("error_update_interval")
    return {"epochs": tr["n_epochs"], "steps": n // tr["batch_size"],
            "val_steps": n // 2 // tr["batch_size"], "patches": n,
            "regenerations": len(regen),
            "mining": len([e for e in regen if eui and e % eui == 0])}


def check_host_training(model, kind: str, seconds: float, root: str) -> None:
    """Finite losses, the regeneration sequence (and for the PosNet the
    mining pass and its error maps), no patch set left; prints the host's
    seconds."""
    import numpy as np

    log = model.logger.log
    losses = np.asarray(log["train_loss"] + log["val_loss"])
    waits = np.asarray(model.loader_wait_seconds)
    name = model.config["model_name"]
    print(f"  -p train -m {kind} ({name}): {seconds:.3f} s; epochs "
          f"{log['epoch']}; train loss {log['train_loss']}; val loss "
          f"{log['val_loss']}; seconds per epoch {model.epoch_seconds}; "
          f"host seconds of the patch sets {model.stack_seconds}; "
          f"regenerations (epoch, densities) {model.regenerations}; "
          f"mining seconds {model.mining_seconds}; loader waits per batch "
          f"mean {waits.mean():.4f} s, max {waits.max():.4f} s over "
          f"{len(waits)}; adam count {model.state.opt.count}", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: non-finite losses {losses}")
    mining = kind == "posnet"
    if [s for s, _ in model.stack_seconds] != ["train+val", "train",
                                               "train"] \
            or model.regenerations != [(1, False), (2, mining)]:
        raise AssertionError(f"{kind}: patch sets {model.stack_seconds}, "
                             f"regenerations {model.regenerations}")
    data = os.path.join(root, "data")
    if os.path.exists(os.path.join(data, f"temp_{name}")):
        raise AssertionError(f"{kind}: the temporary patch set is left")
    maps = os.path.join(data, "error_maps", "synth_cnn", "train", name)
    found = sorted(os.listdir(maps)) if os.path.isdir(maps) else []
    want = [f"{i:04}.png" for i in range(CNN_TRAIN_SCENES)] if mining else []
    if found != want or len(model.mining_seconds) != int(mining):
        raise AssertionError(f"{kind}: error maps {found}, mining passes "
                             f"{model.mining_seconds}")


def host_loss_vs_cpu(model, batch, device) -> None:
    """One host batch's float32 train-mode loss terms on the card and on
    the CPU (float32 copies of the trained state, TF32 off)."""
    import torch

    got, want = {}, {}
    for rep, out in ((model.train_replica(device), got),
                     (model.train_replica("cpu"), want)):
        x, y = rep.host_batch(batch)
        rep.state.train(True)
        with torch.no_grad():
            out.update({k: float(v) for k, v in rep.loss(x, y, True)[1]
                        .items()})
    worst = max(abs(got[k] - w) / abs(w) for k, w in want.items())
    print(f"  one host batch's float32 loss, card vs CPU: {got}; max rel "
          f"diff {worst:.3e} (tol {STEP_RTOL})", flush=True)
    if worst > STEP_RTOL:
        raise AssertionError(f"the host batch's loss on the card disagrees "
                             f"with the CPU: {got} vs {want}")


def host_epoch_probe(model) -> dict:
    """One val epoch of ``model``'s loaders timed on the host clock
    (synchronised), then one train epoch under the profiler, timed the
    same way inside it: the loader's waits per batch, device ms and
    launches per step, the device's idle share (1 - device time / that
    epoch's wall)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.host_epoch(model.val_loader, False)
    torch.cuda.synchronize()
    val_wall = time.perf_counter() - t0
    first = len(model.loader_wait_seconds)
    wall = []

    def epoch():
        t0 = time.perf_counter()
        model.host_epoch(model.train_loader, True)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    launches, dev_ms = profiled(epoch)
    steps = len(model.train_loader)
    waits = np.asarray(model.loader_wait_seconds[first:])
    return {"steps": steps, "epoch_wall_s": wall[0],
            "loader_wait_s_per_batch": float(waits.mean()),
            "loader_wait_share": float(waits.sum() / wall[0]),
            "device_ms_per_step": dev_ms / steps,
            "launches_per_step": launches / steps,
            "idle_share": 1.0 - dev_ms / 1e3 / wall[0],
            "val_steps": len(model.val_loader), "val_wall_s": val_wall}


def project_full(model, probe: dict, kind: str) -> dict:
    """Seconds of the uncut config's training, linear in this run's:
    train and val steps at the probe's wall per step, patch sets at this
    run's host seconds per patch, mining passes at this run's."""
    full = full_schedule(kind)
    n = HOST_CUT["n_patches"]
    first = next(s for k, s in model.stack_seconds if k == "train+val")
    regen = [s for k, s in model.stack_seconds if k == "train"]
    first, regen = first / (n + n // 2), sum(regen) / (n * len(regen))
    epochs = full["epochs"] * (
        full["steps"] * probe["epoch_wall_s"] / probe["steps"]
        + full["val_steps"] * probe["val_wall_s"] / probe["val_steps"])
    sets = first * full["patches"] * 1.5 \
        + regen * full["patches"] * full["regenerations"]
    mining = full["mining"] * (model.mining_seconds[0]
                               if model.mining_seconds else 0.0)
    return {"schedule": full, "epochs_s": epochs, "patch_sets_s": sets,
            "mining_s": mining, "total_s": epochs + sets + mining}


def host_train_phase(root: str, device, configs: dict) -> int:
    """Phase 14; returns the detection-map launches of its inference."""
    import torch

    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )
    from mpp_cnn_rs_object_detection_torch.utils.png import read_unit_image

    pos = configs["posnet"]
    model, sec = run_cnn_cli(root, "posnet", pos, device, "train", "-o")
    check_host_training(model, "posnet", sec, root)
    # a fresh patch set (the trained one is gone) for the probes
    with inside(root):
        model.init_host_data()
        host_loss_vs_cpu(model, next(iter(model.train_loader)), device)
        probe = host_epoch_probe(model)
        model.clean()
    print(f"  one {str(model.state.modules['net'].dtype)[6:]} host epoch "
          f"({probe['steps']} steps of {model.batch_size} x "
          f"{pos['data_loader']['patch_maker_params']['patch_size']}^2): "
          f"{probe}", flush=True)
    print(f"  projected full {HOST_CONFIGS['posnet']} on this card and "
          f"host: {project_full(model, probe, 'posnet')} (mining over "
          f"{CNN_TRAIN_SCENES} scenes of {CNN_SCENE}^2)", flush=True)
    shape, sec = run_cnn_cli(root, "shapenet", configs["shapenet"], device,
                             "train", "-o")
    check_host_training(shape, "shapenet", sec, root)

    dk.KERNEL.launches = 0
    inf, sec = run_cnn_cli(root, "posnet", pos, device, "infer")
    torch.cuda.synchronize()
    launches = dk.KERNEL.launches
    if launches != CLI_SCENES:
        raise AssertionError(f"-p infer -m posnet: expected {CLI_SCENES} "
                             f"detection-map launches, counted {launches}")
    img = read_unit_image(os.path.join(root, "data", "synth_cnn", "val",
                                       "images", "0000.png"))
    views = [dk.View(inf.head_planes(img), img.shape[:2], (0, False))]
    kw = dict(mask_is_logit=True, **inf._epilogue())
    err = compare("the host-trained PosNet's launch on val scene 0",
                  dk.detection_map_tta(views, img.shape[:2], **kw),
                  dk.detection_map_tta_plain(views, img.shape[:2], **kw))
    print(f"  -p infer -m posnet (host-trained, {kw['epilogue']} "
          f"epilogue): {sec:.3f} s; {launches} detection-map launches; "
          f"kernel vs plain max_abs {err:.3e}", flush=True)
    return launches


def write_raw_dota(raw: str, seed: int) -> list:
    """Phase 15's raw DOTA tree: the ``RAW_DOTA`` scenes of
    ``RAW_DOTA_HW`` (a synthetic scene each, ``--seed``) with up to
    ``RAW_DOTA_OBJECTS`` vehicle polygons (integer coordinates in the first
    scene, one decimal in the others) and 10 planes, their meta files.
    Returns each scene's vehicle count."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.data.synth import (
        synthetic_scene,
    )
    from mpp_cnn_rs_object_detection_torch.ops.geometry import (
        rect_to_poly_np,
        sra_to_wla,
    )
    from mpp_cnn_rs_object_detection_torch.utils.png import write_png

    h, w = RAW_DOTA_HW
    vehicles = []
    for i, (subset, gsd, source) in enumerate(RAW_DOTA):
        for d in ("images", f"DOTA-v2.0_{subset}", "meta"):
            os.makedirs(os.path.join(raw, subset, d), exist_ok=True)
        image, centers, marks = synthetic_scene(
            h, w, RAW_DOTA_OBJECTS + 10, seed=seed + i)
        write_png(os.path.join(raw, subset, "images", f"P{i:04}.png"),
                  (image * 255).astype(np.uint8), level=1)
        short, long, angle = sra_to_wla(marks[:, 0], marks[:, 1],
                                        marks[:, 2])
        polys = rect_to_poly_np(centers, short, long, angle)[..., ::-1]
        n_vehicles = max(len(polys) - 10, 0)
        vehicles.append(n_vehicles)
        lines = []
        for j, p in enumerate(polys.reshape(len(polys), 8)):
            coords = (" ".join(str(int(round(v))) for v in p) if i == 0
                      else " ".join(f"{v:.1f}" for v in p))
            cat = ("plane" if j >= n_vehicles else
                   ("small-vehicle", "large-vehicle")[j % 2])
            lines.append(f"{coords} {cat} {j % 3 == 0:d}")
        with open(os.path.join(raw, subset, f"DOTA-v2.0_{subset}",
                               f"P{i:04}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(raw, subset, "meta", f"P{i:04}.txt"),
                  "w") as f:
            f.write(f"acquisition dates:2017-08-13\nimagesource:{source}\n"
                    f"gsd:{gsd}\n")
    return vehicles


def write_raw_cowc(raw: str, seed: int) -> list:
    """Phase 15's raw COWC tree: ``COWC_SCENES`` RGB scenes of ``COWC_HW``
    with up to ``COWC_CARS`` cars each, marked one pixel each in an
    ``_Annotated_Cars`` mask, and an empty ``_Annotated_Negatives`` one.
    Returns each scene's car count."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.data.synth import (
        synthetic_scene,
    )
    from mpp_cnn_rs_object_detection_torch.utils.png import write_png

    os.makedirs(os.path.join(raw, "Utah"))
    cars = []
    for i in range(COWC_SCENES):
        image, centers, _ = synthetic_scene(*COWC_HW, COWC_CARS,
                                            seed=seed + 100 + i)
        ann = np.zeros(COWC_HW + (3,), np.uint8)
        rc = np.round(centers).astype(int)
        ann[rc[:, 0], rc[:, 1]] = (255, 0, 0)
        stem = os.path.join(raw, "Utah", f"img{i}")
        write_png(stem + ".png", (image * 255).astype(np.uint8), level=1)
        write_png(stem + "_Annotated_Cars.png", ann, level=1)
        write_png(stem + "_Annotated_Negatives.png", ann * 0, level=1)
        cars.append(len(centers))
    return cars


def contrast_config(root: str, config, base: str, name: str, **inference
                    ) -> str:
    """A copy of ``base`` on the flagship's CNNs with the CNN-free data
    term: ``CONTRAST_SETUP`` (craciun2, manual weights over the contrast
    names). Returns its path."""
    path = mpp_config_copy(root, base, name, store=False,
                           blocks={"dataset": {
                               k: config["dataset"][k] for k in
                               ("position_model", "shape_model")}},
                           **inference)
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(json.loads(json.dumps(CONTRAST_SETUP)))
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def translation_phase(root: str, config, device, seed: int) -> int:
    """Phase 15: the translators, check_div, the oracle and the CNN-free
    data term on both chains. Returns check_div's detection-map launches."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model
    from mpp_cnn_rs_object_detection_torch.mpp.energy_setups import (
        CONTRAST_NAMES,
    )
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )

    # (a) raw DOTA -> DOTA_smoke
    t0 = time.perf_counter()
    raw = os.path.join(root, "dota_raw")
    vehicles = write_raw_dota(raw, seed)
    with open(os.path.join(mpp_model.REPO_ROOT, "model_configs",
                           "translation", "translate_DOTA_config.json")) as f:
        cfg = json.load(f)
    cfg.update(name="DOTA_smoke", dota_base_path=[raw])
    path = os.path.join(root, "translate_DOTA_smoke.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    t_raw = time.perf_counter() - t0
    counts, sec = run_procedure(root, ["-p", "translate_dota", "-c", path],
                                device)
    shapes = {}
    for subset in counts:
        for fname in sorted(os.listdir(os.path.join(
                root, "data", "DOTA_smoke", subset, "metadata"))):
            with open(os.path.join(root, "data", "DOTA_smoke", subset,
                                   "metadata", fname)) as f:
                meta = json.load(f)
            shapes[f"{subset}/{fname[:4]}"] = (tuple(meta["shape"]),
                                               meta["n_objects"])
    h, w = RAW_DOTA_HW
    want = {"train/0000": ((round(h * 0.6), round(w * 0.6), 3),
                           vehicles[0]),
            "train/0001": ((h // 2, w // 2, 3), vehicles[1]),
            "val/0002": ((h, w, 3), vehicles[2])}
    if counts != {"train": 2, "val": 1} or shapes != want:
        raise AssertionError(f"translate_dota: {counts} {shapes}")
    print(f"  -p translate_dota: {sec:.3f} s (raw tree {t_raw:.3f} s); "
          f"translated {counts}, banned source dropped; (shape, objects) "
          f"{shapes}", flush=True)

    # (b) raw COWC -> COWC_smoke
    raw = os.path.join(root, "cowc_raw")
    n_cars = write_raw_cowc(raw, seed)
    path = os.path.join(root, "translate_COWC_smoke.json")
    with open(path, "w") as f:
        json.dump({"name": "COWC_smoke", "cowc_base_path": [raw],
                   "target_gsd": 0.5, "val_fraction": 0.25, "seed": 0}, f)
    counts, sec = run_procedure(root, ["-p", "translate_cowc", "-c", path],
                                device)
    cars = {}
    for subset in ("val", "train"):
        folder = os.path.join(root, "data", "COWC_smoke", subset)
        for fname in sorted(os.listdir(os.path.join(folder, "metadata"))):
            with open(os.path.join(folder, "metadata", fname)) as f:
                meta = json.load(f)
            cars[os.path.basename(meta["source_image"])] = meta["n_objects"]
            if meta["shape"] != [int(COWC_HW[0] * 0.3),
                                 int(COWC_HW[1] * 0.3), 3]:
                raise AssertionError(f"translate_cowc: {meta}")
    if counts != {"val": 1, "train": COWC_SCENES - 1} or cars != {
            f"img{i}.png": n for i, n in enumerate(n_cars)}:
        raise AssertionError(f"translate_cowc: {counts} {cars}")
    print(f"  -p translate_cowc: {sec:.3f} s; translated {counts}, cars "
          f"{cars}", flush=True)

    # (c) check_div: the kernel against its plain version
    dk.KERNEL.launches = 0
    errors, sec = run_procedure(root, ["-p", "check_div"], device)
    launches = dk.KERNEL.launches
    print(f"  -p check_div: {sec:.3f} s; {errors}; {launches} detection-map "
          f"launch; tol=atol {ATOL} + rtol {RTOL}", flush=True)
    if launches != 1 or not errors["kernel"] <= ATOL or \
            not errors["divergence"] < 1e-5:
        raise AssertionError(f"check_div: {errors}, {launches} launches")

    # (d) the oracle on DOTA_smoke's val subset
    _, sec = run_procedure(root, ["-p", "infereval", "-m", "oracle", "-c",
                                  "config_oracle", "-d", "DOTA_smoke"],
                           device)
    aps = {}
    dota = os.path.join(root, "data", "inference", "DOTA_smoke", "val",
                        "oracle", "dota")
    for iou in IOUS:
        with open(os.path.join(dota, f"metrics{iou:.2f}.json")) as f:
            aps[iou] = json.load(f)["vehicle"]["ap"]
    check_pr_curves(dota)
    print(f"  -p infereval -m oracle: {sec:.3f} s; AP "
          + ", ".join(f"@{k} {v:.3f}" for k, v in aps.items()), flush=True)
    if any(v != 1.0 for v in aps.values()):
        raise AssertionError(f"oracle AP {aps}")

    # (e) the contrast data term, exact then tiled, on phase 6's CNNs
    name = f"{MANUAL_CONFIG}_contrast"
    model, t_cli = run_cli(root, contrast_config(root, config, MANUAL_CONFIG,
                                                 name, seg_super=CUT_SEG),
                           device)
    if model.energy_setup.spec.names != CONTRAST_NAMES or \
            model.energy_model.kind != "manual_hierarchical":
        raise AssertionError(f"{name}: {model.energy_setup.spec} "
                             f"{model.energy_model.kind}")
    stops = {(r.supersteps, r.stopped) for r in model.results.values()}
    if stops != {(CUT_SEG, True)}:
        raise AssertionError(f"{name}: not one segment per scene: {stops}")
    aps = check_exports(root, model, name)
    with inside(root):
        data = model._load_image(0, "val")
    probe = superstep_probe(model.energy_setup, model.energy_model,
                            model.capacity, data, {}, device)
    sec = model.seconds
    print(f"  CLI -c {name} (exact, contrast craciun2, manual): "
          f"{t_cli:.3f} s; chains {sec['chain']:.3f} s "
          f"({1e3 * sec['chain'] / (CUT_SEG * CLI_SCENES):.3f} "
          f"ms/superstep); "
          f"{ap_line(model, aps)}; one superstep alone: {probe['launches']}"
          f" launches, {probe['device_ms']:.3f} device ms", flush=True)
    name = f"{TILED_CONFIG}_contrast"
    path = contrast_config(root, config, TILED_CONFIG, name,
                           segment_size=CONTRAST_TILED[0])
    with open(path) as f:
        cfg = json.load(f)
    rj = cfg["inference"]["rjmcmc_params"]
    rj.pop("stopping")
    rj.update(burn_in=CONTRAST_TILED[1], samples_interval=CONTRAST_TILED[2])
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    model, t_cli = run_cli(root, path, device)
    aps = check_exports(root, model, name)
    steps = {r.supersteps for r in model.results.values()}
    if steps != {CONTRAST_TILED[0]}:
        raise AssertionError(f"{name}: {steps} steps")
    print(f"  CLI -c {name} (tiled, sequential, contrast craciun2): "
          f"{t_cli:.3f} s; chains {model.seconds['chain']:.3f} s for "
          f"{CONTRAST_TILED[0]} steps of {CLI_SCENES} scenes; "
          f"{ap_line(model, aps)}", flush=True)
    return launches


def detector_configs() -> dict:
    """Phase 16's copies of ``DETECTOR_CONFIGS`` on phase 13's dataset, at
    full width, cut to ``DETECTOR_CUT``; returns {kind: config}."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import REPO_ROOT

    configs = {}
    for kind, base in DETECTOR_CONFIGS.items():
        with open(os.path.join(REPO_ROOT, "model_configs", kind,
                               base + ".json")) as f:
            cfg = json.load(f)
        cut = DETECTOR_CUT[kind]
        cfg["model_name"] = f"{base}_smoke"
        dl = cfg["data_loader"]
        dl["dataset"] = "synth_cnn"
        dl["patch_maker_params"].update(n_patches=cut["n_patches"],
                                        val_patches=cut["val_patches"])
        cfg["trainer"]["n_epochs"] = cut["n_epochs"]
        cfg["inference"] = {"min_confidence": DETECTOR_MIN_CONFIDENCE}
        configs[kind] = cfg
    return configs


def detector_full_schedule(kind: str) -> dict:
    """The uncut config's training as its epoch loop counts it: epochs,
    train and val steps per epoch, patches per build, train rebuilds."""
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import REPO_ROOT

    with open(os.path.join(REPO_ROOT, "model_configs", kind,
                           DETECTOR_CONFIGS[kind] + ".json")) as f:
        cfg = json.load(f)
    dl, tr = cfg["data_loader"], cfg["trainer"]
    pm = dl["patch_maker_params"]
    b, epochs = tr["batch_size"], tr["n_epochs"]
    return {"epochs": epochs, "steps": pm["n_patches"] // b,
            "val_steps": max(pm["val_patches"], 64) // b,
            "patches": pm["n_patches"], "val_patches": pm["val_patches"],
            "rebuilds": len([e for e in range(epochs)
                             if e % dl["dataset_update_interval"] == 0
                             and e not in (0, epochs - 1)])}


def check_detector_training(model, kind: str, seconds: float) -> dict:
    """Finite losses, the device pipeline (train and val stacks built
    once); prints the epochs' and builds' seconds. Returns the projection
    of the uncut config's training, linear in this run's epochs (train
    and val steps at this run's seconds per step) and builds (host seconds
    per patch)."""
    import numpy as np

    log = model.logger.log
    losses = np.asarray(log["train_loss"] + log["val_loss"])
    cut = DETECTOR_CUT[kind]
    b = model.batch_size
    steps = cut["n_patches"] // b + max(cut["val_patches"], 64) // b
    per_step = [s / steps for s in model.epoch_seconds]
    print(f"  -p train -m {kind} ({model.config['model_name']}): "
          f"{seconds:.3f} s; epochs {log['epoch']}; train loss "
          f"{log['train_loss']}; val loss {log['val_loss']}; seconds per "
          f"epoch {model.epoch_seconds} ({steps} train + val steps of "
          f"{b}); host seconds of build_patch_stack {model.stack_seconds}; "
          f"optimizer count {model.state.opt.count}", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: non-finite losses {losses}")
    if not model.device_pipeline or [s for s, _ in model.stack_seconds] \
            != ["train", "val"]:
        raise AssertionError(f"{kind}: expected the device pipeline's two "
                             f"stacks, got {model.stack_seconds}")
    full = detector_full_schedule(kind)
    # the later epochs: the first pays the kernels' warm-up
    step_s = min(per_step[1:] or per_step)
    train_s = dict(model.stack_seconds)["train"] / cut["n_patches"]
    val_s = dict(model.stack_seconds)["val"] / max(cut["val_patches"], 64)
    epochs = full["epochs"] * (full["steps"] + full["val_steps"]) * step_s
    builds = train_s * full["patches"] * (1 + full["rebuilds"]) \
        + val_s * max(full["val_patches"], 64)
    return {"schedule": full, "step_s": step_s, "epochs_s": epochs,
            "builds_s": builds, "total_s": epochs + builds}


def detector_step_vs_cpu(model, kind: str, device, seed: int) -> None:
    """One train step of float32 copies of ``model``'s state on the card
    and on the CPU (TF32 off since phase 1), the same batch (the first
    ``DETECTOR_CPU_BATCH`` patches) and variates: the loss terms."""
    import torch

    from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
        AugmentVariates,
        draw_augment_variates,
    )

    assert not torch.backends.cudnn.allow_tf32
    b = min(model.batch_size, DETECTOR_CPU_BATCH)
    stack = model.train_stack
    idx = torch.arange(b, device=device)
    batch = stack.batch(idx, int(max(1, stack.counts[:b].max())))
    v = draw_augment_variates(torch.Generator(device=device).manual_seed(
        seed), b, stack.images.shape[1], device)
    card, cpu = model.train_replica(device), model.train_replica("cpu")
    t0 = time.perf_counter()
    got = card.train_batch(batch, v)
    want = cpu.train_batch(tuple(t.cpu() for t in batch),
                           AugmentVariates(*(t.cpu() for t in v)))
    worst = max(abs(float(got[k]) - float(w)) / max(abs(float(w)), 1e-12)
                for k, w in want.items())
    print(f"  {kind}: one float32 step of {b} patches, card vs CPU ("
          f"{time.perf_counter() - t0:.3f} s): losses "
          f"{({k: float(x) for k, x in got.items()})}; max rel loss diff "
          f"{worst:.3e} (tol {DETECTOR_STEP_RTOL})", flush=True)
    if worst > DETECTOR_STEP_RTOL:
        raise AssertionError(f"{kind}: the train step on the card disagrees "
                             f"with the CPU: {got} vs {want}")


def detector_step_probe(model, device, seed: int) -> dict:
    """One bf16 train step of ``model`` at full width, alone: launches,
    device ms and the costliest kernels under the profiler; wall ms and
    peak memory unprofiled, the device's idle share (1 - device ms / that
    wall); for Faster R-CNN the host ms of the greedy NMS pass per step
    (its proposals' ``masked_nms``, one pass for the whole batch)."""
    import torch

    from mpp_cnn_rs_object_detection_torch.data.device_pipeline import (
        draw_augment_variates,
    )
    from mpp_cnn_rs_object_detection_torch.models import fasterrcnn_arch

    b = model.batch_size
    stack = model.train_stack
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.arange(b, device=device)
    batch = stack.batch(idx, int(max(1, stack.counts[:b].max())))
    p = stack.images.shape[1]
    greedy = fasterrcnn_arch.greedy_keep
    nms_s = []

    def timed_greedy(*args):
        t0 = time.perf_counter()
        out = greedy(*args)
        nms_s.append(time.perf_counter() - t0)
        return out

    def step():
        return model.train_batch(batch, draw_augment_variates(gen, b, p,
                                                              device))

    fasterrcnn_arch.greedy_keep = timed_greedy
    try:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        nms_s.clear()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        peak = torch.cuda.max_memory_allocated()
        nms_ms = 1e3 * sum(nms_s) / reps
        launches, dev_ms, kernels = profiled(step, top=10_000)
    finally:
        fasterrcnn_arch.greedy_keep = greedy
    return {"batch": b, "launches": launches, "device_ms": dev_ms,
            "wall_ms": wall_ms, "idle_share": 1.0 - dev_ms / wall_ms,
            "greedy_nms_host_ms": nms_ms, "peak_gb": peak / 1e9,
            "peak_over_base_gb": (peak - base) / 1e9,
            "device_ms_by_kind": kernel_kinds(kernels),
            "top_kernels": kernels[:5]}


def check_detector_export(model, kind: str, root: str, seconds: float
                          ) -> None:
    """``-p infereval``'s files: a result pickle per val scene in the
    detector's format, DOTA files, finite APs."""
    import pickle

    import numpy as np

    from mpp_cnn_rs_object_detection_torch.utils.config import (
        get_inference_path,
    )

    with inside(root):
        results = get_inference_path(model.config["model_name"], "synth_cnn",
                                     "val")
    n_det = []
    for i in range(CLI_SCENES):
        with open(os.path.join(results, f"{i:04}_results.pkl"), "rb") as f:
            res = pickle.load(f)
        want = "poly" if model.ORIENTED else "bbox"
        if res["detection_type"] != want:
            raise AssertionError(f"{kind}: {res['detection_type']} results")
        n_det.append(len(res["detection_score"]))
    aps = {}
    for iou in (0.05, 0.25, 0.5):
        with open(os.path.join(results, "dota",
                               f"metrics{iou:.2f}.json")) as f:
            aps[iou] = json.load(f)["vehicle"]["ap"]
    check_pr_curves(os.path.join(results, "dota"))
    print(f"  -p infereval -m {kind}: {seconds:.3f} s; detections per val "
          f"scene {n_det}; AP {aps}", flush=True)
    if not all(np.isfinite(v) for v in aps.values()):
        raise AssertionError(f"{kind}: non-finite AP {aps}")


def detector_phase(root: str, device, seed: int) -> None:
    """Phase 16, on phase 13's dataset: per detector ``-p train`` and
    ``-p infereval`` through the CLI, a float32 step card vs CPU, one
    profiled bf16 step and the projected full training."""
    configs = detector_configs()
    for kind, cfg in configs.items():
        t0 = time.perf_counter()
        model, sec = run_cnn_cli(root, kind, cfg, device, "train", "-o")
        projection = check_detector_training(model, kind, sec)
        t1 = time.perf_counter()
        detector_step_vs_cpu(model, kind, device, seed)
        t2 = time.perf_counter()
        probe = detector_step_probe(model, device, seed)
        t3 = time.perf_counter()
        print(f"  {kind}: one {str(model.dtype)[6:]} step alone ("
              f"{model.batch_size} x {model.patch_size}^2): {probe}",
              flush=True)
        print(f"  {kind}: projected full {DETECTOR_CONFIGS[kind]} on this "
              f"card and host: {projection}", flush=True)
        del model
        inf, sec = run_cnn_cli(root, kind, cfg, device, "infereval")
        check_detector_export(inf, kind, root, sec)
        print(f"  {kind} seconds: train {t1 - t0:.3f}, card vs CPU "
              f"{t2 - t1:.3f}, probe {t3 - t2:.3f}, infereval "
              f"{time.perf_counter() - t3:.3f}", flush=True)


def banded_chain_phase(inference, data, device, seed: int) -> None:
    """Phase 17 (a): phase 3's scene in memory (1024 bucket, the
    flagship's model and combiner) for MESH_SUPERSTEPS supersteps, one
    band and then MESH_BANDS bands on one card from the same generator
    seed: the same alive set, coordinates and marks within MESH_XY_TOL,
    accepts and final energy, each carried cache and energy against a
    rebuild; the same at 2 bands with the split/merge pair; then the
    launches and device ms of one banded superstep at 2 bands."""
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp import scene
    from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import (
        CELL,
        make_banded_step,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
        build_cache,
        energy_from_cache,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import (
        expand_lanes,
        lane,
        state_from_arrays,
    )
    from mpp_cnn_rs_object_detection_torch.parallel.sharded_scene import (
        run_exact_scene_chain,
    )

    setup, comb = inference.setup, inference.comb
    target = scene.scene_shape_bucket(*data.shape)
    data, c0, m0, _ = scene._prepare(data, setup, target, "naive", device)
    cap = scene._capacity(*data.shape, inference.config.get("capacity", 256),
                          len(c0))
    maps = expand_lanes(setup.make_maps(data), 1)
    kd = expand_lanes(setup.make_kernel_data(data, max(1, len(c0))), 1)
    init = expand_lanes(state_from_arrays(c0[:cap], m0[:cap], capacity=cap,
                                          device=device), 1)
    cache0 = build_cache(init, maps, setup.spec)
    budget = scene.superstep_budget(*data.shape, inference.params)

    def run(n, **moves):
        gens = [torch.Generator(device=device).manual_seed(seed)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ca, stats = run_exact_scene_chain(
            gens, init, maps, setup.spec, comb, kd, MESH_SUPERSTEPS,
            t0=1.0, alpha_t=budget.alpha_super, t_target=budget.t_target,
            cache=cache0, mesh=None if n == 1 else [device] * n, **moves)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / MESH_SUPERSTEPS
        return scene.ChainOutcome(state=lane(st, 0), cache=lane(ca, 0),
                                  energy=stats.final_energy[0],
                                  maps=lane(maps, 0)), stats, ms

    def check(got, want, what):
        (a, sa, _), (b, sb, _) = got, want
        if not torch.equal(a.state.alive, b.state.alive):
            raise AssertionError(f"{what}: another alive set")
        err = max(float((a.state.xy - b.state.xy).abs().max()),
                  float((a.state.marks - b.state.marks).abs().max()))
        if err > MESH_XY_TOL:
            raise AssertionError(f"{what}: states off by {err}")
        if int(sa.accepted.sum()) != int(sb.accepted.sum()):
            raise AssertionError(f"{what}: accepted {sa.accepted.sum()} "
                                 f"against {sb.accepted.sum()}")
        e1, e2 = float(a.energy), float(b.energy)
        if abs(e1 - e2) > MESH_ENERGY_RTOL * max(1.0, abs(e2)):
            raise AssertionError(f"{what}: energy {e1} against {e2}")
        u, u_fresh = check_carried(a, setup, comb, what)
        return err, u, u_fresh

    for label, moves, bands in (("default moves", {}, MESH_BANDS),
                                ("split/merge", dict(split_merge=True),
                                 MESH_BANDS[:1])):
        one = run(1, **moves)
        line = [f"1 band {one[2]:.3f}"]
        for n in bands:
            got = run(n, **moves)
            err, u, u_fresh = check(got, one, f"{label}, {n} bands")
            line.append(f"{n} bands {got[2]:.3f} (states off by {err:.2e}"
                        f"; energy {u:.4f}, rebuilt {u_fresh:.4f})")
        print(f"  banded chain, {label}, {MESH_SUPERSTEPS} supersteps, K="
              f"{cap}, ms per superstep (band set-up included): "
              + "; ".join(line) + f"; {int(one[0].state.n_points)} points, "
              f"{int(one[1].accepted.sum())} accepted, the same in every "
              "run", flush=True)
    h, w = data.shape
    step = make_banded_step(maps, setup.spec, comb, kd, budget.alpha_super,
                            budget.t_target, max(h, w) // (2 * CELL) + 1,
                            [device] * 2)
    u0 = energy_from_cache(init, maps, setup.spec, comb, cache0)
    carry = ([init] * 2, [cache0] * 2, [u0] * 2, 1.0)
    gens = [torch.Generator(device=device).manual_seed(0)]
    for _ in range(2):
        carry, _ = step(carry, gens)
    launches, dev_ms = profiled(lambda: step(carry, gens))
    print(f"  one banded superstep, 2 bands: {launches} launches, "
          f"{dev_ms:.3f} device ms", flush=True)


def split_runs_phase(root: str, config, inference, data, device,
                     seed: int) -> None:
    """Phase 17 (b): ``tile_mesh`` -- phase 3's scene in the tiled mode's
    25 tiles on the sequential chain, unsplit and in 2 groups on one card,
    64 moves -- and ``batch_mesh`` -- phase 6's val scenes as B = 2 on one
    device and over 2, one segment of MESH_SUPERSTEPS: identical results,
    or, where the card's reductions differ in the last bit between the
    lane counts, phase 4's check (the same first step; final counts or
    energies within the chains' spread). Prints which held."""
    import numpy as np
    import torch

    from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
        load_image_w_maps,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import (
        chain_options,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import RJMCMCParams
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        run_exact_scenes_batched,
        run_tiled_scene,
        superstep_budget,
    )

    setup, comb = inference.setup, inference.comb

    def same(a, b):
        return all(np.array_equal(getattr(x, f), getattr(y, f))
                   for x, y in zip(a, b)
                   for f in ("centers", "marks", "scores"))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def tiled(mesh, steps):
        params = RJMCMCParams(n_steps=steps - 1, t0=1.0, alpha_t=0.999,
                              n_samples=0, samples_interval=1)
        return [run_tiled_scene(data, setup, comb, params, seed=seed,
                                patch_size=256, min_overlap=32,
                                capacity=256, device=device, mesh=mesh)]

    def batched(mesh, seg):
        with inside(root):
            datas = [load_image_w_maps(i, "synth_smoke", "val",
                                       config["dataset"]["position_model"],
                                       config["dataset"]["shape_model"])
                     for i in range(CLI_SCENES)]
        kw = dict(chain_options(inference.config), stopping=None,
                  segment_size=seg * superstep_budget(
                      HEIGHT, WIDTH, inference.params).ms_tile)
        return run_exact_scenes_batched(
            datas, setup, comb, inference.params,
            seeds=[seed + i for i in range(CLI_SCENES)], max_segments=1,
            device=device, mesh=mesh, **kw)

    mesh = [device] * 2
    for what, fn, full in (("tile_mesh", tiled, MESH_SUPERSTEPS),
                           ("batch_mesh", batched, MESH_SUPERSTEPS)):
        (one, t1), (two, t2) = timed(lambda: fn(None, full)), \
            timed(lambda: fn(mesh, full))
        n_det = [len(r.centers) for r in one]
        head = (f"  {what}: {t1:.3f} s on one device, {t2:.3f} s over 2; "
                f"detections {n_det}")
        if same(one, two):
            print(f"{head}; identical results", flush=True)
            continue
        f1, f2 = fn(None, 1), fn(mesh, 1)
        if not all(np.allclose(a.centers, b.centers, atol=FIRST_STEP_TOL)
                   and np.allclose(a.marks, b.marks, atol=FIRST_STEP_TOL)
                   for a, b in zip(f1, f2)):
            raise AssertionError(f"{what}: the first step differs")
        if what == "batch_mesh":
            pairs = [(float(a.chain.energy), float(b.chain.energy))
                     for a, b in zip(one, two)]
        else:
            pairs = [(float(a.scores.sum()), float(b.scores.sum()))
                     for a, b in zip(one, two)]
        if any(abs(x - y) > CHAIN_ENERGY_RTOL * abs(x) for x, y in pairs):
            raise AssertionError(f"{what}: {pairs} beyond the spread")
        print(f"{head}; not identical (the card's reductions differ in the "
              f"last bit between lane counts); the first step agrees within "
              f"{FIRST_STEP_TOL} and the final energies (tiles: score sums) "
              f"{pairs} within {CHAIN_ENERGY_RTOL:.0%}", flush=True)


def banded_unet_phase(pos_model, image, device) -> int:
    """Phase 17 (c): the flagship PosNet (a float32 copy, TF32 off) on
    phase 3's scene, zero-padded to 960 x 928, in 4 row bands on one card
    with a MESH_HALO-row halo, against its forward of the whole scene
    zero-padded by the halo; then one kernel launch on the banded head
    planes against the plain version on the whole scene's. Returns the
    kernel launches (1)."""
    import torch
    import torch.nn.functional as F

    from mpp_cnn_rs_object_detection_torch.models.unet import PosNet
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )
    from mpp_cnn_rs_object_detection_torch.parallel.halo import (
        sharded_unet_inference,
    )

    net = PosNet(pos_model.config["model"]["hidden_dims"]).eval()
    net.load_state_dict(pos_model.net.state_dict())
    net = net.to(device)
    h, w = image.shape[:2]
    hp, wp = -(-h // 32) * 32, -(-w // 8) * 8
    x = torch.zeros((1, 3, hp, wp), device=device)
    x[0, :, :h, :w] = torch.as_tensor(image, dtype=torch.float32,
                                      device=device).permute(2, 0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        banded = sharded_unet_inference(net, x, [device] * 4,
                                        halo=MESH_HALO)
        torch.cuda.synchronize()
        t_banded = time.perf_counter() - t0
        whole = net(F.pad(x, (0, 0, MESH_HALO, MESH_HALO)))[
            ..., MESH_HALO:-MESH_HALO, :]
    excess = float(((banded - whole).abs() - UNET_ATOL
                    - UNET_RTOL * whole.abs()).max())
    err = float((banded - whole).abs().max())
    if excess > 0:
        raise AssertionError(f"banded PosNet off by {err} (beyond rtol "
                             f"{UNET_RTOL}, atol {UNET_ATOL})")
    epi = pos_model._epilogue()
    dk.KERNEL.launches = 0
    got = dk.detection_map_tta(
        [dk.View(banded[0].contiguous(), (h, w), (0, False))], (h, w),
        mask_is_logit=True, **epi)
    torch.cuda.synchronize()
    launches = dk.KERNEL.launches
    want = dk.detection_map_tta_plain(
        [dk.View(whole[0].contiguous(), (h, w), (0, False))], (h, w),
        mask_is_logit=True, **epi)
    map_err = float((got - want).abs().max())
    print(f"  banded PosNet, 4 bands of {hp // 4} rows + 2 x {MESH_HALO} "
          f"halo, {hp}x{wp} float32: {t_banded:.3f} s; max abs "
          f"{err:.3e} from the whole scene (rtol {UNET_RTOL}, atol "
          f"{UNET_ATOL}); kernel on the banded planes ({launches} launch) "
          f"vs plain on the whole scene's: max abs {map_err:.3e}",
          flush=True)
    if launches != 1 or map_err > MESH_MAP_TOL:
        raise AssertionError(f"banded detection map: {launches} launches, "
                             f"off by {map_err}")
    return launches


def mesh_config_phase(root: str, config, device) -> None:
    """Phase 17 (d): a copy of MESH_CONFIG (``scene_mesh: true``, legacy
    manual mode) on the flagship's CNNs, one segment of MESH_SEG_SUPER
    supersteps per scene: with one visible card the mesh is a no-op, and
    ``-p infereval`` calibrates, runs each scene's exact chain and writes
    result pickles, both overlays per scene and finite APs."""
    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model

    name = f"{MESH_CONFIG}_flagship_cnns"
    cfg_path = mpp_config_copy(root, MESH_CONFIG, name, store=False,
                               blocks={"dataset": {
                                   k: config["dataset"][k] for k in
                                   ("position_model", "shape_model")}},
                               seg_super=MESH_SEG_SUPER)
    with open(cfg_path) as f:
        assert json.load(f)["inference"]["scene_mesh"]
    mesh = mpp_model.mesh_for_scene(mpp_model.load_mpp_config(MESH_CONFIG),
                                    device, HEIGHT)
    model, t_cli = run_cli(root, cfg_path, device)
    stops = {(r.supersteps, r.stopped) for r in model.results.values()}
    if stops != {(MESH_SEG_SUPER, True)}:
        raise AssertionError(f"{name}: not one segment per scene: {stops}")
    aps = check_exports(root, model, name)
    sec = model.seconds
    print(f"  CLI -c {name} (scene_mesh, {len(mpp_model.visible_mesh(device))}"
          f" visible card(s), mesh {mesh}): {t_cli:.3f} s; chains "
          f"{sec['chain']:.3f} s; export (overlays included) "
          f"{sec['export']:.3f} s; eval {sec['eval']:.3f} s; "
          f"{ap_line(model, aps)}", flush=True)


def mesh_phase(root: str, config, inference, data, image, device,
               seed: int) -> int:
    """Phase 17: the meshes on one card. Returns the detection-map kernel
    launches it counted (the banded PosNet's)."""
    t0 = time.perf_counter()
    banded_chain_phase(inference, data, device, seed)
    t1 = time.perf_counter()
    split_runs_phase(root, config, inference, data, device, seed)
    t2 = time.perf_counter()
    launches = banded_unet_phase(inference.pos_models[0], image, device)
    t3 = time.perf_counter()
    mesh_config_phase(root, config, device)
    print(f"  phase 17 parts: banded chain {t1 - t0:.3f} s, tile and batch "
          f"splits {t2 - t1:.3f} s, banded PosNet {t3 - t2:.3f} s, "
          f"{MESH_CONFIG} CLI {time.perf_counter() - t3:.3f} s", flush=True)
    return launches


def figures_phase(root: str, config, inference, data, result, device
                  ) -> None:
    """Phase 18: ``-p data_preview -m mpp`` on phase 6's workspace and
    ``-m posnet`` on phase 14's ``config_pos`` copy (host pipeline);
    ``papangelou_heatmap`` on phase 3's maps with the flagship's combiner
    (timed; on a ``PAP_CROP`` crop the card's field against the CPU's);
    ``interaction_figure`` and ``energy_cross_plots`` on phase 4's final
    state; ``make_gif`` over phase 6's two detection overlays; and the
    PR curves of phase 7's eval (its backfilled detections) timed."""
    import numpy as np
    import torch

    from mpp_cnn_rs_object_detection_torch.metrics.dota_eval import (
        pr_curve_plot,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.energies import (
        energy_vectors,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.figures import (
        energy_cross_plots,
        interaction_figure,
        papangelou_heatmap,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.image_data import (
        crop_image_w_maps,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.state import to_device
    from mpp_cnn_rs_object_detection_torch.utils.config import (
        get_inference_path,
    )
    from mpp_cnn_rs_object_detection_torch.utils.display import make_gif
    from mpp_cnn_rs_object_detection_torch.utils.png import png_header

    figs = os.path.join(root, "figures")
    os.makedirs(figs)
    name = config["model_name"]

    # (a) the MPP's preview of the train scenes
    _, sec = run_cli(root, os.path.join(root, name + ".json"), device,
                     "data_preview")
    preview = os.path.join(root, "models", "mpp", name, "data_preview")
    shapes = {f: png_header(os.path.join(preview, f))
              for f in sorted(os.listdir(preview))}
    print(f"  -p data_preview -m mpp: {sec:.3f} s; {shapes}", flush=True)
    if sorted(shapes) != [f"preview_{i:04}_gt.png"
                          for i in range(CLI_SCENES)] or \
            set(shapes.values()) != {(HEIGHT, WIDTH, 3)}:
        raise AssertionError(f"MPP preview {shapes}")

    # (b) a host-pipeline PosNet's first train batch
    cfg = host_configs()["posnet"]
    model, sec = run_cnn_cli(root, "posnet", cfg, device, "data_preview")
    samples = os.path.join(model.save_path, "data_samples_train")
    n = min(model.batch_size, 8)
    p = cfg["data_loader"]["patch_maker_params"]["patch_size"]
    want = {f"sample_b00_{j:04}_{k}.png": (p, p, 3) for j in range(n)
            for k in ("raw", "mask")}
    got = {f: png_header(os.path.join(samples, f))
           for f in os.listdir(samples)}
    print(f"  -p data_preview -m posnet ({cfg['model_name']}, host "
          f"pipeline): {sec:.3f} s; {len(got)} PNGs of {set(got.values())}",
          flush=True)
    if got != want:
        raise AssertionError(f"PosNet preview {got}")

    # (c) the papangelou field of phase 3's scene
    setup, comb = inference.setup, inference.comb
    maps = setup.make_maps(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pap = papangelou_heatmap(data.image, maps, setup.spec, comb, PAP_MARKS,
                             os.path.join(figs, "papangelou.png"),
                             stride=PAP_STRIDE)
    t_pap = time.perf_counter() - t0
    # the scene as the chain left it (padded to its bucket in exact mode)
    h, w = data.image.shape[:2]
    want = (-(-h // PAP_STRIDE), -(-w // PAP_STRIDE))
    crop = crop_image_w_maps(data, np.zeros(2, int), PAP_CROP)
    crop_maps = setup.make_maps(crop)
    fields = [papangelou_heatmap(
        crop.image, m, setup.spec, c, PAP_MARKS,
        os.path.join(figs, f"papangelou_crop_{d}.png"), stride=PAP_STRIDE)
        for d, m, c in (("card", crop_maps, comb),
                        ("cpu", to_device(crop_maps, "cpu"),
                         to_device(comb, "cpu")))]
    rel = float(np.max(np.abs(fields[0] - fields[1])
                       / np.abs(fields[1])))
    print(f"  papangelou_heatmap: {pap.shape[0] * pap.shape[1]} probes "
          f"on {h}x{w} (stride {PAP_STRIDE}, marks {PAP_MARKS}) "
          f"{t_pap:.3f} s, figure "
          f"{png_header(os.path.join(figs, 'papangelou.png'))}; field "
          f"{float(pap.min()):.3e} .. {float(pap.max()):.3e}; "
          f"{PAP_CROP}^2 crop card vs CPU max rel {rel:.3e} (rtol "
          f"{PAP_RTOL})", flush=True)
    if pap.shape != want or not (np.isfinite(pap).all() and (pap > 0).all()):
        raise AssertionError(f"papangelou field {pap.shape}")
    if not rel <= PAP_RTOL:
        raise AssertionError(f"papangelou crop card vs CPU: {rel}")

    # (d) phase 4's final configuration
    chain = result.chain
    t0 = time.perf_counter()
    pairs = interaction_figure(data.image, chain.state, chain.cache,
                               os.path.join(figs, "interactions.png"))
    t_int = time.perf_counter() - t0
    ov = chain.cache.overlap.cpu().numpy()
    dist = chain.cache.dist.cpu().numpy()
    bad = [(i, j) for i, j, v in pairs
           if ov[i, j] != v or not dist[i, j] <= 32.0 or i >= j]
    alive = chain.state.alive
    t0 = time.perf_counter()
    vec = energy_vectors(chain.state, chain.maps, setup.spec)[alive]
    counts = energy_cross_plots(vec, list(setup.spec.names),
                                os.path.join(figs, "energy_cross.png"),
                                per_point_energy=comb(vec))
    t_cross = time.perf_counter() - t0
    host = vec.cpu().numpy()
    hist = np.stack([np.histogram(host[:, k], bins=20)[0]
                     for k in range(host.shape[1])])
    print(f"  interaction_figure: {len(pairs)} pairs within 32 "
          f"px of {int(alive.sum())} points, {t_int:.3f} s; "
          f"energy_cross_plots: {host.shape[1]}^2 panels, {t_cross:.3f} s",
          flush=True)
    if not pairs or bad:
        raise AssertionError(f"interaction pairs: {len(pairs)}, off {bad}")
    if not np.array_equal(counts, hist):
        raise AssertionError("cross-plot histograms differ from numpy's")

    # (e) an animated GIF of phase 6's detection overlays
    with inside(root):
        results_dir = get_inference_path(name, "synth_smoke", "val")
        ext_dir = get_inference_path(EXT_CONFIG, "synth_smoke", "val")
    t0 = time.perf_counter()
    gif = make_gif(results_dir, "*_detection.png", "detections.gif")
    t_gif = time.perf_counter() - t0
    with open(gif, "rb") as f:
        body = f.read()
    print(f"  make_gif: {CLI_SCENES} overlays of {HEIGHT}x{WIDTH}, "
          f"{len(body)} bytes, {t_gif:.3f} s", flush=True)
    if not (body.startswith(b"GIF89a") and body.endswith(b";")
            and body.count(b"\x21\xf9\x04") >= CLI_SCENES):
        raise AssertionError("make_gif wrote no GIF89a")

    # (f) the PR curves of the largest eval: phase 7's, both variants
    curves = []
    for postfix in ("", "-SV"):
        for iou in IOUS:
            with open(os.path.join(ext_dir, "dota" + postfix,
                                   f"metrics{iou:.2f}.json")) as f:
                m = json.load(f)["vehicle"]
            curves.append((m["recall"], m["precision"]))
    t0 = time.perf_counter()
    for k, (rec, prec) in enumerate(curves):
        pr_curve_plot(rec, prec, os.path.join(figs, f"pr_{k}.png"))
    t_pr = time.perf_counter() - t0
    print(f"  PR curves of one eval ({EXT_CONFIG}, {len(curves)} PNGs of "
          f"{len(curves[0][0])} points): {t_pr:.3f} s", flush=True)


def unet_reference_check(pos_model, device):
    """The U-Net on the card against the CPU on a small input, in fp32."""
    import numpy as np
    import torch

    from mpp_cnn_rs_object_detection_torch.models.unet import PosNet

    net = PosNet(pos_model.config["model"]["hidden_dims"]).eval()
    net.load_state_dict(pos_model.net.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = net.to(device)(x.to(device)).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  U-Net fp32 card vs CPU on 64x64: max_abs={err:.3e} "
          f"(max |out| {scale:.3f})", flush=True)
    if err > 1e-3 * max(1.0, scale):
        raise AssertionError("U-Net on the card disagrees with the CPU")


def run(args, device: str = "cuda:0") -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from mpp_cnn_rs_object_detection_torch import device as device_mod
        from mpp_cnn_rs_object_detection_torch import native
        from mpp_cnn_rs_object_detection_torch.data.synth import (
            synthetic_scene,
        )
        from mpp_cnn_rs_object_detection_torch.mpp import mpp_model
        from mpp_cnn_rs_object_detection_torch.mpp.scene import (
            scene_shape_bucket,
        )
        from mpp_cnn_rs_object_detection_torch.ops import (
            detection_kernel as dk,
        )
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 2

    device = torch.device(device)
    t_all = time.perf_counter()

    # ---- 1. device and build
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = device_mod.nvidia_smi_line()
    print(f"  device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    tb = time.perf_counter()
    _, lib_path = native.load(dk.KERNEL.name)
    log_path = lib_path + ".log"
    with open(log_path) as f:
        ptxas = " | ".join(ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln)
    print(f"  built {dk.KERNEL.name} in {time.perf_counter() - tb:.2f} s; "
          f"ptxas: {ptxas}", flush=True)
    phase("1 device + build", t0)

    # ---- 2. kernel vs plain
    t0 = time.perf_counter()
    max_abs_err = kernel_vs_plain(device, args.seed)
    phase("2 kernel vs plain", t0)

    # ---- 3..5: the main path, counts from 0
    config = mpp_model.load_mpp_config(MPP_CONFIG)
    pos_models, shape_model = load_models(config, device, args.seed)
    unet_reference_check(pos_models[0], device)
    mpp_dir = os.path.join(mpp_model.MODELS_ROOT, "mpp", config["model_name"])
    setup, comb = mpp_model.load_energy_model(config, mpp_dir, device)
    inference = mpp_model.SceneInference(config, pos_models, shape_model,
                                         setup, comb, device)
    image, gt_centers, _ = synthetic_scene(HEIGHT, WIDTH, OBJECTS,
                                           seed=args.seed)

    dk.KERNEL.launches = 0
    t0 = time.perf_counter()
    data = inference.cnn_maps(image, name="synthetic")
    torch.cuda.synchronize()
    launches_cnn = dk.KERNEL.launches
    det = data.detection_map
    assert tuple(det.shape) == (HEIGHT, WIDTH), det.shape
    assert bool(torch.isfinite(det).all()) and float(det.min()) >= 0.0 \
        and float(det.max()) <= 1.0
    for d in data.param_dist_maps:
        assert tuple(d.shape) == (HEIGHT, WIDTH, 32), d.shape
        assert float((d.sum(-1) - 1).abs().max()) < 1e-3
    print(f"  maps: detection max {float(det.max()):.4f} mean "
          f"{float(det.mean()):.4f}; {launches_cnn} kernel launches "
          f"({len(pos_models)} PosNets, 8 TTA views each)", flush=True)
    if launches_cnn != len(pos_models):
        raise AssertionError(f"expected {len(pos_models)} detection-map "
                             f"kernel launches, counted {launches_cnn}")
    phase("3 CNN maps", t0)

    t0 = time.perf_counter()
    result = inference.run_scenes([data], [args.seed],
                                  max_segments=args.max_segments)[0]
    chain = result.chain
    energy = float(chain.energy)
    ms_super = 1e3 * result.seconds["chain"] / max(result.supersteps, 1)
    print(f"  chain: bucket {tuple(chain.maps.position.shape)}, K="
          f"{result.capacity}, {result.supersteps} of "
          f"{result.planned_supersteps} supersteps, {ms_super:.3f} "
          f"ms/superstep, projected full budget "
          f"{ms_super * result.planned_supersteps / 1e3:.1f} s; prep "
          f"{result.seconds['prep']:.2f} s; energy {energy:.4f}; "
          f"n_points {int(chain.state.n_points)}", flush=True)
    bucket = scene_shape_bucket(HEIGHT, WIDTH)
    assert tuple(chain.maps.position.shape) == bucket, bucket
    assert np.isfinite(energy)
    _, u_fresh = check_carried(chain, setup, comb, "in-memory chain")
    print(f"  carried energy {energy:.4f} vs rebuilt {u_fresh:.4f}",
          flush=True)
    lane_phase(inference, data, args.seed)
    phase("4 chain", t0)

    t0 = time.perf_counter()
    scores = result.scores
    assert np.isfinite(scores).all() and (scores > 0).all()
    print(f"  scores: {len(scores)} detections (papangelou min "
          f"{scores.min() if len(scores) else 0:.4f} max "
          f"{scores.max() if len(scores) else 0:.4f}); {len(gt_centers)} "
          f"objects painted", flush=True)
    phase("5 scores", t0)
    if dk.KERNEL.launches == 0:
        raise AssertionError("the main path launched no detection-map kernel")

    # ---- 6-8. the command line on a dataset, counts from 0 in each
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        launches = cli_phase(root, config, device, args.seed)
        phase("6 CLI infereval on a dataset", t0)
        t0 = time.perf_counter()
        extensions_phase(root, device)
        phase(f"7 CLI infereval -c {EXT_CONFIG}", t0)
        t0 = time.perf_counter()
        restarts_phase(root, device)
        phase("8 restarts and polish, per-image path", t0)
        t0 = time.perf_counter()
        launches_train = train_phase(root, config, device, args.seed)
        phase("9 CLI train -m mpp, then infereval", t0)
        t0 = time.perf_counter()
        manual_phase(root, config, device)
        phase(f"10 CLI infereval -c {MANUAL_CONFIG} (manual mode)", t0)
        t0 = time.perf_counter()
        tiled_phase(root, config, device)
        phase(f"11 CLI infereval -c {TILED_CONFIG} (tiled, sequential)", t0)
        t0 = time.perf_counter()
        split_merge_phase(root, config, device, inference, data)
        phase(f"12 CLI infereval -c {SPLIT_MERGE_CONFIG} (split/merge), "
              "move switch", t0)
        t0 = time.perf_counter()
        launches_cnn_train = cnn_train_phase(root, device, args.seed)
        phase("13 CLI train -m posnet|shapenet, resume, infer", t0)
        t0 = time.perf_counter()
        launches_host_train = host_train_phase(root, device, host_configs())
        phase("14 CLI train -m posnet|shapenet on the host pipeline, infer",
              t0)
        t0 = time.perf_counter()
        launches_div = translation_phase(root, config, device, args.seed)
        phase("15 translators, check_div, oracle, contrast data term", t0)
        t0 = time.perf_counter()
        detector_phase(root, device, args.seed)
        phase("16 CLI train|infereval -m fasterrcnn|bbavec", t0)
        t0 = time.perf_counter()
        launches_mesh = mesh_phase(root, config, inference, data, image,
                                   device, args.seed)
        phase("17 meshes on one card: banded chain, tile and batch "
              f"splits, banded PosNet, {MESH_CONFIG}", t0)
        t0 = time.perf_counter()
        figures_phase(root, config, inference, data, result, device)
        phase("18 figures: data_preview, papangelou field, interactions, "
              "cross plots, GIF, PR curves", t0)
    finally:
        shutil.rmtree(root)

    k_ms, host_ms, p_ms, bound = main_path_kernel_times(device, args.seed)
    print(f"  time of the main-path launch (8 views of {HEIGHT}x{WIDTH}, "
          f"div_clf, logit mask): kernel {k_ms:.4f} ms on the device, "
          f"{host_ms:.4f} ms paced by the host; plain {p_ms:.4f} ms; bound "
          f"{bound:.4f} ms (bytes); {100 * bound / k_ms:.1f} % of the bound",
          flush=True)
    print(f"  detection-map launches by path: in memory {launches_cnn}, CLI "
          f"infereval {launches}, CLI train {launches_train}, CLI infer of "
          f"the trained PosNet {launches_cnn_train}, of the host-trained "
          f"PosNet {launches_host_train}, check_div {launches_div}, the "
          f"banded PosNet {launches_mesh}; phases 7, 8, 10, 11, 12, 15 and "
          f"17's chains reuse the CNN results", flush=True)
    kernels = [{
        "name": dk.KERNEL.name, "route": "cuda", "source": dk.KERNEL.source,
        "replaces": dk.KERNEL.replaces,
        "launches": launches_cnn + launches + launches_train
        + launches_cnn_train + launches_host_train + launches_div
        + launches_mesh,
        "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
    }]
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-segments", type=int, default=1,
                    help="annealing segments of the chain (341 supersteps "
                         "each at the flagship budget)")
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
