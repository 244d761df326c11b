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
     ``dota-SV/`` and every metrics JSON with finite APs, and remove its
     chain checkpoint;
  7. on phase 6's workspace (its CNN results reused), ``-p infereval -m mpp
     -c mpp_log_r12tta``: the trained combiner and calibration of that
     model store with the same depth cut, refine, score blend and backfill
     on; DOTA files and finite APs;
  8. a copy of that config with ``restarts: 2`` and ``polish_steps: 64``,
     which takes the per-image path (one scene in memory at a time): per
     scene the lanes' energies, the lane kept (the least energy) and U
     before and after polish, which must not rise;
  9. on phase 6's workspace, ``-p train -m mpp`` on a copy of the flagship
     config (depth cut: ``TRAIN_EPOCHS`` of its 8 epochs on
     ``TRAIN_CROPS`` of its 64 crops): the train subset's CNN inference (3
     kernel launches per scene), calibration, the ordering criterion over
     kernel perturbations, and both files in the JAX package's format, a
     finite loss per epoch and moved weights; then one batch alone (the
     launches of one laned move, the peak memory of its vectors) and ``-p
     infereval`` with the trained combiner: finite APs;
  10. a copy of ``MANUAL_CONFIG`` (the legacy setup's manual mode) on the
     flagship's CNNs: ``-p infereval`` calibrates (a finite threshold),
     builds ``hierarchical_fixed`` (weights summing to 1 per group) and
     runs one segment per scene: finite APs;
  11. a copy of ``TILED_CONFIG`` (tiled scene mode, sequential chain,
     manual mode) on the flagship's CNNs, depth-cut to ``TILED_BURN_IN``
     burn-in moves in segments of ``TILED_SEGMENT``: every scene's 25
     tiles as the lanes of one chain, its post-burn-in samples, finite
     APs and no checkpoint left; ms per step, the launches and device ms
     of one step, the projected full-budget seconds; then one scene killed
     after its first segment resumes from its checkpoint to the end;
  12. a copy of ``SPLIT_MERGE_CONFIG`` (exact, batched, the superstep's
     split/merge pair) with its trained calibration and combiner on the
     flagship's CNNs for one 341-superstep segment: accepted moves by
     kind, the carried cache and energy against a rebuild, finite APs;
     then on phase 3's scene with the flagship's model one in-memory
     segment with the split/merge pair and one with the switched move
     type (their energies against a rebuild; splits and merges accepted),
     and the launches and device ms of one superstep with each move set.
Then one JSON line per kernel table (its launches: every path's, each
counted from 0 -- phases 3, 6 and 9; the others reuse CNN results), the
card's name and power limit, and the result line ``{"ok": true, "device":
{...}}`` last.
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
# burn-in moves and 2 sampling intervals of 128, in segments of 4,096)
TILED_CONFIG = "mpp_hrcM"
TILED_BURN_IN, TILED_SEGMENT = 1024, 512
# its resume check: 256 burn-in moves + 2 x 128, killed after 256
RESUME_BURN_IN, RESUME_SEGMENT = 256, 256
# phase 12: the superstep's split/merge pair, trained
SPLIT_MERGE_CONFIG = "mpp_log_r10sm"
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
# ~50 ms of the card's clock: longer than the host takes to queue a timed
# run of calls
SLEEP_CYCLES = 100_000_000


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
                    blocks=None, **inference) -> str:
    """``model_configs/mpp/<base>.json`` for the synthetic dataset under
    ``root``, named ``name``, with the depth cut -- a ``max_iter`` stopping
    block of one 341-superstep segment per scene -- the config's blocks
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
    cfg["inference"]["rjmcmc_params"]["stopping"] = {
        "kind": "max_iter", "max_iter": budget.seg_super * budget.mps}
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


def run_cli(root: str, cfg_path: str, device, procedure: str = "infereval"):
    """``-p procedure -m mpp -c cfg_path`` from ``root``; returns the model
    and the seconds it took."""
    from mpp_cnn_rs_object_detection_torch.__main__ import main as cli_main

    with inside(root):
        t0 = time.perf_counter()
        model = cli_main(["-p", procedure, "-m", "mpp", "-c", cfg_path],
                         device=device)
        return model, time.perf_counter() - t0


def check_exports(root: str, model, name: str) -> dict:
    """Both scenes' result pickles, ``dota/`` and ``dota-SV/`` with every
    metrics JSON, finite APs, and no chain checkpoint left. Returns the
    APs."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.utils.config import (
        get_inference_path,
    )

    with inside(root):
        results_dir = get_inference_path(name, "synth_smoke", "val")
    assert sorted(model.results) == list(range(CLI_SCENES)), model.results
    for i in range(CLI_SCENES):
        assert os.path.exists(os.path.join(results_dir,
                                           f"{i:04}_results.pkl"))
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
        for iou in (0.05, 0.1, 0.25, 0.5, 0.75):
            with open(os.path.join(dota, f"metrics{iou:.2f}.json")) as f:
                aps[postfix, iou] = json.load(f)["vehicle"]["ap"]
    assert np.isfinite(list(aps.values())).all(), aps
    return aps


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
                               polish_steps=POLISH_STEPS)
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


def profiled(fn):
    """One call of ``fn`` under ``torch.profiler``: (device kernel
    launches, device ms)."""
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
    return (sum(int(e.count) for e in kernels),
            sum(device_us(e) for e in kernels) / 1e3)


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
          f"vectors {sec['vectors']:.3f}; steps {sec['steps']:.3f}",
          flush=True)
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
                                   ("position_model", "shape_model")}})
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
    if stops != {(341, True)}:
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
    from mpp_cnn_rs_object_detection_torch.mpp.scene import run_exact_scene

    name = f"{SPLIT_MERGE_CONFIG}_flagship_cnns"
    base = mpp_model.load_mpp_config(SPLIT_MERGE_CONFIG)
    assert base["inference"]["rjmcmc_params"]["superstep_split_merge"]
    cfg_path = mpp_config_copy(root, SPLIT_MERGE_CONFIG, name,
                               blocks={"dataset": {
                                   k: config["dataset"][k] for k in
                                   ("position_model", "shape_model")}})
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
        if r.supersteps != 341:
            raise AssertionError(f"{name} scene {i}: {r.supersteps} "
                                 "supersteps")
    sec = model.seconds
    print(f"  CLI -c {name} (exact, batched, split/merge, trained): "
          f"{t_cli:.3f} s; chains {sec['chain']:.3f} s; eval "
          f"{sec['eval']:.3f} s; {ap_line(model, aps)}", flush=True)
    # phase 3's scene, in memory, one segment with each new move set
    opts = mpp_model.chain_options(inference.config)
    opts["stopping"] = None
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
    finally:
        shutil.rmtree(root)

    k_ms, host_ms, p_ms, bound = main_path_kernel_times(device, args.seed)
    print(f"  time of the main-path launch (8 views of {HEIGHT}x{WIDTH}, "
          f"div_clf, logit mask): kernel {k_ms:.4f} ms on the device, "
          f"{host_ms:.4f} ms paced by the host; plain {p_ms:.4f} ms; bound "
          f"{bound:.4f} ms (bytes); {100 * bound / k_ms:.1f} % of the bound",
          flush=True)
    print(f"  detection-map launches by path: in memory {launches_cnn}, CLI "
          f"infereval {launches}, CLI train {launches_train}; phases 7, 8, "
          f"10, 11 and 12 reuse the CNN results", flush=True)
    kernels = [{
        "name": dk.KERNEL.name, "route": "cuda", "source": dk.KERNEL.source,
        "replaces": dk.KERNEL.replaces,
        "launches": launches_cnn + launches + launches_train,
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
