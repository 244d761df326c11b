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
     and energy against a rebuild;
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
     per scene, write both result pickles, ``dota/`` and ``dota-SV/`` and
     every metrics JSON with finite APs, and remove its chain checkpoint.
Then one JSON line per kernel table, the card's name and power limit, and
the result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

MPP_CONFIG = "mpp_log_r12ttapar"
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
        rjmcmc_params_from_config,
    )
    from mpp_cnn_rs_object_detection_torch.mpp.scene import (
        scene_shape_bucket,
        superstep_budget,
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

    mpp_dst = os.path.join(models, "mpp", config["model_name"])
    os.makedirs(mpp_dst)
    for f in ("config.json", "calibration.json",
              "energy_combination_model.json"):
        shutil.copy(os.path.join(MODELS_ROOT, "mpp", config["model_name"], f),
                    mpp_dst)
    # the depth cut: stop each scene's chain after its first segment
    h, w = scene_shape_bucket(HEIGHT, WIDTH)
    budget = superstep_budget(h, w, rjmcmc_params_from_config(config),
                              config["inference"].get("segment_size", 4096))
    assert budget.seg_super == 341, budget
    cut = json.loads(json.dumps(config))
    cut["dataset"]["dataset"] = "synth_smoke"
    cut["inference"]["rjmcmc_params"]["stopping"] = {
        "kind": "max_iter", "max_iter": budget.seg_super * budget.mps}
    path = os.path.join(root, MPP_CONFIG + ".json")
    with open(path, "w") as f:
        json.dump(cut, f, indent=1)
    return path


def cli_phase(config, device, seed: int) -> int:
    """Phase 6; returns the detection-map kernel launches it counted."""
    import numpy as np

    from mpp_cnn_rs_object_detection_torch.__main__ import main as cli_main
    from mpp_cnn_rs_object_detection_torch.ops import (
        detection_kernel as dk,
    )
    from mpp_cnn_rs_object_detection_torch.utils.config import (
        get_inference_path,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        cfg_path = cli_workspace(root, config, device, seed)
        print(f"  workspace (dataset, model store, config): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        os.chdir(root)
        dk.KERNEL.launches = 0
        t0 = time.perf_counter()
        model = cli_main(["-p", "infereval", "-m", "mpp", "-c", cfg_path],
                         device=device)
        t_cli = time.perf_counter() - t0
        launches = dk.KERNEL.launches
        sec = model.seconds
        print(f"  CLI -p infereval -m mpp: {t_cli:.3f} s; "
              f"ensure_cnn_inference {sec['cnn'] + sec['host']:.3f} s "
              f"(U-Net + kernel {sec['cnn']:.3f} s, host {sec['host']:.3f} s"
              f" of which distance NMS {sec['nms']:.3f} s and ShapeNet mark "
              f"decoding {sec['decode']:.3f} s); load maps "
              f"{sec['load']:.3f} s; chains "
              f"{sec['chain']:.3f} s; export {sec['export']:.3f} s + eval "
              f"{sec['eval']:.3f} s = {sec['export'] + sec['eval']:.3f} s",
              flush=True)
        n_pos = len(config["dataset"]["position_model"]) + 1
        if launches != n_pos * CLI_SCENES:
            raise AssertionError(f"expected {n_pos * CLI_SCENES} detection-"
                                 f"map launches, counted {launches}")
        results_dir = get_inference_path(config["model_name"],
                                         "synth_smoke", "val")
        for r in model.results.values():
            assert r.stopped and r.supersteps == 341, (r.supersteps,
                                                       r.stopped)
        for i in range(CLI_SCENES):
            assert os.path.exists(os.path.join(results_dir,
                                               f"{i:04}_results.pkl"))
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
        n_det = sum(len(r.scores) for r in model.results.values())
        print(f"  {launches} detection-map launches ({n_pos} per scene); "
              f"{n_det} detections over {CLI_SCENES} scenes; AP@0.05 "
              f"{aps['', 0.05]:.4f} (SV {aps['-SV', 0.05]:.4f}), AP@0.5 "
              f"{aps['', 0.5]:.4f} (SV {aps['-SV', 0.5]:.4f})", flush=True)
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(root)


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
        from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
            build_cache,
            energy_from_cache,
        )
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
    fresh = build_cache(chain.state, chain.maps, setup.spec)
    alive = chain.state.alive
    pair = alive[:, None] & alive[None, :]
    for f in ("dist", "overlap", "align"):
        a, b = getattr(chain.cache, f)[pair], getattr(fresh, f)[pair]
        diff = float((a - b).abs().max()) if a.numel() else 0.0
        if diff > CACHE_TOL * max(1.0, float(b.abs().max()) if b.numel()
                                  else 1.0):
            raise AssertionError(f"carried cache {f} off by {diff}")
    u_fresh = float(energy_from_cache(chain.state, chain.maps, setup.spec,
                                      comb, fresh))
    print(f"  carried energy {energy:.4f} vs rebuilt {u_fresh:.4f}",
          flush=True)
    if abs(u_fresh - energy) > 1e-3 * max(1.0, abs(u_fresh)):
        raise AssertionError("carried energy disagrees with a rebuild")
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

    # ---- 6. the command line on a dataset, counts from 0
    t0 = time.perf_counter()
    launches = cli_phase(config, device, args.seed)
    phase("6 CLI infereval on a dataset", t0)

    k_ms, host_ms, p_ms, bound = main_path_kernel_times(device, args.seed)
    print(f"  time of the main-path launch (8 views of {HEIGHT}x{WIDTH}, "
          f"div_clf, logit mask): kernel {k_ms:.4f} ms on the device, "
          f"{host_ms:.4f} ms paced by the host; plain {p_ms:.4f} ms; bound "
          f"{bound:.4f} ms (bytes); {100 * bound / k_ms:.1f} % of the bound",
          flush=True)
    kernels = [{
        "name": dk.KERNEL.name, "route": "cuda", "source": dk.KERNEL.source,
        "replaces": dk.KERNEL.replaces, "launches": launches,
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
