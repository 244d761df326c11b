#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: the meshes of the PyTorch port on
one GPU, as ``[cuda:0] * n``.

Loads the flagship's models (``chip_smoke.load_models``: the checkpointed
PosNet and the others drawn from ``--seed``), computes phase 3's scene
maps in memory, writes phase 6's workspace (2 val scenes of 958x926 with
their CNN results) in a temporary directory with its own
``paths_config.json``, and runs ``chip_smoke.mesh_phase``: the banded
chain at 1, 2 and 4 bands against one band, the tile and batch splits,
the banded PosNet and the kernel on its planes, and ``-p infereval`` on a
copy of ``mpp_r2`` (which here also runs the train subset's CNN
inference for its calibration). It prints what the phase prints, then
its seconds.

    python3 scripts/torch_mesh_phase.py [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mpp_cnn_rs_object_detection_torch import device as device_mod
    from mpp_cnn_rs_object_detection_torch.data.synth import synthetic_scene
    from mpp_cnn_rs_object_detection_torch.mpp import mpp_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_mod.nvidia_smi_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda:0")
    config = mpp_model.load_mpp_config(cs.MPP_CONFIG)
    pos_models, shape_model = cs.load_models(config, device, args.seed)
    setup, comb = mpp_model.load_energy_model(
        config, os.path.join(mpp_model.MODELS_ROOT, "mpp",
                             config["model_name"]), device)
    inference = mpp_model.SceneInference(config, pos_models, shape_model,
                                         setup, comb, device)
    image, _, _ = synthetic_scene(cs.HEIGHT, cs.WIDTH, cs.OBJECTS,
                                  seed=args.seed)
    data = inference.cnn_maps(image, name="synthetic")
    root = tempfile.mkdtemp(prefix="mesh_phase_")
    try:
        cs.cli_workspace(root, config, device, args.seed)
        with cs.inside(root):
            mpp_model.ensure_cnn_inference(
                "synth_smoke", "val", config["dataset"]["position_model"],
                config["dataset"]["shape_model"], device)
        t0 = time.perf_counter()
        cs.mesh_phase(root, config, inference, data, image, device,
                      args.seed)
        print(f"phase 17: {time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
