#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: the baseline detectors of the
PyTorch port (Faster R-CNN and BBAVectors' CTRBOX) on one GPU.

Writes phase 13's synthetic dataset (8 train and 2 val scenes of 512^2,
``--seed``) in a temporary workspace with its own ``paths_config.json``
and runs ``chip_smoke.detector_phase``: for depth-cut, full-width copies of
``config_fasterrcnn`` and ``config_bba_vec``, ``-p train`` and ``-p
infereval`` through the CLI, a float32 step on the card against the CPU,
one profiled bf16 step (launches, device and wall ms, the idle share, the
greedy NMS's host ms, peak memory) and the projected full training. It
prints what the phase prints, then its seconds. Work on the detectors'
speed costs this phase's time on the card, not the whole smoke run's.

    python3 scripts/torch_detector_phase.py [--seed 0]
"""

from __future__ import annotations

import argparse
import json
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_mod.nvidia_smi_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    root = tempfile.mkdtemp(prefix="detector_phase_")
    try:
        with open(os.path.join(root, "paths_config.json"), "w") as f:
            json.dump({"dataset_path": [os.path.join(root, "data")],
                       "model_path": [os.path.join(root, "models")]}, f)
        with cs.inside(root):
            cs.cnn_workspace(root, args.seed)
        t0 = time.perf_counter()
        cs.detector_phase(root, torch.device("cuda:0"), args.seed)
        print(f"phase 16: {time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
