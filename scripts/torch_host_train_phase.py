#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: CNN training of the PyTorch port on
the host patch pipeline, on one GPU.

Builds the detection-map kernel, writes phase 13's synthetic dataset (8
train and 2 val scenes of 512^2, ``--seed``) in a temporary workspace with
its own ``paths_config.json``, and runs ``chip_smoke.host_train_phase``:
``-p train -m posnet`` on a depth-cut ``config_pos`` (hard mining) and
``-p train -m shapenet`` on ``config_shape``, a host batch's float32 loss
on the card against the CPU, one val and one profiled train epoch (the
loader's waits, device ms per step, the device's idle share), the
projected full ``config_pos``, and ``-p infer -m posnet``. It prints what
the phase prints, then its seconds. Iterating on the host pipeline's speed
costs this phase's time on the card, not the whole smoke run's.

    python3 scripts/torch_host_train_phase.py [--seed 0]
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
    from mpp_cnn_rs_object_detection_torch import native
    from mpp_cnn_rs_object_detection_torch.ops import detection_kernel as dk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_mod.nvidia_smi_line(), flush=True)
    native.load(dk.KERNEL.name)
    root = tempfile.mkdtemp(prefix="host_train_phase_")
    try:
        with open(os.path.join(root, "paths_config.json"), "w") as f:
            json.dump({"dataset_path": [os.path.join(root, "data")],
                       "model_path": [os.path.join(root, "models")]}, f)
        with cs.inside(root):
            cs.cnn_workspace(root, args.seed)
        t0 = time.perf_counter()
        launches = cs.host_train_phase(root, torch.device("cuda:0"),
                                       cs.host_configs())
        print(f"phase 14: {time.perf_counter() - t0:.3f} s; "
              f"{launches} detection-map launches", flush=True)
    finally:
        shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
