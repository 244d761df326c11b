"""The divergence cross-check of ``main.py -p check_div``.

A seeded (128, 128, 2) vector field and (128, 128) mask logits go through
the numpy divergence (``np.gradient`` over the reference's spacing,
128/127 on both axes), the port's ``ops/divergence.py`` and the detection
map: on the CUDA device the hand-written kernel
(``ops/detection_kernel.py:detection_map``) against its plain PyTorch
version; on the CPU the plain version against the numpy map, since the
kernel runs only on the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device
from mpp_cnn_rs_object_detection_torch.ops.detection_kernel import (
    detection_map,
    detection_map_plain,
)
from mpp_cnn_rs_object_detection_torch.ops.divergence import (
    divergence_map_from_vector_field,
)

SIZE = 128


def check_div(device=None) -> Dict[str, float]:
    """Print and return the largest absolute errors: ``divergence`` (numpy
    vs the port), then ``kernel`` (the CUDA kernel vs its plain version)
    on the card or ``plain`` (the plain map vs numpy's) on the CPU."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(SIZE, SIZE, 2)).astype(np.float32)
    mask = rng.normal(size=(SIZE, SIZE)).astype(np.float32)
    norm = np.linalg.norm(vec, axis=-1) + 1e-30
    axis = np.linspace(0, SIZE, SIZE)
    d_np = (np.gradient(vec[..., 0] / norm, axis, axis=0)
            + np.gradient(vec[..., 1] / norm, axis, axis=1))
    vec_t = torch.from_numpy(vec).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    d_t = divergence_map_from_vector_field(vec_t, normalize=True)
    errors = {"divergence": float(np.abs(d_np - d_t.cpu().numpy()).max())}
    print(f"numpy vs torch divergence: max |err| = "
          f"{errors['divergence']:.2e}")
    plain = detection_map_plain(vec_t, mask_t)
    if dev.type == "cuda":
        kernel = detection_map(vec_t, mask_t)
        errors["kernel"] = float((kernel - plain).abs().max())
        print(f"torch vs CUDA kernel detection map: max |err| = "
              f"{errors['kernel']:.2e}")
    else:
        ref = np.clip(-d_np / 2.0, 0.0, 1.0) / (1.0 + np.exp(-mask))
        errors["plain"] = float(np.abs(plain.numpy() - ref).max())
        print(f"numpy vs torch detection map: max |err| = "
              f"{errors['plain']:.2e}; the kernel line needs the CUDA "
              "device")
    return errors
