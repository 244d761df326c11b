"""Detection-map stencil: the CUDA kernel's wrapper and its plain version.

Replaces ``mpp_cnn_rs_object_detection_tpu/ops/pallas_kernels.py:
detection_map_fused`` (the repo's one Pallas kernel) with the hand-written
Hopper kernel in ``native/detection_map.cu``, and extends it with the
DivClassifier epilogue so that the PosNet's main inference path launches it.

Epilogues (the ``epilogue`` argument):
  - ``"detection"``: unit-normalised vectors, spacing ``H/(H-1)``,
    ``clip(-div/2, 0, 1) * mask`` -- exactly the TPU kernel;
  - ``"div_clf"``: raw vectors, spacing 1, ``sigmoid(w * div * mask + b)``
    with the 1x1 conv's scalar weight and bias.
``mask_is_logit`` applies a sigmoid to the mask before either epilogue.

A CPU tensor takes the plain version (the ``ops/divergence.py``
composition); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from mpp_cnn_rs_object_detection_torch.ops.divergence import (
    divergence_ij,
    divergence_map_from_vector_field,
)

EPILOGUES = {"detection": 0, "div_clf": 1}


class DetectionMapKernel:
    """Launch counter and lazily loaded library of the CUDA kernel."""

    name = "detection_map"
    source = "mpp_cnn_rs_object_detection_torch/native/detection_map.cu"
    replaces = "mpp_cnn_rs_object_detection_tpu/ops/pallas_kernels.py:62"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def function(self):
        if self._fn is None:
            from mpp_cnn_rs_object_detection_torch import native

            lib, _ = native.load(self.name)
            fn = lib.detection_map_launch
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


KERNEL = DetectionMapKernel()

VecArg = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _split_vec(vec: VecArg):
    """(vx, vy, element stride, whole channels-last tensor or None)."""
    if isinstance(vec, torch.Tensor):
        if vec.ndim < 3 or vec.shape[-1] != 2:
            raise ValueError(f"vector field must be (..., H, W, 2), got "
                             f"{tuple(vec.shape)}")
        return vec[..., 0], vec[..., 1], 2, vec
    vx, vy = vec
    if vx.shape != vy.shape or vx.ndim < 2:
        raise ValueError("vector planes must share one (..., H, W) shape")
    return vx, vy, 1, None


def detection_map_plain(vec: VecArg, mask: torch.Tensor,
                        mask_is_logit: bool = True,
                        epilogue: str = "detection",
                        clf_w: float = 1.0, clf_b: float = 0.0
                        ) -> torch.Tensor:
    """The plain PyTorch composition the kernel is held against."""
    vx, vy, _, _ = _split_vec(vec)
    m = torch.sigmoid(mask) if mask_is_logit else mask
    if epilogue == "detection":
        div = divergence_map_from_vector_field(
            torch.stack([vx, vy], dim=-1), normalize=True
        )
        return torch.clamp(-div / 2.0, 0.0, 1.0) * m
    if epilogue == "div_clf":
        div = divergence_ij([vx, vy])
        return torch.sigmoid((div * m) * clf_w + clf_b)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def detection_map(vec: VecArg, mask: torch.Tensor, mask_is_logit: bool = True,
                  epilogue: str = "detection", clf_w: float = 1.0,
                  clf_b: float = 0.0) -> torch.Tensor:
    """``(..., H, W, 2)`` vectors (or a ``(vx, vy)`` pair of ``(..., H, W)``
    planes) and an ``(..., H, W)`` mask -> ``(..., H, W)`` map.

    CPU tensors go through :func:`detection_map_plain`; CUDA tensors through
    the kernel, which takes float32, contiguous inputs with H, W >= 2."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    vx, vy, stride, whole = _split_vec(vec)
    if mask.device.type == "cpu" and vx.device.type == "cpu":
        return detection_map_plain(vec, mask, mask_is_logit, epilogue,
                                   clf_w, clf_b)
    if vx.device.type != "cuda" or mask.device != vx.device:
        raise ValueError("detection_map: inputs must share one CUDA device "
                         "(or all lie on the CPU)")
    h, w = mask.shape[-2], mask.shape[-1]
    if tuple(vx.shape) != tuple(mask.shape):
        raise ValueError(f"vector field {tuple(vx.shape)} and mask "
                         f"{tuple(mask.shape)} disagree")
    if h < 2 or w < 2:
        raise ValueError(f"detection_map needs H, W >= 2, got {(h, w)}")
    srcs = [whole] if whole is not None else [vx, vy]
    for t in srcs + [mask]:
        if t.dtype != torch.float32:
            raise TypeError(f"detection_map takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("detection_map takes contiguous tensors")
    batch = 1
    for d in mask.shape[:-2]:
        batch *= int(d)
    out = torch.empty_like(mask)
    inv_spacing = (h - 1.0) / h if epilogue == "detection" else 1.0
    fn = KERNEL.function()
    if whole is not None:
        px = whole.data_ptr()
        py = px + whole.element_size()
    else:
        px, py = vx.data_ptr(), vy.data_ptr()
    err = fn(
        ctypes.c_void_p(px), ctypes.c_void_p(py), stride,
        ctypes.c_void_p(mask.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        batch, h, w, EPILOGUES[epilogue], int(bool(mask_is_logit)),
        float(inv_spacing), float(clf_w), float(clf_b),
        ctypes.c_void_p(torch.cuda.current_stream(mask.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"detection_map kernel launch failed "
                           f"(cudaError {err})")
    KERNEL.launches += 1
    return out
