"""Detection-map stencil: the CUDA kernel's wrappers and their plain versions.

Replaces ``mpp_cnn_rs_object_detection_tpu/ops/pallas_kernels.py:
detection_map_fused`` (the repo's one Pallas kernel) with the hand-written
Hopper kernel in ``native/detection_map.cu``, which also takes over the
dihedral TTA around it: one launch reads the U-Net head output of each of
the 8 views and writes the mean of their detection maps in the original
frame (``detection_map_tta``).

Epilogues (the ``epilogue`` argument):
  - ``"detection"``: unit-normalised vectors, spacing ``h/(h-1)`` in each
    view's own frame, ``clip(-div/2, 0, 1) * mask`` -- exactly the TPU
    kernel;
  - ``"div_clf"``: raw vectors, spacing 1, ``sigmoid(w * div * mask + b)``
    with the 1x1 conv's scalar weight and bias.
``mask_is_logit`` applies a sigmoid to the mask before either epilogue.

CPU tensors take the plain versions (the ``ops/divergence.py`` and
``ops/dihedral.py`` compositions); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple, Union

import torch

from mpp_cnn_rs_object_detection_torch.ops.dihedral import (
    inverse_transform_map,
    view_index_map,
)
from mpp_cnn_rs_object_detection_torch.ops.divergence import (
    divergence_ij,
    divergence_map_from_vector_field,
)

EPILOGUES = {"detection": 0, "div_clf": 1}
MAX_VIEWS = 8


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
            fn = lib.detection_map_tta_launch
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


KERNEL = DetectionMapKernel()

VecArg = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class View(NamedTuple):
    """One TTA view as the kernel takes it.

    ``planes``: the (3, Hp, P) fp32 head output ``[vx, vy, mask]`` with unit
    column stride and a row pitch ``P = planes.stride(1)`` that is a multiple
    of 4 (16-byte rows); ``crop``: the view's own (h, w) frame at the
    planes' origin (what lies beyond it is never read); ``element``: the
    dihedral element ``(k, flip)`` that made the view from the original
    image (``ops/dihedral.py``)."""

    planes: torch.Tensor
    crop: Tuple[int, int]
    element: Tuple[int, bool] = (0, False)


def _split_vec(vec: VecArg):
    """(vx, vy, whole channels-last tensor or None)."""
    if isinstance(vec, torch.Tensor):
        if vec.ndim < 3 or vec.shape[-1] != 2:
            raise ValueError(f"vector field must be (..., H, W, 2), got "
                             f"{tuple(vec.shape)}")
        return vec[..., 0], vec[..., 1], vec
    vx, vy = vec
    if vx.shape != vy.shape or vx.ndim < 2:
        raise ValueError("vector planes must share one (..., H, W) shape")
    return vx, vy, None


def detection_map_plain(vec: VecArg, mask: torch.Tensor,
                        mask_is_logit: bool = True,
                        epilogue: str = "detection",
                        clf_w: float = 1.0, clf_b: float = 0.0
                        ) -> torch.Tensor:
    """The plain PyTorch composition of one view's map."""
    vx, vy, _ = _split_vec(vec)
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


def _check_views(views: Sequence[View], out_hw: Tuple[int, int],
                 epilogue: str) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if not 1 <= len(views) <= MAX_VIEWS:
        raise ValueError(f"detection_map_tta takes 1 to {MAX_VIEWS} views, "
                         f"got {len(views)}")
    h, w = out_hw
    for view in views:
        crop = (w, h) if view.element[0] % 2 else (h, w)
        if tuple(view.crop) != crop:
            raise ValueError(f"view {view.element} of an {(h, w)} frame has "
                             f"the crop {crop}, got {tuple(view.crop)}")
        if min(crop) < 2:
            raise ValueError(f"detection map needs crops of at least 2 x 2, "
                             f"got {crop}")
        if (view.planes.ndim != 3 or view.planes.shape[0] != 3
                or view.planes.shape[1] < crop[0]
                or view.planes.shape[2] < crop[1]):
            raise ValueError(f"planes must be (3, Hp, P) around the crop "
                             f"{crop}, got {tuple(view.planes.shape)}")


def detection_map_tta_plain(views: Sequence[View], out_hw: Tuple[int, int],
                            mask_is_logit: bool = True,
                            epilogue: str = "detection", clf_w: float = 1.0,
                            clf_b: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`detection_map_tta`: each view's cropped
    planes through :func:`detection_map_plain`, pulled back to the original
    frame, summed in the views' order and divided by their count."""
    _check_views(views, out_hw, epilogue)
    acc = None
    for view in views:
        h, w = view.crop
        p = view.planes[:, :h, :w]
        m = inverse_transform_map(
            detection_map_plain((p[0], p[1]), p[2], mask_is_logit, epilogue,
                                clf_w, clf_b), *view.element)
        acc = m if acc is None else acc + m
    return acc / float(len(views))


def _launch(fields, n_views: int, batch: int, out_hw: Tuple[int, int],
            device: torch.device, mask_is_logit: bool, epilogue: str,
            clf_w: float, clf_b: float) -> torch.Tensor:
    """One launch; ``fields`` packs 12 integers per view as the C entry
    point reads them."""
    out = torch.empty((batch,) + tuple(out_hw), dtype=torch.float32,
                      device=device)
    err = KERNEL.function()(
        (ctypes.c_longlong * len(fields))(*fields), n_views,
        out.data_ptr(), batch, out_hw[0], out_hw[1], EPILOGUES[epilogue],
        int(bool(mask_is_logit)), float(clf_w), float(clf_b),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"detection_map kernel launch failed (code "
                           f"{err}: a cudaError, or -1 no tensor-map "
                           f"encoder, -2 a refused tensor map)")
    KERNEL.launches += 1
    return out


def detection_map_tta(views: Sequence[View], out_hw: Tuple[int, int],
                      mask_is_logit: bool = True, epilogue: str = "detection",
                      clf_w: float = 1.0, clf_b: float = 0.0) -> torch.Tensor:
    """Mean over ``views`` of each view's detection map pulled back to the
    original (H, W) = ``out_hw`` frame, in one kernel launch.

    CPU planes go through :func:`detection_map_tta_plain`. CUDA planes must
    be float32 on one device, 16-byte aligned, with unit column stride and
    a row and plane stride that are multiples of 4 elements; each view
    must be held alive by the caller until the launch returns."""
    _check_views(views, out_hw, epilogue)
    device = views[0].planes.device
    if all(v.planes.device.type == "cpu" for v in views):
        return detection_map_tta_plain(views, out_hw, mask_is_logit,
                                       epilogue, clf_w, clf_b)
    fields = []
    for view in views:
        planes = view.planes
        if planes.device != device or device.type != "cuda":
            raise ValueError("detection_map_tta: planes must share one CUDA "
                             "device (or all lie on the CPU)")
        if planes.dtype != torch.float32:
            raise TypeError(f"detection_map_tta takes float32, got "
                            f"{planes.dtype}")
        plane_stride, pitch, col = planes.stride()
        if col != 1 or pitch % 4 or plane_stride % 4 \
                or planes.data_ptr() % 16:
            raise ValueError(f"planes need unit column stride, a row pitch "
                             f"and plane stride that are multiples of 4 and "
                             f"16-byte alignment, got strides "
                             f"{planes.stride()}")
        fields += [planes.data_ptr(), plane_stride, 3 * plane_stride, pitch,
                   *view.crop, *view_index_map(*view.element, *out_hw)]
    return _launch(fields, len(views), 1, out_hw, device, mask_is_logit,
                   epilogue, clf_w, clf_b)[0]


def detection_map(vec: VecArg, mask: torch.Tensor, mask_is_logit: bool = True,
                  epilogue: str = "detection", clf_w: float = 1.0,
                  clf_b: float = 0.0) -> torch.Tensor:
    """``(..., H, W, 2)`` vectors (or a ``(vx, vy)`` pair of ``(..., H, W)``
    planes) and an ``(..., H, W)`` mask -> ``(..., H, W)`` map.

    CPU tensors go through :func:`detection_map_plain`. CUDA tensors must be
    float32 and contiguous with H, W >= 2; the wrapper copies them into one
    pitched (3, H, P) buffer per map (P = W rounded up to a multiple of 4)
    and launches the kernel once, with one identity view per map. The copy
    keeps this entry point off the flagship path, which hands the head
    output to :func:`detection_map_tta` as it is."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    vx, vy, whole = _split_vec(vec)
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
    batch = mask.numel() // (h * w)
    pitch = -(-w // 4) * 4
    buf = torch.empty((batch, 3, h, pitch), dtype=torch.float32,
                      device=mask.device)
    for c, src in enumerate((vx, vy, mask)):
        buf[:, c, :, :w] = src.reshape(batch, h, w)
    fields = [buf.data_ptr(), h * pitch, 3 * h * pitch, pitch, h, w,
              *view_index_map(0, False, h, w)]
    out = _launch(fields, 1, batch, (h, w), mask.device, mask_is_logit,
                  epilogue, clf_w, clf_b)
    return out.reshape(mask.shape)
