"""Dihedral-group (D4) test-time augmentation for the CNN maps, in torch.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/ops/dihedral.py``: arrays
are ``(H, W, ...)`` tensors (axis 0 = row), a group element ``(k, flip)`` is
flip-up-down first (if ``flip``), then ``k`` counter-clockwise quarter turns
(``torch.rot90`` on dims (0, 1), which matches ``np.rot90``). Angle bins are
permuted exactly by the group action when the bin count is even.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

D4_ELEMENTS: Tuple[Tuple[int, bool], ...] = tuple(
    (k, flip) for flip in (False, True) for k in range(4)
)


def transform_image(arr: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """Apply (k, flip) to an (H, W, ...) tensor: flipud first, then rot90^k."""
    if flip:
        arr = torch.flip(arr, dims=(0,))
    return torch.rot90(arr, k, dims=(0, 1))


def inverse_transform_map(arr: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """Pull a map predicted in the transformed frame back to the original."""
    arr = torch.rot90(arr, -k, dims=(0, 1))
    if flip:
        arr = torch.flip(arr, dims=(0,))
    return arr


def transform_points(pts: np.ndarray, h: int, w: int, k: int, flip: bool
                     ) -> np.ndarray:
    """Map (N, 2) ``(row, col)`` points of an (h, w) image into the
    transformed image's coordinates (``out[transform_points(p)] == in[p]``)."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2).copy()
    if flip:
        pts[:, 0] = (h - 1) - pts[:, 0]
    for _ in range(k % 4):
        pts = np.stack([(w - 1) - pts[:, 1], pts[:, 0]], axis=-1)
        h, w = w, h
    return pts


def view_index_map(k: int, flip: bool, h: int, w: int
                   ) -> Tuple[int, int, int, int, int, int]:
    """Integer affine map ``(a0, ai, aj, b0, bi, bj)`` of the element
    ``(k, flip)``: pixel ``(i, j)`` of an (h, w) image lies at ``(a0 + ai*i
    + aj*j, b0 + bi*i + bj*j)`` of the transformed image -- the same map as
    :func:`transform_points`, as six integers for the detection-map kernel."""
    a0, ai, aj, b0, bi, bj = 0, 1, 0, 0, 0, 1
    if flip:
        a0, ai, aj = (h - 1) - a0, -ai, -aj
    for _ in range(k % 4):
        a0, ai, aj, b0, bi, bj = (w - 1) - b0, -bi, -bj, a0, ai, aj
        h, w = w, h
    return a0, ai, aj, b0, bi, bj


def angle_gather_indices(n_classes: int, k: int, flip: bool) -> np.ndarray:
    """Index array ``g`` with ``dist_original = dist_transformed[..., g]``."""
    assert n_classes % 2 == 0, "angle TTA needs an even bin count"
    i = np.arange(n_classes)
    shift = (k % 4) * (n_classes // 2)
    if flip:
        return (shift - i - 1) % n_classes
    return (i + shift) % n_classes


def tta_dist_maps(infer_fn: Callable[[torch.Tensor], List[torch.Tensor]],
                  image: torch.Tensor, cyclic: Sequence[bool],
                  elements: Sequence[Tuple[int, bool]] = D4_ELEMENTS,
                  ) -> List[torch.Tensor]:
    """Mean over the group of the per-pixel categorical maps ``[(H, W, C)]``;
    ``cyclic[m]`` marks the angle map, whose bins the group permutes."""
    acc = None
    for k, flip in elements:
        pulled = []
        for m, d in enumerate(infer_fn(transform_image(image, k, flip))):
            d = inverse_transform_map(d, k, flip)
            if cyclic[m]:
                g = torch.as_tensor(angle_gather_indices(d.shape[-1], k, flip),
                                    device=d.device)
                d = d[..., g]
            pulled.append(d)
        acc = pulled if acc is None else [a + p for a, p in zip(acc, pulled)]
    return [a / float(len(elements)) for a in acc]
