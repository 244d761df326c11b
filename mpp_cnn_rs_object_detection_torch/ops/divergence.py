"""Divergence of 2D vector fields with np.gradient edge semantics, in torch.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/ops/divergence.py``. The
fields may carry leading batch dimensions: the two spatial axes are the last
two of each component (``(..., H, W)``), and of the vector field
``(..., H, W, 2)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def gradient_1d(f: torch.Tensor, axis: int, spacing: float = 1.0) -> torch.Tensor:
    """np.gradient along one axis: central differences inside, one-sided edges."""
    f = torch.movedim(f, axis, 0)
    interior = (f[2:] - f[:-2]) / (2.0 * spacing)
    first = (f[1:2] - f[0:1]) / spacing
    last = (f[-1:] - f[-2:-1]) / spacing
    g = torch.cat([first, interior, last], dim=0)
    return torch.movedim(g, 0, axis)


def divergence_ij(components: Sequence[torch.Tensor],
                  spacing: Optional[Sequence[float]] = None) -> torch.Tensor:
    """'ij' divergence of ``(..., H, W)`` components: d(c0)/dH + d(c1)/dW."""
    if spacing is None:
        spacing = [1.0, 1.0]
    return (gradient_1d(components[0], axis=-2, spacing=spacing[0])
            + gradient_1d(components[1], axis=-1, spacing=spacing[1]))


def divergence_map_from_vector_field(vector_field: torch.Tensor,
                                     normalize: bool = True) -> torch.Tensor:
    """Divergence of an ``(..., H, W, 2)`` field, optionally unit-normalised.

    Keeps the reference quirk: the spacing is ``H/(H-1)`` on BOTH axes."""
    size = vector_field.shape[-3]
    sp = size / (size - 1.0)
    if normalize:
        norm = torch.linalg.vector_norm(vector_field, dim=-1, keepdim=True)
        vec = torch.where(
            norm > 0, vector_field / torch.where(norm > 0, norm, 1.0), 0.0
        )
    else:
        vec = vector_field
    return divergence_ij([vec[..., 0], vec[..., 1]], spacing=[sp, sp])
