"""Sampling pixel coordinates from a 2D density map on the host.

Counterpart of ``sample_point_2d`` in
``mpp_cnn_rs_object_detection_tpu/ops/sampler2d.py`` (its numpy sampler,
which the hard-mining ``DensitySampler`` and the synthetic data draw
from): one ``rng.choice`` over the flattened density, without replacement,
so the same generator state draws the same pixels. The module's jnp
inverse-CDF samplers serve the RJMCMC proposals, whose counterparts are
in ``mpp/kernels.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sample_point_2d(img_shape: Tuple[int, int], size: int = 1,
                    density: Optional[np.ndarray] = None,
                    skip_normalization: bool = False,
                    rng: Optional[np.random.Generator] = None,
                    mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(size, 2) (row, col) pixels drawn from ``density`` (uniformly, with
    replacement, when neither it nor ``mask`` is given; without
    replacement otherwise). ``mask`` restricts a missing density to its
    true pixels and excludes its true pixels from a given density."""
    if rng is None:
        rng = np.random.default_rng()
    if density is None and mask is None:
        return rng.integers([0, 0], [img_shape[0], img_shape[1]],
                            size=(size, 2))
    if density is None:
        p = np.asarray(mask, np.float64).ravel()
    else:
        p = np.asarray(density, np.float64).ravel()
        if skip_normalization and mask is None:
            p = p.copy()
        if mask is not None:
            p = np.where(np.asarray(mask).ravel(), 0.0, p)
    p = p / p.sum()
    flat = rng.choice(p.size, size=size, replace=False, p=p)
    return np.stack(np.unravel_index(flat, img_shape), axis=-1)
