"""Fixed-capacity struct-of-arrays point configuration, on torch tensors.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/state.py``: a
configuration is ``(xy, marks, alive)`` of capacity K with an alive mask.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class PointsState:
    """A rectangle configuration: marks are ``(size, ratio, angle)``."""

    xy: torch.Tensor     # (K, 2) float32, (row, col)
    marks: torch.Tensor  # (K, 3) float32
    alive: torch.Tensor  # (K,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @property
    def n_points(self) -> torch.Tensor:
        return self.alive.sum()

    def replace(self, **kw) -> "PointsState":
        return replace(self, **kw)


def empty_state(capacity: int, device="cpu") -> PointsState:
    return PointsState(
        xy=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        marks=torch.ones((capacity, 3), dtype=torch.float32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def state_from_arrays(xy, marks, capacity: Optional[int] = None,
                      device="cpu") -> PointsState:
    """Build a state from (N, 2)/(N, 3) host arrays, padding to ``capacity``."""
    xy = np.asarray(xy, np.float32).reshape(-1, 2)
    marks = np.asarray(marks, np.float32).reshape(-1, 3)
    n = len(xy)
    cap = capacity or max(n, 1)
    assert n <= cap, f"{n} points exceed capacity {cap}"
    st = empty_state(cap, device)
    st.xy[:n] = torch.from_numpy(xy).to(device)
    st.marks[:n] = torch.from_numpy(marks).to(device)
    st.alive[:n] = True
    return st


def state_to_arrays(state: PointsState) -> Tuple[np.ndarray, np.ndarray]:
    """The alive points as host (N, 2), (N, 3) arrays."""
    alive = state.alive.cpu().numpy()
    return state.xy.cpu().numpy()[alive], state.marks.cpu().numpy()[alive]
