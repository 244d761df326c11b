"""Fixed-capacity struct-of-arrays point configuration, on torch tensors.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/state.py``: a
configuration is ``(xy, marks, alive)`` of capacity K with an alive mask.
The chain carries B configurations at once on a leading lane axis
(``(B, K, ...)``): the scenes of a batch, or the restarts of one scene.
``stack_lanes``, ``expand_lanes`` and ``lane`` move any dataclass of
tensors (states, caches, maps, kernel data) on and off that axis.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclass
class PointsState:
    """A rectangle configuration: marks are ``(size, ratio, angle)``."""

    xy: torch.Tensor     # ([B,] K, 2) float32, (row, col)
    marks: torch.Tensor  # ([B,] K, 3) float32
    alive: torch.Tensor  # ([B,] K) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def n_points(self) -> torch.Tensor:
        return self.alive.sum(dim=-1)

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


def stack_lanes(make: Callable[[int], object], n: int):
    """The dataclass of tensors whose lane i is ``make(i)``: each field is
    filled lane by lane into one (n, ...) tensor, so only one lane's
    inputs exist beside the stack at a time."""
    out = None
    for i in range(n):
        item = make(i)
        if out is None:
            out = {f.name: torch.empty((n,) + tuple(getattr(item, f.name)
                                                     .shape),
                                       dtype=getattr(item, f.name).dtype,
                                       device=getattr(item, f.name).device)
                   for f in fields(item)}
            cls = type(item)
        for name, t in out.items():
            t[i] = getattr(item, name)
        del item
    return cls(**out)


def expand_lanes(item, n: int):
    """``item`` seen as n identical lanes: views, no copy (restart lanes
    share one scene's maps)."""
    return type(item)(**{f.name: getattr(item, f.name).unsqueeze(0).expand(
        (n,) + tuple(getattr(item, f.name).shape)) for f in fields(item)})


def lane(item, i: int):
    """Lane ``i`` of a laned dataclass of tensors (views)."""
    return type(item)(**{f.name: getattr(item, f.name)[i]
                         for f in fields(item)})
