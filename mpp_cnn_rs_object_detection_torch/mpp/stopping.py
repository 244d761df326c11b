"""Stopping conditions of the segmented exact chain.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/stopping.py``
(``SegmentSummary``, the ``StopOn*`` conditions, ``CompositeStopping`` and
``stopping_from_config``; the sequential sampler's segmented runner is not
ported). The chain runs in fixed-size segments and the host checks the
condition on the per-segment summaries between them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SegmentSummary:
    """The state of a chain after one of its segments."""

    iter: int            # moves so far
    energy: float
    n_points: int
    temperature: float
    accept_rate: float
    seconds: float


class StoppingCondition:
    def do_stop(self, summaries: List[SegmentSummary]) -> bool:
        raise NotImplementedError


@dataclass
class StopOnMaxIter(StoppingCondition):
    max_iter: int

    def do_stop(self, summaries):
        return bool(summaries) and summaries[-1].iter >= self.max_iter


@dataclass
class StopOnRejects(StoppingCondition):
    """Stop after a window of (near-)total rejection."""

    n_window: int = 2
    tol: float = 1e-3
    min_iter: int = 0

    def do_stop(self, summaries):
        if not summaries or summaries[-1].iter < self.min_iter:
            return False
        last = summaries[-self.n_window:]
        return len(last) == self.n_window and all(
            s.accept_rate <= self.tol for s in last
        )


@dataclass
class StopOnDeltaU(StoppingCondition):
    """Stop when the energy stops improving by more than ``tol`` per window."""

    tol: float = 1e-4
    n_window: int = 2
    min_iter: int = 0

    def do_stop(self, summaries):
        if len(summaries) <= self.n_window:
            return False
        if summaries[-1].iter < self.min_iter:
            return False
        e = [s.energy for s in summaries[-(self.n_window + 1):]]
        return all(abs(e[i + 1] - e[i]) <= self.tol for i in range(len(e) - 1))


@dataclass
class StopOnApprovalRate(StoppingCondition):
    target_rate: float = 1e-3
    min_iter: int = 0

    def do_stop(self, summaries):
        return (
            bool(summaries)
            and summaries[-1].iter >= self.min_iter
            and summaries[-1].accept_rate <= self.target_rate
        )


@dataclass
class CompositeStopping(StoppingCondition):
    conditions: List[StoppingCondition] = field(default_factory=list)
    mode: str = "any"

    def do_stop(self, summaries):
        hits = [c.do_stop(summaries) for c in self.conditions]
        return any(hits) if self.mode == "any" else all(hits)


def stopping_from_config(cfg) -> Optional[StoppingCondition]:
    """A StoppingCondition from the ``rjmcmc_params.stopping`` config block:
    a dict ``{"kind": ..., **params}`` or a list of such dicts (combined
    with ``CompositeStopping(mode='any')``). Kinds: ``max_iter``,
    ``rejects``, ``delta_u``, ``approval_rate``. Iteration counts are in
    moves. None for a falsy config."""
    if not cfg:
        return None
    if isinstance(cfg, (list, tuple)):
        conds = [stopping_from_config(c) for c in cfg]
        return CompositeStopping(conditions=[c for c in conds if c],
                                 mode="any")
    kinds = {
        "max_iter": StopOnMaxIter,
        "rejects": StopOnRejects,
        "delta_u": StopOnDeltaU,
        "approval_rate": StopOnApprovalRate,
    }
    params = dict(cfg)
    kind = params.pop("kind")
    return kinds[kind](**params)
