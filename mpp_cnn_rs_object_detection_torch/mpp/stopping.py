"""Stopping conditions of the segmented exact chain.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/stopping.py``
(``SegmentSummary``, the ``StopOn*`` conditions, ``CompositeStopping`` and
``stopping_from_config``, the sequential chain's ``run_chain_segmented``
and ``ChainTimer``). The chain runs in fixed-size segments and the host
checks the condition between them on one summary per segment, taken
jointly over the lanes of a batch (``batch_summary``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import run_chain


@dataclass
class SegmentSummary:
    """The state of a chain after one of its segments."""

    iter: int            # moves so far
    energy: float
    n_points: int
    temperature: float
    accept_rate: float
    seconds: float


def batch_summary(final_energy, final_n_points, accepted, proposed,
                  iter: int, temperature: float, seconds: float
                  ) -> SegmentSummary:
    """One segment's summary over the lanes of a batch, as the JAX batched
    run forms it: the mean of the lanes' final energies, their largest
    point count, and the summed accepts over the summed proposals (host
    arrays: (B,), (B,), (B, n_kernels), (B, n_kernels))."""
    acc = float(np.sum(np.asarray(accepted)))
    nprop = float(np.sum(np.asarray(proposed)))
    return SegmentSummary(
        iter=iter, energy=float(np.mean(np.asarray(final_energy))),
        n_points=int(np.max(np.asarray(final_n_points))),
        temperature=temperature, accept_rate=acc / max(nprop, 1.0),
        seconds=seconds)


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


def run_chain_segmented(gen: torch.Generator, init_state, maps, spec, comb,
                        kd, stopping: StoppingCondition, segment: int = 2000,
                        max_segments: int = 100, t0: float = 1.0,
                        alpha_t: float = 0.999, t_target: float = 0.0):
    """Segments of ``segment`` sequential steps (``rjmcmc.run_chain``, B
    lanes, draws from ``gen``) until ``stopping`` fires on the segments'
    joint summaries, threading the temperature between them. Returns
    ``(state, summaries)``."""
    summaries: List[SegmentSummary] = []
    state, temp, it = init_state, float(t0), 0
    for _ in range(max_segments):
        if stopping.do_stop(summaries):
            break
        t_start = time.perf_counter()
        state, stats = run_chain(gen, state, maps, spec, comb, kd,
                                 n_steps=segment, t0=temp, alpha_t=alpha_t,
                                 t_target=t_target)
        energy = stats.final_energy.cpu().numpy()
        it += segment
        temp = stats.final_temperature
        summaries.append(batch_summary(
            energy, stats.final_n_points.cpu().numpy(),
            stats.accepted.cpu().numpy(), stats.proposed.cpu().numpy(),
            iter=it, temperature=temp,
            seconds=time.perf_counter() - t_start))
    return state, summaries


class ChainTimer:
    """Moves per second over a chain's segments and one line per segment
    (iteration, energy, points, temperature, accept rate, seconds)."""

    def __init__(self):
        self.segments: List[SegmentSummary] = []

    def extend(self, summaries: List[SegmentSummary]):
        self.segments.extend(summaries)

    def show_results(self) -> str:
        total_iter = self.segments[-1].iter if self.segments else 0
        total_s = sum(s.seconds for s in self.segments)
        mps = total_iter / total_s if total_s else 0.0
        lines = [f"chain: {total_iter} moves in {total_s:.2f}s = "
                 f"{mps:.0f} moves/s"]
        for s in self.segments:
            lines.append(
                f"  iter {s.iter:>8} E {s.energy:>10.3f} n {s.n_points:>4} "
                f"T {s.temperature:.4f} acc {s.accept_rate:.3f} "
                f"{s.seconds:.2f}s")
        return "\n".join(lines)
