"""Segments of the exact whole-scene chain (single device).

Counterpart of ``run_exact_scene_chain`` in
``mpp_cnn_rs_object_detection_tpu/parallel/sharded_scene.py`` for
``mesh=None``: run ``n_supersteps`` cell-parallel supersteps on the whole
maps and return the state, the carried cache (pass it back to continue
without an O(K^2) rebuild) and the segment's stats. The row-sharded mesh
variant is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mpp_cnn_rs_object_detection_torch.mpp.combinators import EnergyCombiner
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
)
from mpp_cnn_rs_object_detection_torch.mpp.kernels import KernelData
from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import (
    CELL,
    chain_stats,
    make_parallel_step,
    run_steps,
)
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    ChainStats,
    EnergyCache,
    build_cache,
    energy_from_cache,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import PointsState


def run_exact_scene_chain(gen: torch.Generator, init_state: PointsState,
                          maps: EnergyMaps, spec: EnergySpec,
                          comb: EnergyCombiner, kd: KernelData,
                          n_supersteps: int, t0: float = 1.0,
                          alpha_t: float = 0.999, t_target: float = 0.0,
                          cache: Optional[EnergyCache] = None,
                          data_moves: bool = True,
                          ) -> Tuple[PointsState, EnergyCache, ChainStats]:
    h, w = maps.position.shape
    if cache is None:
        cache = build_cache(init_state, maps, spec)
    u0 = energy_from_cache(init_state, maps, spec, comb, cache)
    n_cells = max(h, w) // (2 * CELL) + 1
    step = make_parallel_step(maps, spec, comb, kd, alpha_t, t_target,
                              n_cells, data_moves=data_moves)
    (state, cache, energy, temp), acc, prop = run_steps(
        step, init_state, cache, u0, t0, n_supersteps, gen)
    return state, cache, chain_stats(kd, acc, prop, energy, state, temp)
