"""Segments of the exact whole-scene chain (single device).

Counterpart of ``run_exact_scene_chain`` in
``mpp_cnn_rs_object_detection_tpu/parallel/sharded_scene.py`` for
``mesh=None``: run ``n_supersteps`` cell-parallel supersteps on the whole
maps of every lane (the state, maps and kernel data carry a leading lane
axis B; ``gens`` holds one generator per lane) and return the states, the
carried cache (pass it back to continue without an O(K^2) rebuild) and the
segment's per-lane stats, with the accepted proposals by kind. One launch
sequence per superstep serves all B lanes, where the JAX package vmaps the
one-lane chain. The row-sharded mesh variant is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mpp_cnn_rs_object_detection_torch.mpp.combinators import EnergyCombiner
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
)
from mpp_cnn_rs_object_detection_torch.mpp.kernels import KernelData
from mpp_cnn_rs_object_detection_torch.mpp.parallel_sampler import (
    CELL,
    N_KINDS,
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


def run_exact_scene_chain(gens: Sequence[torch.Generator],
                          init_state: PointsState,
                          maps: EnergyMaps, spec: EnergySpec,
                          comb: EnergyCombiner, kd: KernelData,
                          n_supersteps: int, t0: float = 1.0,
                          alpha_t: float = 0.999, t_target: float = 0.0,
                          cache: Optional[EnergyCache] = None,
                          data_moves: bool = True,
                          move_switch: bool = False,
                          split_merge: bool = False,
                          ) -> Tuple[PointsState, EnergyCache, ChainStats]:
    h, w = maps.position.shape[-2:]
    if cache is None:
        cache = build_cache(init_state, maps, spec)
    u0 = energy_from_cache(init_state, maps, spec, comb, cache)
    n_cells = max(h, w) // (2 * CELL) + 1
    step = make_parallel_step(maps, spec, comb, kd, alpha_t, t_target,
                              n_cells, data_moves=data_moves,
                              move_switch=move_switch,
                              split_merge=split_merge)
    by_kind = torch.zeros((u0.shape[0], N_KINDS), dtype=torch.long,
                          device=u0.device)
    (state, cache, energy, temp), acc, prop = run_steps(
        step, init_state, cache, u0, t0, n_supersteps, gens, by_kind)
    return state, cache, chain_stats(kd, acc, prop, energy, state, temp,
                                     by_kind)
