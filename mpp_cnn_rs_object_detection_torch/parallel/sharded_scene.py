"""Segments of the exact whole-scene chain, on one device or in row bands.

Counterpart of ``run_exact_scene_chain`` in
``mpp_cnn_rs_object_detection_tpu/parallel/sharded_scene.py``: run
``n_supersteps`` cell-parallel supersteps on the whole maps of every lane
(the state, maps and kernel data carry a leading lane axis B; ``gens``
holds one generator per lane) and return the states, the carried cache
(pass it back to continue without an O(K^2) rebuild) and the segment's
per-lane stats, with the accepted proposals by kind. One launch sequence
per superstep serves all B lanes, where the JAX package vmaps the one-lane
chain.

With a ``mesh`` of n > 1 devices (``parallel/mesh.py``) one lane runs as
ONE global point process over row bands of its maps
(``parallel_sampler.make_banded_step``): the O(H W C) maps are split by
rows, each band with a CELL-row halo, while the state and its cache are
replicated on every band and the superstep's per-cell records are merged
and applied identically everywhere, so pair energies across band borders
are exact and the run equals the one-band chain.
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
    make_banded_step,
    make_parallel_step,
    run_steps,
)
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    ChainStats,
    EnergyCache,
    build_cache,
    energy_from_cache,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    to_device,
)


def check_banded(h: int, n: int, n_lanes: int, data_term: str) -> None:
    """The banded chain's preconditions (JAX's, as errors)."""
    if data_term != "cnn":
        raise ValueError("the banded scene chain supports the CNN data "
                         f"term only, not {data_term!r}")
    if h % n:
        raise ValueError(f"scene rows {h} not divisible by the mesh size "
                         f"{n}")
    # a band must cover a full jittered cell (2 CELL), not just the halo:
    # JAX measured band == CELL to diverge from the one-band chain
    if 2 * CELL > h // n:
        raise ValueError(f"band height {h // n} < 2*CELL ({2 * CELL}): "
                         "cross-band cells would read outside the halo; use "
                         "fewer devices or a taller scene")
    if n_lanes != 1:
        raise ValueError(f"the banded chain runs one lane, got {n_lanes}")


def run_exact_scene_chain(gens: Sequence[torch.Generator],
                          init_state: PointsState,
                          maps: EnergyMaps, spec: EnergySpec,
                          comb: EnergyCombiner, kd: KernelData,
                          n_supersteps: int, t0: float = 1.0,
                          alpha_t: float = 0.999, t_target: float = 0.0,
                          cache: Optional[EnergyCache] = None,
                          data_moves: bool = True,
                          move_switch: bool = False,
                          split_merge: bool = False, mesh=None,
                          ) -> Tuple[PointsState, EnergyCache, ChainStats]:
    """``mesh``: None or one device runs the lanes as they are; n > 1
    devices run the one lane in n row bands (the generator and the inputs
    on ``mesh[0]``, where the results come back)."""
    h, w = maps.position.shape[-2:]
    banded = mesh is not None and len(mesh) > 1
    if banded:
        check_banded(h, len(mesh), init_state.xy.shape[0], spec.data_term)
    if cache is None:
        cache = build_cache(init_state, maps, spec)
    u0 = energy_from_cache(init_state, maps, spec, comb, cache)
    n_cells = max(h, w) // (2 * CELL) + 1
    moves = dict(data_moves=data_moves, move_switch=move_switch,
                 split_merge=split_merge)
    by_kind = torch.zeros((u0.shape[0], N_KINDS), dtype=torch.long,
                          device=u0.device)
    if not banded:
        step = make_parallel_step(maps, spec, comb, kd, alpha_t, t_target,
                                  n_cells, **moves)
        (state, cache, energy, temp), acc, prop = run_steps(
            step, init_state, cache, u0, t0, n_supersteps, gens, by_kind)
    else:
        step = make_banded_step(maps, spec, comb, kd, alpha_t, t_target,
                                n_cells, mesh, **moves)
        replicas = [[to_device(x, d) for d in mesh]
                    for x in (init_state, cache)]
        (states, caches, energies, temp), acc, prop = run_steps(
            step, replicas[0], replicas[1], [u0.to(d) for d in mesh], t0,
            n_supersteps, gens, by_kind)
        state, cache, energy = states[0], caches[0], energies[0]
    return state, cache, chain_stats(kd, acc, prop, energy, state, temp,
                                     by_kind)
