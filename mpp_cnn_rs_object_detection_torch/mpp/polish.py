"""Gradient polish of final detections: zero-temperature continuous
refinement.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/polish.py``: after
the anneal, a few Adam steps on (xy, range-normalised marks) of the final
configuration descend the same energy the chain annealed (bilinear position
lookups, tri-linear mark lookups and the closed-form quad clipping are all
differentiable), with torch autograd in place of ``jax.grad``. Default off
(``inference.polish_steps``). The returned state is the best-energy
iterate, so polish never worsens U; dead slots carry zero gradient and keep
their values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mpp_cnn_rs_object_detection_torch.mpp.combinators import EnergyCombiner
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
)
from mpp_cnn_rs_object_detection_torch.mpp.rjmcmc import (
    build_cache,
    energy_from_cache,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    expand_lanes,
)

# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


class _Adam:
    """``optax.adam(lr)`` written out: moments, bias correction, and
    ``eps`` added after the square root."""

    def __init__(self, lr: float, like: torch.Tensor):
        self.lr = lr
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def update(self, g: torch.Tensor) -> torch.Tensor:
        self.mu = (1 - B1) * g + B1 * self.mu
        self.nu = (1 - B2) * g * g + B2 * self.nu
        self.count += 1
        mu_hat = self.mu / (1 - B1 ** self.count)
        nu_hat = self.nu / (1 - B2 ** self.count)
        return -self.lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))


def polish_state(state: PointsState, maps: EnergyMaps, spec: EnergySpec,
                 comb: EnergyCombiner, n_steps: int = 60, lr_xy: float = 0.1,
                 lr_marks: float = 0.003,
                 ) -> Tuple[PointsState, Tuple[torch.Tensor, torch.Tensor]]:
    """Adam descent on U(xy, marks) of one configuration with per-step
    projection (xy inside the maps, size/ratio off their degenerate edges,
    the cyclic angle wrapped). Returns ``(best_state, (U_before,
    U_after))``."""
    h, w = maps.position.shape[-2:]
    vmin, vmax = maps.map_vmin[None, :], maps.map_vmax[None, :]
    rng_m = vmax - vmin
    cyc = maps.map_cyclic[None, :]

    def project(xy, z):
        xy = torch.stack([torch.clamp(xy[:, 0], 0.0, h - 1.0),
                          torch.clamp(xy[:, 1], 0.0, w - 1.0)], dim=-1)
        # the floor sits below any mapping's bin-0 center (1/(2C))
        z = torch.where(cyc, torch.remainder(z, 1.0),
                        torch.clamp(z, 0.004, 1.0))
        return xy, z

    maps1 = expand_lanes(maps, 1)

    def energy(xy, z):
        st = expand_lanes(PointsState(xy=xy, marks=vmin + z * rng_m,
                                      alive=state.alive), 1)
        cache = build_cache(st, maps1, spec, safe_dist=True)
        return energy_from_cache(st, maps1, spec, comb, cache)[0]

    def value_and_grad(xy, z):
        xy = xy.detach().requires_grad_(True)
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            u = energy(xy, z)
            g_xy, g_z = torch.autograd.grad(u, (xy, z))
        return u.detach(), g_xy, g_z

    xy = state.xy.float()
    z = (state.marks - vmin) / rng_m
    with torch.no_grad():
        # the "never worsens U" contract is against the raw chain state
        u0 = energy(xy, z)
    best_u, best_xy, best_z = u0, xy, z
    opt_xy, opt_z = _Adam(lr_xy, xy), _Adam(lr_marks, z)
    for _ in range(n_steps):
        u, g_xy, g_z = value_and_grad(xy, z)
        # u is the energy AT the incoming iterate: record that pairing
        better = u < best_u
        best_u = torch.where(better, u, best_u)
        best_xy = torch.where(better, xy, best_xy)
        best_z = torch.where(better, z, best_z)
        # degenerate geometry can give non-finite gradients: drop them
        g_xy = torch.where(torch.isfinite(g_xy), g_xy, 0.0)
        g_z = torch.where(torch.isfinite(g_z), g_z, 0.0)
        xy, z = project(xy + opt_xy.update(g_xy), z + opt_z.update(g_z))
    with torch.no_grad():
        u_f = energy(xy, z)  # the final iterate is itself a candidate
    take_final = u_f < best_u
    out_xy = torch.where(take_final, xy, best_xy)
    out_z = torch.where(take_final, z, best_z)
    out_u = torch.where(take_final, u_f, best_u)
    return state.replace(xy=out_xy, marks=vmin + out_z * rng_m), (u0, out_u)
