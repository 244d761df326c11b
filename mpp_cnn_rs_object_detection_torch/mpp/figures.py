"""MPP analysis figures: energy cross-plots, papangelou heatmaps, energy
attributions, pair interactions, weight trajectories and losses.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/figures.py``, the same
seven functions with the same signatures, drawn with the port's raster
plotter (``utils/raster_plot.py``: the GPU host has no matplotlib) and
taking the port's tensors where the JAX package takes arrays. Two of them
are device work:

- ``energy_attribution``: integrated gradients of the combined energy from
  a zero baseline, all ``n_steps`` points of the path in one ``combine``
  call under torch autograd, on the combiner's device;
- ``papangelou_heatmap``: ``exp(-(U({probe}) - U(empty)))`` at every
  strided pixel, the probes as configurations of one point in chunks of
  ``PROBE_CHUNK`` through the laned energy code, on the maps' device.

Each function also returns what it drew (an array or the pairs), so that
a caller can check it; a figure that cannot be drawn raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.mpp.combinators import (
    EnergyCombiner,
    combine,
)
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
    lane_energy_vectors,
)
from mpp_cnn_rs_object_detection_torch.mpp.state import (
    PointsState,
    expand_lanes,
)
from mpp_cnn_rs_object_detection_torch.ops.geometry import (
    rect_to_poly_np,
    sra_to_wla,
)
from mpp_cnn_rs_object_detection_torch.utils import raster_plot as rp

FIGURE_DPI = 110
# probes per laned energy call of ``papangelou_heatmap``
PROBE_CHUNK = 16384


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def energy_cross_plots(vectors, names: List[str], path: str,
                       per_point_energy=None) -> np.ndarray:
    """Pairwise scatter of per-point energy terms, coloured by the combined
    energy (``plasma``), each term's histogram (20 bins) on the diagonal.
    Returns the (n_terms, 20) histogram counts."""
    v = _host(vectors)
    n = len(names)
    fig, axs = rp.subplots(n, n, figsize=(2.2 * n, 2.2 * n), squeeze=False)
    c = (_host(per_point_energy) if per_point_energy is not None
         else "tab:blue")
    counts = []
    for i in range(n):
        for j in range(n):
            ax = axs[i, j]
            if i == j:
                counts.append(ax.hist(v[:, i], bins=20)[0])
            else:
                ax.scatter(v[:, j], v[:, i], s=4, c=c, cmap="plasma")
            if i == n - 1:
                ax.set_xlabel(names[j], fontsize=6)
            if j == 0:
                ax.set_ylabel(names[i], fontsize=6)
            ax.tick_params(labelsize=5)
    fig.tight_layout()
    fig.savefig(path, dpi=FIGURE_DPI)
    return np.stack(counts)


def _probe_energies(maps: EnergyMaps, spec: EnergySpec,
                   comb: EnergyCombiner, xy: np.ndarray, marks
                   ) -> np.ndarray:
    """U of the one-point configurations (``xy[i]``, ``marks``): (N,)
    float32, computed on the maps' device, ``PROBE_CHUNK`` probes per
    call (each probe one configuration of capacity 1)."""
    device = maps.position.device
    maps1 = expand_lanes(maps, 1)
    m = torch.as_tensor(np.asarray(marks, np.float32), device=device)
    out = []
    for start in range(0, len(xy), PROBE_CHUNK):
        p = torch.as_tensor(np.asarray(xy[start:start + PROBE_CHUNK],
                                       np.float32), device=device)
        n = p.shape[0]
        state = PointsState(
            xy=p.reshape(1, n, 1, 2), marks=m.expand(1, n, 1, 3),
            alive=torch.ones((1, n, 1), dtype=torch.bool, device=device))
        vec = lane_energy_vectors(state, maps1, spec)
        per_point = combine(comb, vec)
        out.append(torch.where(state.alive, per_point, 0.0).sum(-1)[0])
    return torch.cat(out).cpu().numpy()


def papangelou_heatmap(image, maps: EnergyMaps, spec: EnergySpec,
                       comb: EnergyCombiner, marks, path: str,
                       stride: int = 4) -> np.ndarray:
    """exp(-(U({probe}) - U(empty))) of a probe rectangle with ``marks`` at
    every ``stride``-th pixel: the per-location detection confidence
    field, drawn beside the image. Returns the (ceil(H / stride),
    ceil(W / stride)) float32 field."""
    image = _host(image)
    h, w = image.shape[:2]
    ys = np.arange(0, h, stride)
    xs = np.arange(0, w, stride)
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    # U(empty): the sum over no alive point
    u0 = 0.0
    energies = _probe_energies(maps, spec, comb, grid.astype(np.float32),
                              marks).reshape(len(ys), len(xs))
    pap = np.exp(-(energies - u0))

    fig, axs = rp.subplots(1, 2, figsize=(10, 5))
    axs[0].imshow(np.clip(image, 0, 1))
    axs[0].set_title("image")
    im = axs[1].imshow(pap, cmap="plasma")
    axs[1].set_title("papangelou(probe)")
    fig.colorbar(im, ax=axs[1])
    fig.tight_layout()
    fig.savefig(path, dpi=FIGURE_DPI)
    return pap


def _combiner_device(comb: EnergyCombiner, default) -> torch.device:
    for v in comb.params.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device(default)


def energy_attribution(comb: EnergyCombiner, vectors, n_steps: int = 32
                       ) -> np.ndarray:
    """Per-term attribution of the combined per-point energy: integrated
    gradients from a zero baseline along the straight path, midpoint rule,
    all ``n_steps`` points of the path as one (n_steps, N, E) ``combine``
    call under autograd on the combiner's device. Returns (N, E) float32
    attributions; rows sum to ``combine(x) - combine(0)`` up to the
    rule's error (exactly ``w * x`` for a linear combiner)."""
    device = _combiner_device(
        comb, vectors.device if isinstance(vectors, torch.Tensor)
        else "cpu")
    x = torch.as_tensor(_host(vectors), dtype=torch.float32,
                        device=device).reshape(-1, len(comb.names))
    alphas = (torch.arange(n_steps, dtype=torch.float32, device=device)
              + 0.5) / n_steps
    path = (alphas[:, None, None] * x[None]).requires_grad_(True)
    with torch.enable_grad():
        total = combine(comb, path).sum()
        (grads,) = torch.autograd.grad(total, path)
    return (x * grads.mean(dim=0)).cpu().numpy()


def attribution_summary_plot(attributions, vectors, names: List[str],
                             path: str) -> np.ndarray:
    """SHAP-style summary: one jittered scatter row per energy term (rows
    ordered by mean |attribution|), x the attribution, colour the term's
    raw value normalised to [0, 1] (``coolwarm``). The jitter is numpy's
    ``default_rng(0)``, drawn row by row as the JAX package draws it.
    Returns the (n_terms, N) y positions, in row order."""
    attributions = _host(attributions)
    vectors = _host(vectors)
    n = len(names)
    rng = np.random.default_rng(0)
    fig, ax = rp.subplots(figsize=(7, 0.5 * n + 2))
    order = np.argsort(np.abs(attributions).mean(axis=0))
    ys = []
    sc = None
    for row, i in enumerate(order):
        y = row + 0.12 * rng.standard_normal(attributions.shape[0])
        ys.append(y)
        v = vectors[:, i]
        rng_v = max(float(v.max() - v.min()), 1e-8)
        sc = ax.scatter(attributions[:, i], y, c=(v - v.min()) / rng_v,
                        cmap="coolwarm", s=10, vmin=0, vmax=1)
    ax.axvline(0.0, color="gray", lw=0.8)
    ax.set_yticks(range(n))
    ax.set_yticklabels([names[i] for i in order], fontsize=7)
    ax.set_xlabel("attribution to combined energy")
    fig.colorbar(sc, ax=ax, label="term value (normalized)")
    fig.tight_layout()
    fig.savefig(path, dpi=FIGURE_DPI)
    return np.stack(ys)


def interaction_figure(image, state: PointsState, cache, path: str,
                       term: str = "overlap", max_dist: float = 32.0
                       ) -> List[Tuple[int, int, float]]:
    """The image, the rectangles (lime) and a line between each pair of
    alive points within ``max_dist``, coloured (``plasma``) and widened by
    the pair term's |value| over the largest drawn. ``state`` and
    ``cache`` (``rjmcmc.EnergyCache``) are one configuration's, without a
    lane axis. Returns the pairs drawn as (slot i, slot j, value), i < j."""
    alive = _host(state.alive).astype(bool)
    slots = np.nonzero(alive)[0]
    xy = _host(state.xy)[alive]
    marks = _host(state.marks)[alive]
    dist = _host(cache.dist)[alive][:, alive]
    values = _host(getattr(cache, term))[alive][:, alive]

    fig, ax = rp.subplots(figsize=(7, 7))
    ax.imshow(np.clip(_host(image), 0, 1))
    if len(xy):
        a, b, w = sra_to_wla(marks[:, 0], marks[:, 1], marks[:, 2])
        polys = rect_to_poly_np(xy, np.asarray(a), np.asarray(b),
                                np.asarray(w))
        ax.add_polygon(np.flip(polys, -1), edgecolor="lime", lw=0.8)
    iu, ju = np.triu_indices(len(xy), k=1)
    near = dist[iu, ju] <= max_dist
    vmax = (max(float(np.abs(values[iu, ju][near]).max()), 1e-8)
            if near.any() else 1.0)
    ia, ib = iu[near], ju[near]
    v = values[ia, ib]
    t = np.clip(np.abs(v) / vmax, 0, 1)
    ax.segments(xy[ia, 1], xy[ia, 0], xy[ib, 1], xy[ib, 0],
                rp.get_cmap("plasma")(t), 1 + 3 * t, alpha=0.6)
    ax.set_title(f"pair term '{term}' interactions")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=FIGURE_DPI)
    return [(int(slots[i]), int(slots[j]), float(x))
            for i, j, x in zip(ia, ib, v)]


def weight_trajectory_plot(log: Dict[str, List[float]], path: str) -> None:
    """Learned combiner weights (``*_weight`` and ``bias`` entries) over
    epochs."""
    fig, ax = rp.subplots(figsize=(7, 4))
    for k, v in log.items():
        if k.endswith("_weight") or k == "bias":
            ax.plot(v, label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("weight")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=FIGURE_DPI)


def loss_plot(train_loss: List[float], val_loss: List[float], path: str
              ) -> None:
    """Train and val loss over epochs."""
    fig, ax = rp.subplots(figsize=(6, 4))
    ax.plot(train_loss, label="train")
    ax.plot(val_loss, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=FIGURE_DPI)

