"""Energy combination models: per-point energy vector -> scalar energy.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/combinators.py``:
``combine`` maps (..., n_energies) to (...) per-point energies under torch
autograd, for inference and for weight training. Kinds:

  - 'sum'                 : plain sum of the vector
  - 'manual_hierarchical' : config weights + PositionEnergy indicator gating
  - 'hierarchical'        : softmax-normalised data/prior tree + gating
  - 'hierarchical_fixed'  : the same tree with normalised weights (the
                            legacy manual mode's)
  - 'logistic'            : 2*sigmoid(w.e + b) - 1 per point
  - 'linear'              : w.e + b per point
  - 'mlp'                 : small MLP, 2*sigmoid(out) - 1 or raw

``combiner_to_dict`` / ``save_combiner`` write the JAX package's JSON
(format version 2), and ``load_combiner`` reads it, migrating version-1
logistic files (whose bias was summed once per column).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

# bump when ``combine`` semantics change (the JAX package's number):
#   v2: logistic bias applied once (v1/unversioned summed it per column)
COMBINER_FORMAT_VERSION = 2


@dataclass
class EnergyCombiner:
    kind: str
    names: Tuple[str, ...]
    params: Dict[str, Any] = field(default_factory=dict)
    indicator: int = 0  # PositionEnergy column for hierarchical kinds

    def __call__(self, vec: torch.Tensor) -> torch.Tensor:
        return combine(self, vec)

    def replace(self, **kw) -> "EnergyCombiner":
        return replace(self, **kw)


def combine(comb: EnergyCombiner, vec: torch.Tensor) -> torch.Tensor:
    """(..., n_energies) -> (...) per-point energies."""
    kind, p = comb.kind, comb.params
    if kind == "sum":
        return vec.sum(dim=-1)
    if kind == "manual_hierarchical":
        w = p["weights"]
        i = comb.indicator
        indicator = vec[..., i] <= p["threshold"]
        gated = (w * vec).sum(dim=-1) - w[i] * vec[..., i]
        return w[i] * vec[..., i] + indicator * gated
    if kind in ("hierarchical", "hierarchical_fixed"):
        # legacy 5-column layout: [pos, shape, overlap, align, area]
        if kind == "hierarchical":
            wd = torch.softmax(p["data_weight"], dim=-1)
            wp = torch.softmax(p["prior_weight"], dim=-1)
            wdp = torch.softmax(p["data_prior_weight"], dim=-1)
        else:
            wd, wp, wdp = (p["data_weight"], p["prior_weight"],
                           p["data_prior_weight"])
        indicator = vec[..., 0] <= p["threshold"]
        data_term = wd[0] * vec[..., 0] + indicator * wd[1] * vec[..., 1]
        prior_term = indicator * (wp[0] * vec[..., 2] + wp[1] * vec[..., 3]
                                  + wp[2] * vec[..., 4])
        return wdp[0] * data_term + wdp[1] * prior_term + p["bias"]
    if kind == "logistic":
        # 2*sigmoid(w.e + b) - 1 with the scalar bias added once
        return 2.0 * torch.sigmoid((p["weights"] * vec).sum(dim=-1)
                                   + p["bias"]) - 1.0
    if kind == "linear":
        return (p["weights"] * vec).sum(dim=-1) + p["bias"]
    if kind == "mlp":
        x = vec
        n_layers = len([k for k in p if k.startswith("w")])
        for li in range(n_layers):
            x = x @ p[f"w{li}"] + p[f"b{li}"]
            if li < n_layers - 1:
                x = torch.relu(x)
        x = x[..., 0]
        if p.get("raw_energy") is not None and bool(p["raw_energy"]):
            return x
        return 2.0 * torch.sigmoid(x) - 1.0
    raise ValueError(f"unknown combiner kind {kind}")


def regularisation(comb: EnergyCombiner) -> torch.Tensor:
    """Training regulariser of the trainable hierarchical tree (0 for the
    other kinds)."""
    if comb.kind == "hierarchical":
        p = comb.params
        return sum(torch.square(1.0 - torch.softmax(p[k], dim=-1)).sum()
                   for k in ("data_prior_weight", "data_weight",
                             "prior_weight"))
    return torch.tensor(0.0)


# ------------------------------------------------------------------ builders


def _t(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def sum_combiner(names: Sequence[str], device="cpu") -> EnergyCombiner:
    return EnergyCombiner(kind="sum", names=tuple(names))


def manual_hierarchical(names: Sequence[str], weights_dict: Dict[str, float],
                        indicator_energy: str = "PositionEnergy",
                        threshold: float = 0.0, device="cpu"
                        ) -> EnergyCombiner:
    return EnergyCombiner(
        kind="manual_hierarchical", names=tuple(names),
        params={"weights": _t([float(weights_dict[n]) for n in names], device),
                "threshold": _t(threshold, device)},
        indicator=list(names).index(indicator_energy),
    )


def hierarchical(names: Sequence[str], threshold: float = 0.0, device="cpu"
                 ) -> EnergyCombiner:
    return EnergyCombiner(
        kind="hierarchical", names=tuple(names),
        params={"data_weight": torch.ones(2, device=device),
                "prior_weight": torch.ones(3, device=device),
                "data_prior_weight": torch.ones(2, device=device),
                "threshold": _t(threshold, device),
                "bias": _t(0.0, device)},
    )


def hierarchical_fixed(names: Sequence[str], weights_data, weights_prior,
                       data_prior_weights, threshold: float = 0.0,
                       bias: float = 0.0, device="cpu") -> EnergyCombiner:
    """The hierarchical tree with already-normalised weights, built from
    the legacy ``manual`` config block."""
    return EnergyCombiner(
        kind="hierarchical_fixed", names=tuple(names),
        params={"data_weight": _t(weights_data, device),
                "prior_weight": _t(weights_prior, device),
                "data_prior_weight": _t(data_prior_weights, device),
                "threshold": _t(threshold, device),
                "bias": _t(bias, device)},
    )


def logistic(names: Sequence[str], device="cpu") -> EnergyCombiner:
    return EnergyCombiner(
        kind="logistic", names=tuple(names),
        params={"weights": torch.ones(len(names), device=device),
                "bias": _t(0.0, device)},
    )


def linear(names: Sequence[str], device="cpu") -> EnergyCombiner:
    return EnergyCombiner(
        kind="linear", names=tuple(names),
        params={"weights": torch.ones(len(names), device=device),
                "bias": _t(0.0, device)},
    )


def mlp(names: Sequence[str], hidden_features: int = 8,
        hidden_layers: int = 2, raw_energy: bool = False, seed: int = 0,
        device="cpu") -> EnergyCombiner:
    """He-normal weights drawn from a ``torch.Generator`` seeded ``seed``
    (the JAX package draws them from ``jax.random``: the two packages'
    initial MLPs differ; ``combiner_from_dict`` carries weights across)."""
    gen = torch.Generator().manual_seed(seed)
    dims = [len(names)] + [hidden_features] * hidden_layers + [1]
    params: Dict[str, Any] = {}
    for li, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{li}"] = (torch.randn((din, dout), generator=gen)
                            * (2.0 / din) ** 0.5).to(device)
        params[f"b{li}"] = torch.zeros(dout, device=device)
    params["raw_energy"] = _t(float(raw_energy), device)
    return EnergyCombiner(kind="mlp", names=tuple(names), params=params)


def init_combiner(kind: str, names: Sequence[str], device="cpu", **kwargs
                  ) -> EnergyCombiner:
    """The weight model ``kind`` at its initial weights."""
    builders = {
        "sum": sum_combiner,
        "manual_hierarchical": manual_hierarchical,
        "hierarchical": hierarchical,
        "logistic": logistic,
        "linear": linear,
        "mlp": mlp,
    }
    return builders[kind](names, device=device, **kwargs)


# --------------------------------------------------------------- persistence


def combiner_to_dict(comb: EnergyCombiner) -> dict:
    return {
        "kind": comb.kind,
        "names": list(comb.names),
        "indicator": comb.indicator,
        "version": COMBINER_FORMAT_VERSION,
        "params": {k: np.asarray(v.detach().cpu().numpy()).tolist()
                   for k, v in comb.params.items()},
    }


def combiner_from_dict(d: dict, device="cpu") -> EnergyCombiner:
    params = {k: _t(v, device) for k, v in d["params"].items()}
    if d.get("version", 1) < 2 and d["kind"] == "logistic":
        # v1 logistic summed the bias once per column: scale it so the
        # single-bias formula reproduces the trained behaviour
        params["bias"] = params["bias"] * float(len(d["names"]))
    return EnergyCombiner(kind=d["kind"], names=tuple(d["names"]),
                          params=params, indicator=d.get("indicator", 0))


def save_combiner(path: str, comb: EnergyCombiner):
    with open(path, "w") as f:
        json.dump(combiner_to_dict(comb), f, indent=1)


def load_combiner(path: str, device="cpu") -> EnergyCombiner:
    with open(path) as f:
        return combiner_from_dict(json.load(f), device=device)


def combiner_as_report_dict(comb: EnergyCombiner) -> Dict[str, float]:
    """Flat named-weights dict for the training log."""
    p = {k: v.detach().cpu() for k, v in comb.params.items()}
    if comb.kind in ("logistic", "linear", "manual_hierarchical"):
        w = p["weights"].numpy()
        out = {f"{n}_weight": float(w[i]) for i, n in enumerate(comb.names)}
        if "bias" in p:
            out["bias"] = float(p["bias"])
        return out
    if comb.kind == "hierarchical":
        wd = torch.softmax(p["data_weight"], dim=-1).numpy()
        wp = torch.softmax(p["prior_weight"], dim=-1).numpy()
        wdp = torch.softmax(p["data_prior_weight"], dim=-1).numpy()
        return {
            "data_weight": float(wdp[0]),
            "prior_weight": float(wdp[1]),
            "PositionEnergy_indicator_threshold": float(p["threshold"]),
            "PositionEnergy_data_weight": float(wd[0]),
            "ShapeEnergy_data_weight": float(wd[1]),
            "RectangleOverlapEnergy_prior_weight": float(wp[0]),
            "ShapeAlignmentEnergy_prior_weight": float(wp[1]),
            "AreaPriorEnergy_prior_weight": float(wp[2]),
            "bias": float(p["bias"]),
        }
    return {}
