"""Energy combination models: per-point energy vector -> scalar energy.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/combinators.py`` for
inference: ``combine`` maps (..., n_energies) to (...) per-point energies,
and ``load_combiner`` reads the JSON the JAX package writes, migrating
version-1 logistic files (whose bias was summed once per column). Ported
kinds: ``sum``, ``manual_hierarchical`` and ``logistic`` (the flagship's);
the hierarchical, linear and MLP kinds are not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

import torch


@dataclass
class EnergyCombiner:
    kind: str
    names: Tuple[str, ...]
    params: Dict[str, Any] = field(default_factory=dict)
    indicator: int = 0  # PositionEnergy column for hierarchical kinds

    def __call__(self, vec: torch.Tensor) -> torch.Tensor:
        return combine(self, vec)


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
    if kind == "logistic":
        # 2*sigmoid(w.e + b) - 1 with the scalar bias added once
        return 2.0 * torch.sigmoid((p["weights"] * vec).sum(dim=-1)
                                   + p["bias"]) - 1.0
    raise ValueError(f"combiner kind {kind!r} is not ported")


def _t(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


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


def combiner_from_dict(d: dict, device="cpu") -> EnergyCombiner:
    params = {k: _t(v, device) for k, v in d["params"].items()}
    if d.get("version", 1) < 2 and d["kind"] == "logistic":
        # v1 logistic summed the bias once per column: scale it so the
        # single-bias formula reproduces the trained behaviour
        params["bias"] = params["bias"] * float(len(d["names"]))
    return EnergyCombiner(kind=d["kind"], names=tuple(d["names"]),
                          params=params, indicator=d.get("indicator", 0))


def load_combiner(path: str, device="cpu") -> EnergyCombiner:
    with open(path) as f:
        return combiner_from_dict(json.load(f), device=device)
