"""The optimisers of the port's gradient steps, written out with optax's
formulas (the GPU host has no optax): ``optax.adam`` and ``optax.sgd``
(no momentum), optionally with ``optax.exponential_decay(lr,
transition_steps=1, decay_rate=gamma)``, and the detectors'
``optax.chain(clip_by_global_norm(c), adam(warmup_cosine_decay_schedule(
...)))``. The combiner's training (``train_weights.py``), the gradient
polish (``polish.py``) and the CNN and detector trainers
(``models/train_utils.py``) step through it. Each formula runs as one
``torch._foreach_*`` call over all tensors, so a step costs the same few
launches whether it updates one tensor or a ResNet's ~300."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count`` in float32 (1 - 0.999 is 4.7e-5 off
    its float64 value there)."""
    f32 = np.float32
    return float(f32(1) - f32(decay) ** f32(count))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) in its float32
    arithmetic: a linear ramp from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at
    ``decay_steps``; it raises where optax does (no steps left to decay)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps - warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) \
                / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = min(f32(count - warmup_steps), span)
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / span))
        return float(f32(peak_value) * (f32(1 - alpha) * cos + f32(alpha)))

    return schedule


class Optimizer:
    """``optax.adam`` or ``optax.sgd`` over a dict of tensors, with a
    learning rate of ``lr * gamma ** count`` (``gamma`` None: constant) or
    ``schedule(count)``, ``count`` counting steps from 0. Adam's bias
    correction is at ``count + 1`` and its ``eps`` is added after the square
    root. With ``clip_norm`` the gradients are first clipped to that global
    norm as ``optax.clip_by_global_norm`` does: kept while their norm is
    below it, else ``(g / norm) * clip_norm``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 kind: str = "adam", gamma: Optional[float] = None,
                 schedule: Optional[Callable[[int], float]] = None,
                 clip_norm: Optional[float] = None):
        self.lr, self.kind, self.gamma = lr, kind, gamma
        self.schedule, self.clip_norm = schedule, clip_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step_size(self) -> float:
        """The learning rate of the next step."""
        if self.schedule is not None:
            return self.schedule(self.count)
        if self.gamma is None:
            return self.lr
        return self.lr * float(np.float32(self.gamma)
                               ** np.float32(self.count))

    def clip(self, g):
        """``clip_by_global_norm`` without a host sync: dividing by 1 and
        multiplying by 1 keeps a gradient below the norm exact."""
        norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        keep = norm < self.clip_norm
        one = torch.ones_like(norm)
        g = torch._foreach_div(g, torch.where(keep, one, norm))
        return torch._foreach_mul(g, torch.where(
            keep, one, torch.full_like(norm, self.clip_norm)))

    def step(self, params: Dict[str, torch.Tensor], grads: Dict
             ) -> Dict[str, torch.Tensor]:
        """The parameters after one step along ``grads``."""
        step_size = self.step_size()
        self.count += 1
        keys = list(params)
        g = [grads[k] for k in keys]
        if self.clip_norm is not None:
            g = self.clip(g)
        if self.kind == "adam":
            mul, add, div = (torch._foreach_mul, torch._foreach_add,
                             torch._foreach_div)
            mu = add(mul(g, 1 - ADAM_B1),
                     mul([self.mu[k] for k in keys], ADAM_B1))
            nu = add(mul(mul(g, g), 1 - ADAM_B2),
                     mul([self.nu[k] for k in keys], ADAM_B2))
            self.mu.update(zip(keys, mu))
            self.nu.update(zip(keys, nu))
            mu_hat = div(mu, _bias_correction(ADAM_B1, self.count))
            nu_hat = div(nu, _bias_correction(ADAM_B2, self.count))
            u = div(mu_hat, add(torch._foreach_sqrt(nu_hat), ADAM_EPS))
        else:
            u = g
        new = torch._foreach_sub([params[k] for k in keys],
                                 torch._foreach_mul(u, step_size))
        return dict(zip(keys, new))
