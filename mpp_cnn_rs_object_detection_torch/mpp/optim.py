"""The optimisers of the MPP's gradient steps, written out with optax's
formulas (the GPU host has no optax): ``optax.adam`` and ``optax.sgd``
(no momentum), optionally with ``optax.exponential_decay(lr,
transition_steps=1, decay_rate=gamma)``. The combiner's training
(``train_weights.py``) and the gradient polish (``polish.py``) step
through it."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """``optax.adam`` or ``optax.sgd`` over a dict of tensors, with a
    learning rate of ``lr * gamma ** count`` (``gamma`` None: constant),
    ``count`` counting steps from 0. Adam's bias correction is at
    ``count + 1`` and its ``eps`` is added after the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 kind: str = "adam", gamma: Optional[float] = None):
        self.lr, self.kind, self.gamma = lr, kind, gamma
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict
             ) -> Dict[str, torch.Tensor]:
        """The parameters after one step along ``grads``."""
        step_size = (self.lr if self.gamma is None
                     else self.lr * float(np.float32(self.gamma)
                                          ** np.float32(self.count)))
        self.count += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            if self.kind == "adam":
                self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
                self.nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * self.nu[k]
                mu_hat = self.mu[k] / (1 - ADAM_B1 ** self.count)
                nu_hat = self.nu[k] / (1 - ADAM_B2 ** self.count)
                u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
            else:
                u = g
            out[k] = p - step_size * u
        return out
