"""The optimisers of the MPP's gradient steps, written out with optax's
formulas (the GPU host has no optax): ``optax.adam`` and ``optax.sgd``
(no momentum), optionally with ``optax.exponential_decay(lr,
transition_steps=1, decay_rate=gamma)``. The combiner's training
(``train_weights.py``), the gradient polish (``polish.py``) and the CNN
trainer (``models/train_utils.py``) step through it. Each formula runs as
one ``torch._foreach_*`` call over all tensors, so a step costs the same
few launches whether it updates one tensor or the U-Net's ~70."""

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
        keys = list(params)
        g = [grads[k] for k in keys]
        if self.kind == "adam":
            mul, add, div = (torch._foreach_mul, torch._foreach_add,
                             torch._foreach_div)
            mu = add(mul(g, 1 - ADAM_B1),
                     mul([self.mu[k] for k in keys], ADAM_B1))
            nu = add(mul(mul(g, 1 - ADAM_B2), g),
                     mul([self.nu[k] for k in keys], ADAM_B2))
            self.mu.update(zip(keys, mu))
            self.nu.update(zip(keys, nu))
            mu_hat = div(mu, 1 - ADAM_B1 ** self.count)
            nu_hat = div(nu, 1 - ADAM_B2 ** self.count)
            u = div(mu_hat, add(torch._foreach_sqrt(nu_hat), ADAM_EPS))
        else:
            u = g
        new = torch._foreach_sub([params[k] for k in keys],
                                 torch._foreach_mul(u, step_size))
        return dict(zip(keys, new))
