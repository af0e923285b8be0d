"""Hand-rolled Adam with per-leaf learning rates and moment surgery.

Counterpart of wheat3dgs_tpu/models/optim.py (reference torch.optim.Adam
with eps 1e-15 and one param group per tensor, scene/gaussian_model.py:
167-186). The moments are plain tensors beside the parameters so that
densify/prune can mask them like the parameters.

Unlike the JAX version, `adam_step` updates the parameters and moments IN
PLACE (no second copy of the model per step); the step count lives in
AdamState.step as a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]    # first moments, keyed like the params
    nu: Dict[str, torch.Tensor]    # second moments
    step: int = 0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     step=0)


@torch.no_grad()
def adam_step(opt: AdamState, grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor], lrs: Dict[str, float],
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> None:
    """One Adam update of `params` and `opt` in place, with bias
    correction by the global step count:
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""
    opt.step += 1
    t = opt.step
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for k, p in params.items():
        g = grads[k]
        m, v = opt.mu[k], opt.nu[k]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(lrs[k] * (m / c1) / (torch.sqrt(v / c2) + eps))
