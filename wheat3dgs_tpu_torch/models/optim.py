"""Hand-rolled Adam with per-leaf learning rates and moment surgery.

Counterpart of wheat3dgs_tpu/models/optim.py (reference torch.optim.Adam
with eps 1e-15 and one param group per tensor, scene/gaussian_model.py:
167-186). The moments are plain tensors beside the parameters so that
densify/prune can mask them like the parameters.

Unlike the JAX version, `adam_update` updates the parameters and moments
IN PLACE (no second copy of the model per step), and its scalars (each
leaf's learning rate and the two bias corrections) are float32 tensors on
the parameters' device, never Python floats baked into the launched
kernels: a step captured in a CUDA graph then reads this step's values on
every replay. The step count lives in AdamState.step as a Python int that
the caller advances (`bias_corrections` turns it into the scalars).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]    # first moments, keyed like the params
    nu: Dict[str, torch.Tensor]    # second moments
    step: int = 0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     step=0)


def bias_corrections(t: int, b1: float = B1,
                     b2: float = B2) -> Tuple[float, float]:
    """(1 - b1^t, 1 - b2^t) in float64 for the t-th update (t >= 1)."""
    return 1.0 - b1 ** t, 1.0 - b2 ** t


@torch.no_grad()
def adam_update(opt: AdamState, grads: Dict[str, torch.Tensor],
                params: Dict[str, torch.Tensor],
                lrs: Dict[str, torch.Tensor], c1: torch.Tensor,
                c2: torch.Tensor, b1: float = B1, b2: float = B2,
                eps: float = EPS) -> None:
    """One Adam update of `params` and `opt`'s moments in place:
    p -= lr * (m / c1) / (sqrt(v / c2) + eps), with `lrs`, c1 and c2 0-d
    float32 tensors on the parameters' device. Does not advance opt.step."""
    for k, p in params.items():
        g = grads[k]
        m, v = opt.mu[k], opt.nu[k]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(lrs[k] * (m / c1) / (torch.sqrt(v / c2) + eps))


def adam_step(opt: AdamState, grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor], lrs: Dict[str, float],
              b1: float = B1, b2: float = B2, eps: float = EPS) -> None:
    """Advance opt.step and run `adam_update` with host learning rates
    (JAX's adam_step, for callers outside the training step)."""
    opt.step += 1
    dev = next(iter(params.values())).device
    names = list(params)
    row = torch.tensor([lrs[k] for k in names]
                       + list(bias_corrections(opt.step, b1, b2)),
                       dtype=torch.float64).to(dev, torch.float32)
    adam_update(opt, grads, params, dict(zip(names, row)), row[-2], row[-1],
                b1, b2, eps)
