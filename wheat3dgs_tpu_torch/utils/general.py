"""Small numeric helpers (reference: utils/general_utils.py), in torch.

Counterpart of wheat3dgs_tpu/utils/general.py. The learning-rate schedule
runs on the host here: the training loop calls it once per step with a
Python int, so it returns a Python float.
"""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.log(x / (1.0 - x))


def expon_lr(step, lr_init: float, lr_final: float,
             lr_delay_steps: float = 0.0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Log-linearly interpolated (exponential-decay) LR
    (get_expon_lr_func, utils/general_utils.py:29-62): lr(0) = lr_init,
    lr(max_steps) = lr_final, optional sine-eased delay."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = float(step)
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(math.log(lr_init) * (1 - t)
                                 + math.log(lr_final) * t)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Batched unnormalized (w, x, y, z) quaternion -> (..., 3, 3) rotation.

    Same normalization + element layout as build_rotation
    (utils/general_utils.py:78-100); all-zero quats (dead capacity slots)
    stay finite through the clamped rsqrt.
    """
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    q = q * torch.rsqrt(torch.clamp(sq, min=1e-24))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [torch.stack([r00, r01, r02], -1),
         torch.stack([r10, r11, r12], -1),
         torch.stack([r20, r21, r22], -1)], dim=-2)


def build_covariance(scales: torch.Tensor, quats: torch.Tensor,
                     scale_modifier: float = 1.0) -> torch.Tensor:
    """3D covariance Sigma = (R S)(R S)^T from activated scales + quaternions
    (reference build_covariance_from_scaling_rotation). Full float32: the
    package keeps TF32 off for matmuls."""
    R = quat_to_rotmat(quats)
    L = R * (scale_modifier * scales)[..., None, :]   # R @ diag(s)
    return L @ L.transpose(-1, -2)


def seed_everything(seed: int = 0) -> None:
    """Seed the host RNGs and torch's default generators (reference
    safe_state seeds 0, utils/general_utils.py:130-132). The trainer's own
    randomness comes from explicit torch.Generators."""
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
