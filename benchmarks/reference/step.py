"""The published training step, its initialisation and its densify rule,
in plain PyTorch and float32 (reference code: train.py, utils/loss_utils.py,
scene/gaussian_model.py, utils/general_utils.py).

A state is a dict of the six leaves, one row per splat, no padding:
means (N, 3), quats (N, 4), log_scales (N, 3), sh_dc (N, 3), sh_rest
(N, 45) ([k1 rgb, k2 rgb, ...]) and opacity_logit (N,), with Adam's
moments beside them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .raster import Camera, render

LEAVES = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
          "opacity_logit")
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-15
SH_C0 = 0.28209479177387814


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     block: int = 1024) -> torch.Tensor:
    """Each point's mean squared distance to its k nearest other points
    (the published code's distCUDA2), on the points' device, in float32.
    Candidates by |a|^2 + |b|^2 - 2 a.b over blocks of rows (the points
    centred first); the distances of the k + 4 nearest candidates taken
    again as sums of squared differences in float64, so that the result is
    the exact distances' mean rounded to float32."""
    p = points.to(torch.float64)
    p = p - p.mean(dim=0)
    q = p.to(torch.float32)
    sq = (q * q).sum(dim=1)
    c = min(k + 4, len(q) - 1)
    out = []
    for s0 in range(0, len(q), block):
        rows = q[s0:s0 + block]
        d2 = sq[s0:s0 + block, None] + sq[None, :] - 2.0 * (rows @ q.T)
        own = torch.arange(len(rows), device=q.device)
        d2[own, own + s0] = float("inf")
        idx = torch.topk(d2, c, dim=1, largest=False).indices
        exact = ((p[idx] - p[s0:s0 + block, None]) ** 2).sum(dim=2)
        out.append(torch.topk(exact, k, dim=1, largest=False).values
                   .mean(dim=1))
    return torch.cat(out).to(torch.float32)


def init_state(points: np.ndarray, colors: np.ndarray, sh_degree: int,
               device) -> dict:
    """create_from_pcd: SH DC from the colours, isotropic scales
    sqrt(max(mean 3-NN squared distance, 1e-7)), identity rotations,
    opacity 0.1."""
    n = len(points)
    k = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    dist2 = torch.clamp(knn_mean_sq_dist(pts), min=1e-7)
    log_s = torch.log(torch.sqrt(dist2))
    quats = torch.zeros((n, 4), device=device)
    quats[:, 0] = 1.0
    return {
        "means": pts,
        "quats": quats,
        "log_scales": log_s[:, None].repeat(1, 3),
        "sh_dc": (torch.as_tensor(np.asarray(colors, np.float32),
                                  device=device) - 0.5) / SH_C0,
        "sh_rest": torch.zeros((n, 3 * (k - 1)), device=device),
        "opacity_logit": torch.full((n,), math.log(0.1 / 0.9),
                                    device=device),
    }


def expon_lr(step: int, lr_init: float, lr_final: float,
             delay_mult: float, max_steps: int) -> float:
    """get_expon_lr_func without a delay (lr_delay_steps = 0)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def learning_rates(it: int, opt: dict, extent: float) -> dict:
    """Each leaf's learning rate at iteration `it` (training_setup and
    update_learning_rate)."""
    return {
        "means": extent * expon_lr(it, opt["position_lr_init"],
                                   opt["position_lr_final"],
                                   opt["position_lr_delay_mult"],
                                   opt["position_lr_max_steps"]),
        "quats": opt["rotation_lr"],
        "log_scales": opt["scaling_lr"],
        "sh_dc": opt["feature_lr"],
        "sh_rest": opt["feature_lr"] / 20.0,
        "opacity_logit": opt["opacity_lr"],
    }


def _window(device) -> torch.Tensor:
    xs = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    g = (g / g.sum()).to(torch.float32)
    w2 = torch.outer(g, g)
    return w2.expand(3, 1, 11, 11).contiguous().to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The published windowed SSIM of two (3, H, W) images, averaged."""
    w = _window(img1.device)
    a, b = img1[None], img2[None]

    def blur(x):
        return F.conv2d(x, w, padding=5, groups=3)

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def loss_of(img: torch.Tensor, gt: torch.Tensor,
            lambda_dssim: float) -> torch.Tensor:
    return ((1.0 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1.0 - ssim(img, gt)))


class StepOut(NamedTuple):
    state: dict
    adam: dict
    loss: float
    grads: dict           # each leaf's gradient, and "viewspace" (N,)


def adam_init(state: dict) -> dict:
    return {"t": 0, "m": {k: torch.zeros_like(v) for k, v in state.items()},
            "v": {k: torch.zeros_like(v) for k, v in state.items()}}


def train_step(state: dict, adam: dict, cam: Camera, gt: torch.Tensor,
               width: int, height: int, sh_degree: int, lrs: dict,
               lambda_dssim: float,
               bg: Optional[torch.Tensor] = None) -> StepOut:
    """One step: render, loss, gradients, Adam. `viewspace` is the norm of
    each splat's screen-space gradient in NDC units (0 where culled), the
    statistic densification accumulates."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in state.items()}
    out = render(leaves, cam, width, height, sh_degree, bg=bg, grad=True)
    loss = loss_of(out.image, gt, lambda_dssim)
    gs = torch.autograd.grad(loss, [leaves[k] for k in LEAVES]
                             + [out.proj.xy], allow_unused=True)
    grads = {k: (torch.zeros_like(state[k]) if g is None else g)
             for k, g in zip(LEAVES, gs)}
    g_xy = gs[-1] * torch.tensor([0.5 * width, 0.5 * height],
                                 device=gt.device)
    view = torch.zeros_like(state["opacity_logit"])
    view[out.proj.index] = torch.linalg.vector_norm(g_xy, dim=1)
    grads["viewspace"] = view
    t = adam["t"] + 1
    c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    new_state, m_new, v_new = {}, {}, {}
    with torch.no_grad():
        for k in LEAVES:
            g = grads[k]
            m = B1 * adam["m"][k] + (1.0 - B1) * g
            v = B2 * adam["v"][k] + (1.0 - B2) * g * g
            new_state[k] = state[k] - lrs[k] * (m / c1) / (
                torch.sqrt(v / c2) + ADAM_EPS)
            m_new[k], v_new[k] = m, v
    return StepOut(new_state, {"t": t, "m": m_new, "v": v_new},
                   float(loss.detach()), grads)


def densify_classes(params: dict, alive: torch.Tensor,
                    grad_accum: torch.Tensor, denom: torch.Tensor,
                    rule: dict, extent: float, prune_world: bool) -> dict:
    """densify_and_prune's choices per row: clone small splats whose mean
    screen-space gradient reaches the threshold, split large ones, prune
    those under the opacity floor (and, with prune_world, those larger
    than 0.1 of the extent); a pruned splat is neither cloned nor split,
    which is where the published sequence leaves it too."""
    stat = torch.where(denom > 0, grad_accum / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))
    max_scale = torch.exp(params["log_scales"]).max(dim=1).values
    opacity = torch.sigmoid(params["opacity_logit"])
    prune = (opacity < rule["min_opacity"]) & alive
    if prune_world:
        prune = prune | ((max_scale > 0.1 * extent) & alive)
    hot = (stat >= rule["densify_grad_threshold"]) & alive & ~prune
    small = max_scale <= rule["percent_dense"] * extent
    return {"prune": prune, "clone": hot & small, "split": hot & ~small}
