"""The 3DGS training step and its host-side schedule.

Counterpart of wheat3dgs_tpu/training.py (reference: the hot loop of
train_vanilla_3dgs.py:55-121), for one view per step:

- `train_step`: render -> (1-λ)L1 + λ(1-SSIM) -> gradients -> Adam ->
  densification statistics. It is written functionally, as JAX's
  `value_and_grad` is: the parameters are plain tensors, the step takes
  fresh leaves of them and calls `torch.autograd.grad(loss, leaves)` (plus
  a zero `ndc_offset`, whose gradient is the CUDA rasterizer's viewspace
  gradient). Densification and capacity growth replace every tensor, so no
  `.grad` or optimizer bookkeeping can go stale. Adam and the statistics
  then update the state's tensors in place.
- `Trainer`: camera-independent schedule — SH warm-up, random background
  from a torch.Generator, the entry-budget ladder (the JAX Pallas branch of
  `_refresh_occupancy`; the port has no XLA backend), the deferred overflow
  watchdog, and densify/prune/opacity reset with capacity growth.

JAX's `train_step_scan` / `step_block` (several steps in one TPU program to
amortise host dispatch) and `train_step_views` / `multi_plot_step` (view
and plot batches for the scale-out slice) have no counterpart here: the
CLI steps one iteration at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .config import OptimizationParams
from .models import gaussians as G
from .models.optim import adam_step
from .ops.binning import pick_entry_budget
from .ops.losses import l1_loss, ssim
from .render.pipeline import RasterConfig, entry_demand_probe, render
from .utils.general import expon_lr


def lr_tree(it: int, opt: OptimizationParams,
            extent: float) -> Dict[str, float]:
    """Per-leaf learning rates (reference training_setup + per-step xyz
    schedule, scene/gaussian_model.py:167-194)."""
    return {
        "means": extent * expon_lr(
            it, opt.position_lr_init, opt.position_lr_final,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps),
        "quats": opt.rotation_lr,
        "log_scales": opt.scaling_lr,
        "sh_dc": opt.feature_lr,
        "sh_rest": opt.feature_lr / 20.0,
        "opacity_logit": opt.opacity_lr,
    }


def train_step(state: G.GaussianState, cam, gt_image: torch.Tensor,
               bg: torch.Tensor, it: int, *, sh_degree: int, width: int,
               height: int, opt: OptimizationParams,
               config: RasterConfig = RasterConfig(), extent: float = 1.0):
    """One optimisation step on one view (reference semantics), updating
    `state`'s parameters, Adam moments and statistics in place.

    cam: (w2c, full_proj, cam_center, tanfovx, tanfovy); gt_image (3, H, W).
    Returns (state, metrics) with 0-d tensor metrics (nothing is read back
    to the host): loss, l1, psnr, n_alive and entries_total (the render's
    allocation demand; > config.entry_budget means entries were cropped).
    """
    params = state.params.as_dict()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    ndc_zero = torch.zeros((state.capacity, 2), dtype=torch.float32,
                           device=state.device, requires_grad=True)
    view = dataclasses.replace(state, params=G.GaussianParams(**leaves))
    out = render(view, *cam, width, height, sh_degree, bg=bg,
                 ndc_offset=ndc_zero, config=config)
    ll1 = l1_loss(out.color, gt_image)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (
        1.0 - ssim(out.color, gt_image))
    names = list(leaves)
    inputs = [leaves[k] for k in names] + [ndc_zero]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    adam_step(state.adam, dict(zip(names, grads[:-1])), params,
              lr_tree(it, opt, extent))
    G.add_densification_stats(state, grads[-1], out.radii)
    with torch.no_grad():
        mse = ((out.color - gt_image) ** 2).mean()
        metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                   "psnr": 20.0 * -torch.log10(torch.sqrt(mse)),
                   "n_alive": state.num_alive,
                   "entries_total": out.entries_total}
    return state, metrics


class Trainer:
    """The host-side training loop: SH warm-up, densify schedule, capacity
    growth and the entry-budget ladder. Mirrors training()
    (train_vanilla_3dgs.py:32-121)."""

    # Overflow watchdog period: every k-th step's entry telemetry is queued
    # and read at the NEXT check, when it has long been computed, so int()
    # costs a scalar copy, not a drain of the queued work. Demand above the
    # budget re-probes and raises the rung for the step after: a population
    # that inflates within a densify interval crops at most 2k steps.
    overflow_check_every = 10

    def __init__(self, state: G.GaussianState, opt: OptimizationParams,
                 cameras_extent: float, sh_degree: int = 3,
                 config: RasterConfig = RasterConfig(), seed: int = 0,
                 white_background: bool = False):
        self.state = state
        self.white_background = white_background
        self.opt = opt
        self.extent = float(cameras_extent)
        self.max_sh_degree = sh_degree
        self.active_sh_degree = 0
        self.config = config
        self._occupancy_due = True
        self.overflow_events = 0
        self._pending_overflow = None
        dev = state.device
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.bg = torch.full((3,), 1.0 if white_background else 0.0,
                             dtype=torch.float32, device=dev)

    def _refresh_occupancy(self, cam, width: int, height: int) -> None:
        """Re-size the entry budget from the probed allocation demand (at
        the start, after every densify/prune/capacity event and on overflow
        signals, not per step); never lowered."""
        demand = int(entry_demand_probe(self.state, *cam, width=width,
                                        height=height))
        budget = max(self.config.entry_budget, pick_entry_budget(demand))
        if budget != self.config.entry_budget:
            self.config = dataclasses.replace(self.config,
                                              entry_budget=budget)
        self._occupancy_due = False

    def step(self, it: int, cam, gt_image: torch.Tensor, width: int,
             height: int) -> dict:
        """cam: (w2c, full_proj, cam_center, tanfovx, tanfovy) tensors."""
        if it % 1000 == 0 and self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1  # oneupSHdegree (train loop :61-62)
        if self._occupancy_due:
            self._refresh_occupancy(cam, width, height)
        bg = self.bg
        if self.opt.random_background:   # reference train loop :67
            bg = torch.rand((3,), generator=self.generator,
                            device=self.bg.device)
        self.state, metrics = train_step(
            self.state, cam, gt_image, bg, it,
            sh_degree=self.active_sh_degree, width=width, height=height,
            opt=self.opt, config=self.config, extent=self.extent)
        if it % self.overflow_check_every == 0:
            self._check_overflow(metrics["entries_total"])
        self.maybe_densify(it)
        return metrics

    def _check_overflow(self, entries_total: torch.Tensor) -> None:
        """Consume the previous check's telemetry and queue this step's. The
        demand is compared with the CURRENT budget, so telemetry from before
        a re-probe that already raised the rung does not trigger again."""
        if self._pending_overflow is not None:
            if int(self._pending_overflow) > self.config.entry_budget:
                self.overflow_events += 1
                self._occupancy_due = True   # raise the rung next step
        self._pending_overflow = entries_total

    def maybe_densify(self, it: int) -> Optional[dict]:
        opt = self.opt
        info = None
        # Keep the budget ladder fresh for the whole run: optimisation after
        # densification still moves and inflates splats.
        if it % opt.densification_interval == 0:
            self._occupancy_due = True
        if it < opt.densify_until_iter:
            if (it > opt.densify_from_iter
                    and it % opt.densification_interval == 0):
                max_screen = 20.0 if it > opt.opacity_reset_interval else 0.0
                self.state, info = G.densify_and_prune(
                    self.state, opt.densify_grad_threshold, 0.005,
                    self.extent, max_screen, opt.percent_dense,
                    generator=self.generator)
                if int(info["n_dropped"]) > 0 or (
                        int(info["n_alive"]) > 0.9 * self.state.capacity):
                    self.state = G.grow_capacity(
                        self.state,
                        max(G._round_capacity(
                                int(1.3 * int(info["n_alive"]))),
                            self.state.capacity + 32768))
                self._occupancy_due = True
            # Reset schedule incl. the white-background early reset
            # (reference train_vanilla_3dgs.py:109-110).
            if (it % opt.opacity_reset_interval == 0 and it > 0) or (
                    self.white_background and it == opt.densify_from_iter):
                self.state = G.reset_opacity(self.state)
        return info
