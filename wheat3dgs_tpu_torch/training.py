"""The 3DGS training step, blocks of steps and their host-side schedule.

Counterpart of wheat3dgs_tpu/training.py (reference: the hot loop of
train_vanilla_3dgs.py:55-121):

- `train_step`: render -> (1-λ)L1 + λ(1-SSIM) -> gradients -> Adam ->
  densification statistics. It is written functionally, as JAX's
  `value_and_grad` is: the parameters are plain tensors, the step takes
  fresh leaves of them and calls `torch.autograd.grad(loss, leaves)` (plus
  a zero `ndc_offset`, whose gradient is the CUDA rasterizer's viewspace
  gradient). Densification and capacity growth replace every tensor, so no
  `.grad` or optimizer bookkeeping can go stale. Adam and the statistics
  then update the state's tensors in place. The step's scalars (each
  leaf's learning rate, Adam's bias corrections) come in one float32 row
  on the device (`step_scalars`), so a step captured in a CUDA graph
  reads each step's values.
- `Trainer`: camera-independent schedule — SH warm-up, random background
  from a torch.Generator, the entry-budget ladder (the JAX Pallas branch of
  `_refresh_occupancy`; the port has no XLA backend), the deferred overflow
  watchdog, and densify/prune/opacity reset with capacity growth.
  `Trainer.step` runs one step; `Trainer.step_block` (JAX's `step_block`
  over `train_step_scan`) runs K steps from a device table of view picks
  and scalar rows: on a CUDA device replayed from a CUDA graph
  (`training_graph.StepGraph`), on the CPU as K eager steps of the same
  code.

JAX's `train_step_views` / `multi_plot_step` (view and plot batches for the
scale-out slice) have no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .config import OptimizationParams
from .models import gaussians as G
from .models.optim import adam_update, bias_corrections
from .ops.binning import pick_entry_budget
from .ops.losses import l1_loss, ssim
from .render.pipeline import RasterConfig, entry_demand_probe, render
from .training_graph import StepGraph
from .utils.general import expon_lr

# The step's scalar row: each leaf's learning rate, then Adam's bias
# corrections 1 - b1^t and 1 - b2^t.
SCALARS = G.PARAM_FIELDS + ("c1", "c2")
# Metrics a block keeps of its last step (entries_total is its maximum).
LAST_METRICS = ("loss", "l1", "psnr", "n_alive")


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


def step_scalars(it0: int, t0: int, n: int, opt: OptimizationParams,
                 extent: float) -> torch.Tensor:
    """(n, len(SCALARS)) float32 on the host: row j holds lr_tree(it0 + j)
    and the bias corrections of Adam's (t0 + j)-th update, computed in
    float64 and cast once."""
    rows = []
    for j in range(n):
        lrs = lr_tree(it0 + j, opt, extent)
        rows.append([lrs[f] for f in G.PARAM_FIELDS]
                    + list(bias_corrections(t0 + j)))
    return torch.tensor(rows, dtype=torch.float64).to(torch.float32)


def train_step(state: G.GaussianState, cam, gt_image: torch.Tensor,
               bg: torch.Tensor, scalars: torch.Tensor, *, sh_degree: int,
               width: int, height: int, opt: OptimizationParams,
               config: RasterConfig = RasterConfig()):
    """One optimisation step on one view (reference semantics), updating
    `state`'s parameters, Adam moments and statistics in place.

    cam: (w2c, full_proj, cam_center, tanfovx, tanfovy); gt_image (3, H, W);
    scalars: this step's (len(SCALARS),) float32 row on the state's device
    (`step_scalars`; the caller advances state.adam.step). Launches
    nothing that reads the host, so it can be captured in a CUDA graph.
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
    n_lr = len(G.PARAM_FIELDS)
    adam_update(state.adam, dict(zip(names, grads[:-1])), params,
                dict(zip(G.PARAM_FIELDS, scalars[:n_lr])), scalars[n_lr],
                scalars[n_lr + 1])
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

    def __init__(self, state: G.GaussianState, opt: OptimizationParams,
                 cameras_extent: float, sh_degree: int = 3,
                 config: RasterConfig = RasterConfig(), seed: int = 0,
                 white_background: bool = False,
                 adaptive_occupancy: bool = True,
                 overflow_check_every: int = 10):
        self.state = state
        self.white_background = white_background
        self.opt = opt
        self.extent = float(cameras_extent)
        self.max_sh_degree = sh_degree
        self.active_sh_degree = 0
        self.config = config
        self.adaptive_occupancy = adaptive_occupancy
        self._occupancy_due = True
        # Overflow watchdog period: every k-th step's entry telemetry (and
        # every block's maximum) is queued and read at the NEXT check.
        # Demand above the budget re-probes and raises the rung for the
        # step after: a population that inflates within a densify interval
        # crops at most 2k steps (two blocks).
        self.overflow_check_every = max(1, int(overflow_check_every))
        self.overflow_events = 0
        self._pending_overflow = None
        dev = state.device
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.bg = torch.full((3,), 1.0 if white_background else 0.0,
                             dtype=torch.float32, device=dev)
        # step_block's device inputs and outputs: the table of view picks
        # and scalar rows, the step counter, the background, the last
        # step's metrics and the block's maximum entries_total; the graph
        # that replays its step.
        self.graph = StepGraph()
        self._table = self._j = self._bg = None
        self._last = self._block_max = None

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

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        dev = self.state.device
        if dev.type != "cuda":
            return host
        # Pinned, so the copy queues behind the step instead of waiting.
        return host.pin_memory().to(dev, non_blocking=True)

    def _background(self) -> torch.Tensor:
        if self.opt.random_background:   # reference train loop :67
            return torch.rand((3,), generator=self.generator,
                              device=self.bg.device)
        return self.bg

    def step(self, it: int, cam, gt_image: torch.Tensor, width: int,
             height: int) -> dict:
        """cam: (w2c, full_proj, cam_center, tanfovx, tanfovy) tensors."""
        if it % 1000 == 0 and self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1  # oneupSHdegree (train loop :61-62)
        if self.adaptive_occupancy and self._occupancy_due:
            self._refresh_occupancy(cam, width, height)
        bg = self._background()
        row = self._to_device(step_scalars(it, self.state.adam.step + 1, 1,
                                           self.opt, self.extent))[0]
        self.state, metrics = train_step(
            self.state, cam, gt_image, bg, row,
            sh_degree=self.active_sh_degree, width=width, height=height,
            opt=self.opt, config=self.config)
        self.state.adam.step += 1
        if self.adaptive_occupancy and it % self.overflow_check_every == 0:
            self._check_overflow(metrics["entries_total"])
        self.maybe_densify(it)
        return metrics

    def step_block(self, it0: int, view_idx, cam_stacks,
                   gt_stack: torch.Tensor, width: int, height: int,
                   n_steps: int) -> dict:
        """Run n_steps reference steps, it0 .. it0 + n_steps - 1, without a
        host read in between (JAX's step_block).

        cam_stacks: (w2c (V,4,4), full_proj (V,4,4), cam_center (V,3),
        tanfovx (V,), tanfovy (V,)) and gt_stack (V,3,H,W) on the device;
        view_idx: n_steps view picks. The SH ramp and the budget probe run
        at the block start (on the stack's first camera), one background
        serves the block, and the watchdog (on the block's maximum
        entries_total) and densify run after it, on its last iteration:
        the caller ends blocks before an SH multiple and at densify
        iterations. Returns the last step's loss, l1, psnr and n_alive and
        the block's maximum entries_total, as 0-d device tensors."""
        if n_steps < 1:
            raise ValueError(f"n_steps {n_steps} < 1")
        views = [int(v) for v in view_idx]
        n_views = gt_stack.shape[0]
        if len(views) != n_steps or not all(0 <= v < n_views for v in views):
            raise ValueError(f"view picks {views} for {n_steps} steps of "
                             f"{n_views} views")
        it_last = it0 + n_steps - 1
        if it0 % 1000 == 0 and self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1
        if self.adaptive_occupancy and self._occupancy_due:
            self._refresh_occupancy(tuple(a[0] for a in cam_stacks), width,
                                    height)
        bg = self._background()
        host = torch.cat([step_scalars(it0, self.state.adam.step + 1,
                                       n_steps, self.opt, self.extent),
                          torch.tensor(views, dtype=torch.float32)[:, None]],
                         dim=1)
        self._block_buffers(n_steps)
        self._table[:n_steps].copy_(self._to_device(host))
        self._j.zero_()
        self._block_max.zero_()
        self._bg.copy_(bg)
        deg, config = self.active_sh_degree, self.config

        def one_step():
            row = self._table.index_select(0, self._j)[0]
            vi = row[-1:].to(torch.int64)
            cam = tuple(a.index_select(0, vi)[0] for a in cam_stacks)
            gt = gt_stack.index_select(0, vi)[0]
            _, m = train_step(self.state, cam, gt, self._bg, row[:-1],
                              sh_degree=deg, width=width, height=height,
                              opt=self.opt, config=config)
            torch.maximum(self._block_max, m["entries_total"],
                          out=self._block_max)
            for k, buf in self._last.items():
                buf.copy_(m[k])
            self._j.add_(1)

        key = self._graph_key(cam_stacks, gt_stack, width, height)
        self.graph.run(one_step, n_steps, key, self.state.device)
        self.state.adam.step += n_steps
        metrics = {k: v.clone() for k, v in self._last.items()}
        metrics["entries_total"] = self._block_max.clone()
        if self.adaptive_occupancy:
            self._check_overflow(metrics["entries_total"])
        self.maybe_densify(it_last)
        return metrics

    def _block_buffers(self, n_steps: int) -> None:
        """(Re)allocate step_block's static device tensors: on first use
        and for more steps than the table holds."""
        if self._table is not None and self._table.shape[0] >= n_steps:
            return
        dev = self.state.device
        self._table = torch.zeros((max(64, n_steps), len(SCALARS) + 1),
                                  dtype=torch.float32, device=dev)
        self._j = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._block_max = torch.zeros((), dtype=torch.int32, device=dev)
        self._bg = torch.zeros((3,), dtype=torch.float32, device=dev)
        self._last = {k: torch.zeros((), dtype=torch.float32, device=dev)
                      for k in LAST_METRICS}
        self._last["n_alive"] = torch.zeros((), dtype=torch.int64,
                                            device=dev)

    def _graph_key(self, cam_stacks, gt_stack, width: int,
                   height: int) -> tuple:
        """What a captured step bakes in: the address and shape of every
        tensor it reads or writes outside its own memory pool, the entry
        budget, the active SH degree and the image size. Densify/prune,
        capacity growth, opacity reset and a checkpoint load replace state
        tensors, so each changes the key."""
        s = self.state
        tensors = (list(s.params.as_dict().values())
                   + list(s.adam.mu.values()) + list(s.adam.nu.values())
                   + [s.alive, s.grad_accum, s.denom, s.max_radii2d]
                   + list(cam_stacks)
                   + [gt_stack, self._table, self._j, self._block_max,
                      self._bg]
                   + list(self._last.values()))
        return (tuple((t.data_ptr(), tuple(t.shape)) for t in tensors),
                self.config, self.active_sh_degree, width, height, self.opt)

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
