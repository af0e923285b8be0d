"""The 3DGS training step, blocks of steps and their host-side schedule.

Counterpart of wheat3dgs_tpu/training.py (reference: the hot loop of
train_vanilla_3dgs.py:55-121):

- `train_step_views` (a minibatch of B views; `train_step` calls it with
  one view): render -> (1-λ)L1 + λ(1-SSIM) -> gradients -> Adam
  -> densification statistics. It is written functionally, as JAX's
  `value_and_grad` is: the parameters are plain tensors, the step takes
  fresh leaves of them and calls `torch.autograd.grad(loss, leaves)` (plus
  a zero `ndc_offset`, whose gradient is the CUDA rasterizer's viewspace
  gradient), so no `.grad` or optimizer bookkeeping can go stale when
  densification writes new rows or capacity growth replaces every tensor.
  Adam and the statistics update the state's tensors in place. The step's
  scalars (each leaf's learning rate, Adam's bias corrections) come in one
  float32 row on the device (`step_scalars`), so a step captured in a
  CUDA graph reads each step's values.
- `multi_plot_step` (`MultiPlotStep`): one step of P independent plots x
  B views each on states stacked on a leading P axis (the scale-out the
  reference leaves to one SLURM job per plot). The plots run one after
  another on the card, each on views into the stack; on a CUDA device the
  whole step is replayed from a CUDA graph, over NCCL ranks too
  (parallel/mesh.py's trainers pass their `reduce`).
- `Trainer`: camera-independent schedule — SH warm-up, random background
  from a torch.Generator, the occupancy ladder of JAX's
  `_refresh_occupancy` (the entry budget on "pallas"; on "xla"
  `occupancy_probe`'s max tile count and 99th-percentile footprint pick
  max_per_tile and max_tiles_per_gauss), the deferred overflow watchdog
  (on "pallas" only: the padded-tile path reports no demand), and
  densify/prune/opacity reset with capacity growth. A densify that
  leaves the capacity as it was writes its result back into the state's
  own tensors, so the captured step stays valid; only a growth adopts new
  tensors. `Trainer.step` runs one step; `Trainer.step_block` (JAX's
  `step_block` over `train_step_scan`) runs K steps from a device table of
  view picks and scalar rows: on a CUDA device replayed from a CUDA graph
  (`training_graph.StepGraph`), on the CPU as K eager steps of the same
  code.

  With the program's spans on (`utils/trace.py`) the schedule records
  "train.eager_step" (`Trainer.step`'s step), "train.occupancy",
  "train.watchdog" and "train.densify" (with "train.grow_capacity" inside
  it), and every blocking device-to-host read of the schedule counts in
  the `host_reads` counter; `densify_in_place` counts the densifies whose
  result went back into the state's own tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .config import OptimizationParams
from .models import gaussians as G
from .models.optim import adam_update, bias_corrections
from .ops.binning import (capped_rect, count_tiles, num_tiles,
                          pick_entry_budget, pick_max_per_tile, pick_mtpg)
from .ops.losses import l1_loss, ssim
from .ops.projection import project_gaussians
from .render.pipeline import (RasterConfig, entry_demand_probe, render,
                              zero_colors)
from .training_graph import StepGraph
from .utils import trace
from .utils.general import expon_lr

# The step's scalar row: each leaf's learning rate, then Adam's bias
# corrections 1 - b1^t and 1 - b2^t.
SCALARS = G.PARAM_FIELDS + ("c1", "c2")
# Metrics a block keeps of its last step (entries_total is its maximum).
LAST_METRICS = ("loss", "l1", "psnr", "n_alive")
# The (P,) metrics of a multi-plot step and their dtypes.
PLOT_METRICS = {"loss": torch.float32, "l1": torch.float32,
                "psnr": torch.float32, "n_alive": torch.int64,
                "entries_total": torch.int32}


@torch.no_grad()
def occupancy_probe(state: G.GaussianState, w2c, full_proj, cam_center,
                    tanfovx, tanfovy, *, width: int, height: int,
                    tile: int = 16, mtpg: int = 16):
    """One view's max per-tile splat count, the 99th percentile of the
    visible splats' uncapped tile footprints (at least 1) and the total
    entry count, as 0-d tensors (JAX's occupancy_probe): they size the
    padded-tile path's max_per_tile and max_tiles_per_gauss."""
    splats = project_gaussians(
        state.params.means, state.scales(), state.params.quats,
        state.opacity(), w2c, full_proj, cam_center, tanfovx, tanfovy,
        width, height, colors=zero_colors(state))
    counts = count_tiles(splats, width, height, tile, mtpg)
    tiles_x, tiles_y = num_tiles(width, height, tile)
    _, _, sx, sy, _ = capped_rect(splats, tiles_x, tiles_y, tile, 1 << 30)
    vis = splats.radius > 0
    areas = torch.where(vis, sx * sy, torch.zeros_like(sx))
    n = areas.shape[0]
    at = torch.clamp(n - 1 - torch.div(vis.sum(), 100, rounding_mode="floor"),
                     max=n - 1)
    p99 = torch.sort(areas).values[at]
    return counts.max(), torch.clamp(p99, min=1), counts.sum()


def host_int(x: torch.Tensor) -> int:
    """int(x) of a device tensor: a blocking read, counted in
    `host_reads`."""
    trace.count("host_reads")
    return int(x)


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


def render_views(view: G.GaussianState, cams, b: int, *, width: int,
                 height: int, sh_degree: int, bg: torch.Tensor,
                 ndc_offset: torch.Tensor, config: RasterConfig):
    """train_step_views' render over one process: every view of the batch
    from `view`, as [(view index, RenderOut)], and the screen radii's
    maximum over them."""
    outs = [(i, render(view, *(a[i] for a in cams), width, height,
                       sh_degree, bg=bg, ndc_offset=ndc_offset,
                       config=config)) for i in range(b)]
    radii = (outs[0][1].radii if b == 1
             else torch.stack([o.radii for _, o in outs]).amax(0))
    return outs, radii


def grads_of(loss: torch.Tensor, inputs: list) -> list:
    """d loss / d inputs, zeros for an input the loss does not reach."""
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, grads)]


def train_step_views(state: G.GaussianState, cams, gt_images: torch.Tensor,
                     bg: torch.Tensor, scalars: torch.Tensor, *,
                     sh_degree: int, width: int, height: int,
                     opt: OptimizationParams,
                     config: RasterConfig = RasterConfig(), reduce=None):
    """One optimisation step over a minibatch of B views (JAX's
    train_step_views over its _step_core): cams are (w2c, full_proj,
    cam_center, tanfovx, tanfovy) with a leading B axis, gt_images
    (B, 3, H, W); otherwise as `train_step`. B = 1 is the reference's
    single-view step.

    For B > 1 the loss, L1 and the views' MSE (hence PSNR) are means over
    the views, radii and entries_total maxima, and the gradients those of
    the mean loss. entries_total is -1 on the "xla" backend, which reports
    no demand. As in JAX, the shared `ndc_offset`'s gradient (already
    that of the view mean) is divided by B again before it reaches the
    densification statistics: they accumulate |sum of the views'
    viewspace gradients| / B^2.

    `reduce` (parallel.mesh's ViewReduce or GaussRows) spreads the step
    over ranks: these views are one rank's share of B = reduce.total(b)
    and the state may be its share of the rows. reduce.render_views
    renders the views this rank renders (render_views' contract);
    reduce.grads takes the gradients of its share of the mean loss;
    reduce.sum_ sums them and the loss, L1 and MSE sums over the ranks;
    reduce.max_ takes the maxima of radii and entries_total; all before
    Adam; reduce.alive_ counts the alive splats of every rank's rows."""
    b = gt_images.shape[0]
    n = b if reduce is None else reduce.total(b)
    params = state.params.as_dict()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    ndc_zero = torch.zeros((state.capacity, 2), dtype=torch.float32,
                           device=state.device, requires_grad=True)
    view = dataclasses.replace(state, params=G.GaussianParams(**leaves))
    outs, radii = (render_views if reduce is None else reduce.render_views)(
        view, cams, b, width=width, height=height, sh_degree=sh_degree,
        bg=bg, ndc_offset=ndc_zero, config=config)
    losses, l1s = [], []
    for i, out in outs:
        ll1 = l1_loss(out.color, gt_images[i])
        losses.append((1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (
            1.0 - ssim(out.color, gt_images[i])))
        l1s.append(ll1)

    def share(xs):
        """One process: the view mean. Over ranks: this rank's share of
        it (zero where the rank renders none of the views)."""
        if reduce is None:
            return xs[0] if n == 1 else torch.stack(xs).mean()
        if not xs:
            return torch.zeros((), dtype=torch.float32, device=state.device)
        return torch.stack(xs).sum() / n

    loss, ll1 = share(losses), share(l1s)
    totals = [_entries(o, state.device) for _, o in outs]
    entries = (totals[0] if len(totals) == 1 else
               torch.stack(totals).amax() if totals else
               torch.full((), 0 if config.backend == "pallas" else -1,
                          dtype=torch.int32, device=state.device))
    names = list(leaves)
    inputs = [leaves[k] for k in names] + [ndc_zero]
    grads = (grads_of if reduce is None else reduce.grads)(loss, inputs)
    with torch.no_grad():
        mse = share([((o.color - gt_images[i]) ** 2).mean()
                     for i, o in outs])
        loss, ll1 = loss.detach(), ll1.detach()
    if reduce is not None:
        grads, (loss, ll1, mse) = reduce.sum_(grads, [loss, ll1, mse])
        radii, entries = reduce.max_(radii, entries)
    n_lr = len(G.PARAM_FIELDS)
    adam_update(state.adam, dict(zip(names, grads[:-1])), params,
                dict(zip(G.PARAM_FIELDS, scalars[:n_lr])), scalars[n_lr],
                scalars[n_lr + 1])
    G.add_densification_stats(state, grads[-1] if n == 1 else grads[-1] / n,
                              radii)
    with torch.no_grad():
        metrics = {"loss": loss, "l1": ll1,
                   "psnr": 20.0 * -torch.log10(torch.sqrt(mse)),
                   "n_alive": (state.num_alive if reduce is None
                               else reduce.alive_(state.num_alive)),
                   "entries_total": entries}
    return state, metrics


def _entries(out, dev) -> torch.Tensor:
    """A render's entries_total, -1 where the path reports none."""
    if out.entries_total is None:
        return torch.full((), -1, dtype=torch.int32, device=dev)
    return out.entries_total


def train_step(state: G.GaussianState, cam, gt_image: torch.Tensor,
               bg: torch.Tensor, scalars: torch.Tensor, *, sh_degree: int,
               width: int, height: int, opt: OptimizationParams,
               config: RasterConfig = RasterConfig()):
    """One optimisation step on one view (reference semantics), updating
    `state`'s parameters, Adam moments and statistics in place.

    cam: (w2c, full_proj, cam_center, tanfovx, tanfovy) tensors; gt_image
    (3, H, W); scalars: this step's (len(SCALARS),) float32 row on the
    state's device (`step_scalars`; the caller advances state.adam.step).
    Launches nothing that reads the host, so it can be captured in a CUDA
    graph. Returns (state, metrics) with 0-d tensor metrics (nothing is
    read back to the host): loss, l1, psnr, n_alive and entries_total (the
    render's allocation demand; > config.entry_budget means entries were
    cropped; -1 on "xla").
    """
    return train_step_views(state, tuple(a[None] for a in cam),
                            gt_image[None], bg, scalars, sh_degree=sh_degree,
                            width=width, height=height, opt=opt,
                            config=config)


def to_device(host, dev: torch.device) -> torch.Tensor:
    """A host array or tensor on `dev`; on a CUDA device through pinned
    memory, so the copy queues behind the running step instead of waiting
    for it."""
    host = torch.as_tensor(host)
    if dev.type != "cuda":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def plot_scalars(it: int, t: int, opt: OptimizationParams,
                 extents) -> torch.Tensor:
    """(P, len(SCALARS)) float32 on the host: row p is step_scalars(it, t)
    at plot p's extent (each plot's position learning rate scales with its
    own extent, JAX's lr_tree per plot)."""
    return torch.cat([step_scalars(it, t, 1, opt, float(e))
                      for e in extents])


class MultiPlotStep:
    """JAX's multi_plot_step for one SH degree, image size, optimiser and
    raster config: call it as step(states, cams, gt_images, bg, scalars).

    states: a GaussianState whose tensors are stacked on a leading P axis
    (`parallel.mesh.stack_states`; contiguous (P, cap, ...)), updated in
    place; cams: (w2c, full_proj, cam_center, tanfovx, tanfovy) with
    leading (P, B) axes; gt_images (P, B, 3, H, W); bg (3,); scalars
    (P, len(SCALARS)) (`plot_scalars`; the caller advances
    states.adam.step). Returns (states, metrics) with (P,) tensors: loss,
    l1, psnr, n_alive and entries_total.

    Each plot's step is `train_step_views` on views into the stacked
    tensors, so Adam and the statistics write into the stack. The inputs
    are copied into device tensors that stay put, and the step runs
    through one `StepGraph` (`graph`): replayed from a CUDA graph on a CUDA
    device, recaptured when a state tensor (densify, capacity growth,
    opacity reset), the shapes or the entry budget change; run eagerly on
    the CPU.

    `reduce` (parallel.mesh's ViewReduce or GaussRows) is each plot's
    train_step_views `reduce`: the step is this rank's share of a step
    over ranks, and the reduce's process groups join the graph's key. Its
    collectives are captured with the rest of the step (NCCL's take device
    tensors and can be); with `capture` False the step runs eagerly on
    every device, as a staged collective (gloo on CUDA tensors) reads the
    host. parallel.mesh decides `capture` from the ranks
    (`Ranks.captured`)."""

    def __init__(self, sh_degree: int, width: int, height: int,
                 opt: OptimizationParams,
                 config: RasterConfig = RasterConfig(), reduce=None,
                 capture: bool = True):
        self.sh_degree, self.width, self.height = sh_degree, width, height
        self.opt, self.config = opt, config
        self.reduce, self.capture = reduce, capture
        self.graph = StepGraph()
        self._inputs = []
        self._out = {}

    def __call__(self, states: G.GaussianState, cams, gt_images, bg,
                 scalars):
        args = list(cams) + [gt_images, bg, scalars]
        dev = states.device
        if [(a.shape, a.dtype) for a in args] != [
                (b.shape, b.dtype) for b in self._inputs] or (
                self._inputs and self._inputs[0].device != dev):
            self._inputs = [torch.empty_like(a, device=dev) for a in args]
            n = gt_images.shape[0]
            self._out = {k: torch.zeros((n,), dtype=dt, device=dev)
                         for k, dt in PLOT_METRICS.items()}
        for buf, a in zip(self._inputs, args):
            buf.copy_(a)
        if self.capture:
            self.graph.run(lambda: self._step(states), 1, self._key(states),
                           dev)
        else:
            self._step(states)
        return states, {k: v.clone() for k, v in self._out.items()}

    def _step(self, states: G.GaussianState) -> None:
        *cams, gts, bg, scalars = self._inputs
        ms = []
        for p in range(gts.shape[0]):
            _, m = train_step_views(
                G.map_tensors(lambda x: x[p], states),
                tuple(a[p] for a in cams), gts[p], bg, scalars[p],
                sh_degree=self.sh_degree, width=self.width,
                height=self.height, opt=self.opt, config=self.config,
                reduce=self.reduce)
            ms.append(m)
        for k, buf in self._out.items():
            buf.copy_(torch.stack([m[k] for m in ms]))

    def _key(self, states: G.GaussianState) -> tuple:
        """What the captured step bakes in: the address and shape of every
        state tensor and static input and output (the capacity among the
        shapes), the SH degree, the image size, the raster config (the
        entry budget), the optimiser's constants and the reduce's process
        groups. (The collectives' own buffers are allocated inside the
        step, so a replay finds them where the capture put them.)"""
        tensors = (state_tensors(states) + self._inputs
                   + list(self._out.values()))
        return (tuple((t.data_ptr(), tuple(t.shape)) for t in tensors),
                self.sh_degree, self.width, self.height, self.config,
                self.opt, () if self.reduce is None else self.reduce.groups)


def state_tensors(s: G.GaussianState) -> list:
    """Every tensor of a state, in a fixed order (for graph keys, copies
    and comparisons)."""
    return (list(s.params.as_dict().values()) + list(s.adam.mu.values())
            + list(s.adam.nu.values())
            + [s.alive, s.instance_id, s.grad_accum, s.denom,
               s.max_radii2d])


# JAX's name: multi_plot_step(sh_degree, width, height, opt, config) builds
# the step over P plots x B views (JAX vmaps its _step_core over the plots).
multi_plot_step = MultiPlotStep


class Trainer:
    """The host-side training loop: SH warm-up, densify schedule, capacity
    growth and the occupancy ladder (the entry budget on "pallas",
    max_per_tile and max_tiles_per_gauss on "xla"). Mirrors training()
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
        # The last densify's (iteration, info), for the CLI's log.
        self.last_densify = None

    def _refresh_occupancy(self, cam, width: int, height: int) -> None:
        """Re-size the rasterizer from the probed occupancy (at the start,
        after every densify/prune/capacity event and on overflow signals,
        not per step). "pallas": the entry budget from the allocation
        demand, never lowered. "xla": the max_tiles_per_gauss rung over
        the 99th-percentile footprint and the max_per_tile rung over 1.5x
        the max tile count, both free to move either way (JAX's rule)."""
        with trace.span("train.occupancy"):
            if self.config.backend == "pallas":
                demand = host_int(entry_demand_probe(
                    self.state, *cam, width=width, height=height))
                budget = max(self.config.entry_budget,
                             pick_entry_budget(demand))
                if budget != self.config.entry_budget:
                    self.config = dataclasses.replace(self.config,
                                                      entry_budget=budget)
            else:
                max_count, p99_area, _ = occupancy_probe(
                    self.state, *cam, width=width, height=height,
                    tile=self.config.tile,
                    mtpg=self.config.max_tiles_per_gauss)
                mtpg = pick_mtpg(host_int(p99_area))
                mpt = pick_max_per_tile(host_int(max_count), headroom=1.5)
                if (mpt != self.config.max_per_tile
                        or mtpg != self.config.max_tiles_per_gauss):
                    self.config = dataclasses.replace(
                        self.config, max_per_tile=mpt,
                        max_tiles_per_gauss=mtpg)
        self._occupancy_due = False

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
        row = to_device(step_scalars(it, self.state.adam.step + 1, 1,
                                     self.opt, self.extent),
                        self.state.device)[0]
        with trace.span("train.eager_step"):
            self.state, metrics = train_step(
                self.state, cam, gt_image, bg, row,
                sh_degree=self.active_sh_degree, width=width, height=height,
                opt=self.opt, config=self.config)
        self.state.adam.step += 1
        if (self.adaptive_occupancy and self.config.backend == "pallas"
                and it % self.overflow_check_every == 0):
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
        the block's maximum entries_total (-1 on "xla"), as 0-d device
        tensors."""
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
        self._table[:n_steps].copy_(to_device(host, self.state.device))
        self._j.zero_()
        self._block_max.fill_(-1)
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
        if self.adaptive_occupancy and self.config.backend == "pallas":
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
        tensor it reads or writes outside its own memory pool, the raster
        config (the entry budget, or the padded-tile path's rungs), the
        active SH degree and the image size. Capacity growth, opacity
        reset and a checkpoint load replace state tensors, so each changes
        the key; a densify at an unchanged capacity writes into the
        state's tensors (`maybe_densify`) and keeps it."""
        tensors = (state_tensors(self.state) + list(cam_stacks)
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
            with trace.span("train.watchdog"):
                demand = host_int(self._pending_overflow)
            if demand > self.config.entry_budget:
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
        if it >= opt.densify_until_iter:
            return info
        densify = (it > opt.densify_from_iter
                   and it % opt.densification_interval == 0)
        # Reset schedule incl. the white-background early reset
        # (reference train_vanilla_3dgs.py:109-110).
        reset = (it % opt.opacity_reset_interval == 0 and it > 0) or (
            self.white_background and it == opt.densify_from_iter)
        if not (densify or reset):
            return info
        with trace.span("train.densify"):
            if densify:
                max_screen = 20.0 if it > opt.opacity_reset_interval else 0.0
                # densify_and_prune reads a frozen copy: its input is never
                # written afterwards, while the working set is.
                new, info = G.densify_and_prune(
                    G.map_tensors(torch.clone, self.state),
                    opt.densify_grad_threshold, 0.005, self.extent,
                    max_screen, opt.percent_dense, generator=self.generator)
                self.last_densify = (it, info)
                if host_int(info["n_dropped"]) > 0 or (
                        host_int(info["n_alive"]) > 0.9 * new.capacity):
                    with trace.span("train.grow_capacity"):
                        n = int(1.3 * host_int(info["n_alive"]))
                        self.state = G.grow_capacity(new, max(
                            G._round_capacity(n), new.capacity + 32768))
                else:
                    # The captured step's addresses stay: no recapture.
                    G.assign_(self.state, new)
                    trace.count("densify_in_place")
                self._occupancy_due = True
            if reset:
                self.state = G.reset_opacity(self.state)
        return info
