"""Where a training step spends its time on the card.

    python -m wheat3dgs_tpu_torch.apps.profile_train [--width 1600]
        [--height 1200] [--steps 30] [--warmup 50]
        [--out output/profile_train]

Builds the bench plot (the port's synthetic generator, seed 0: 200,000
splats, 12 views; its points3D hold 100,000 points) in a work directory
under --out, creates the Gaussians from the point cloud as training does,
runs --warmup Trainer steps (no densification), then at SH degree 3:
- times each stage of `training.train_step` with CUDA events over --steps
  steps on the train views in turn (launch gaps included): projection +
  SH forward, the allocation prologue with decode_cull and the key sort,
  the feature table and composite_train_fwd, the loss forward, its
  backward to the image, composite_bwd + segsum, autograd of the feature
  table / projection / SH, Adam, and the densification statistics;
- times the two ways the CLI runs steps at the same state, in turns
  (step, block, block, step), each turn BLOCK iterations that end before
  the next multiple of 40 (the bench's densify interval, so no probe runs
  inside): Trainer.step per iteration and one Trainer.step_block (a step
  replayed from a CUDA graph); ms per step and it/s on the host clock
  (each turn ends in a synchronize), and the graph's captures and the
  seconds each took;
- traces one turn of each mode with torch.profiler and reports the device
  time per step, the device's busy share of the wall time and, for
  Trainer.step, the device time by kernel.
Prints one JSON line and writes the profiler table to --out. Needs a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time
from argparse import ArgumentParser

import torch

# Iterations per timed turn: a window [40 m + 1, 40 m + 39] holds no
# multiple of the densify interval (40), so no budget probe runs inside.
BLOCK = 39


class _Stages:
    """Accumulates CUDA-event times per named stage."""

    def __init__(self):
        self.events = {}

    def run(self, name, fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        self.events.setdefault(name, []).append((start, stop))
        return out

    def ms(self, n: int) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) / n
                for k, v in self.events.items()}


def _staged_step(stages: _Stages, state, cam, gt, bg, it, trainer, w, h):
    """training.train_step, split into its stages (the same calls in the
    same order)."""
    from ..models import gaussians as G
    from ..models.optim import adam_update
    from ..ops import cuda_raster as CR
    from ..ops.losses import l1_loss, ssim
    from ..ops.projection import project_gaussians
    from ..training import SCALARS, step_scalars

    opt, deg = trainer.opt, trainer.active_sh_degree
    params = state.params.as_dict()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    ndc = torch.zeros((state.capacity, 2), device=state.device,
                      requires_grad=True)
    view = dataclasses.replace(state, params=G.GaussianParams(**leaves))
    splats = stages.run("project_sh_fwd", lambda: project_gaussians(
        view.params.means, view.scales(), view.params.quats, view.opacity(),
        *cam, w, h, sh=view.sh(), sh_degree=deg, ndc_offset=ndc))

    def prologue():
        with torch.no_grad():
            plan = CR.alloc_prologue(splats, w, h,
                                     trainer.config.entry_budget)
            keys, _ = CR.decode_cull(plan)
            return plan, CR.sorted_stream(keys, plan.t_total,
                                          plan.rank_bits, with_perm=True)

    plan, (skeys, starts, ends, perm) = stages.run("prologue_decode_sort",
                                                   prologue)

    def forward():
        feat = CR.entry_features(splats, plan.order, True, True)
        with torch.no_grad():
            img, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                               plan.rank_bits, w, h)
        return feat, img, stop

    feat, img, stop = stages.run("features_composite_train_fwd", forward)
    img_v = img.requires_grad_(True)

    def loss_fwd():
        color = img_v[2:5] + (1.0 - img_v[0])[None] * bg[:, None, None]
        ll1 = l1_loss(color, gt)
        return (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (
            1.0 - ssim(color, gt))

    loss = stages.run("loss_fwd", loss_fwd)
    g_img = stages.run("loss_bwd", lambda: torch.autograd.grad(
        loss, img_v)[0].contiguous())
    d_feat = stages.run("composite_bwd_segsum", lambda: CR.segsum(
        CR.composite_bwd(skeys, perm, starts, ends, feat, img, stop, g_img,
                         plan.rank_bits, w, h), plan.seg_start, plan.seg_end))
    inputs = list(leaves.values()) + [ndc]
    grads = stages.run("autograd_features_projection_sh",
                       lambda: torch.autograd.grad(feat, inputs, d_feat))
    row = step_scalars(it, state.adam.step + 1, 1, opt, trainer.extent)[0]
    row = row.pin_memory().to(state.device, non_blocking=True)
    n_lr = len(SCALARS) - 2
    stages.run("adam", lambda: adam_update(
        state.adam, dict(zip(leaves, grads[:-1])), params,
        dict(zip(leaves, row[:n_lr])), row[n_lr], row[n_lr + 1]))
    state.adam.step += 1
    stages.run("densification_stats", lambda: G.add_densification_stats(
        state, grads[-1], splats.radius))


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--out", default=os.path.join("output",
                                                  "profile_train"))
    args = ap.parse_args(argv)

    from .. import config as cfg
    from .. import resolve_device
    from ..config import OptimizationParams
    from ..io.synthetic import make_synthetic_colmap_scene
    from ..ops import cuda_build
    from ..scene import Scene
    from ..training import Trainer

    dev = resolve_device("cuda")
    cuda_build.build()
    work = os.path.join(args.out, "work")
    shutil.rmtree(work, ignore_errors=True)
    make_synthetic_colmap_scene(
        os.path.join(work, "scene"), width=args.width, height=args.height,
        n_heads=32, pts_per_head=3000, ground_pts=104_000, seed=0,
        with_masks=False, device=dev)
    scene = Scene(cfg.ModelParams(source_path=os.path.join(work, "scene"),
                                  model_path=os.path.join(work, "model")),
                  device=dev)
    w, h = scene.image_size
    n_train = len(scene.data.train)
    cams = [scene.cam_arrays("train", i) for i in range(n_train)]
    gts = torch.as_tensor(scene.data.train.images, device=dev)
    opt = OptimizationParams(densify_from_iter=10 ** 9,
                             densification_interval=40)
    trainer = Trainer(scene.gaussians, opt, scene.cameras_extent,
                      sh_degree=3)
    for it in range(1, args.warmup + 1):
        trainer.step(it, cams[it % n_train], gts[it % n_train], w, h)
    trainer.active_sh_degree = 3
    it0 = 10_001     # no SH ramp, densify event or budget probe inside

    # One untimed staged step first: the warm-up ran at SH degree 0, and
    # the first steps at degree 3 pay one-time costs.
    _staged_step(_Stages(), trainer.state, cams[0], gts[0], trainer.bg,
                 it0, trainer, w, h)
    stages = _Stages()
    for i in range(args.steps):
        _staged_step(stages, trainer.state, cams[i % n_train],
                     gts[i % n_train], trainer.bg, it0 + i, trainer, w, h)
    stage_ms = stages.ms(args.steps)

    stacks = scene.cam_stack("train")
    windows = iter(range(it0, 10 ** 9, 40))

    def turn(mode):
        """BLOCK iterations of the next window, by `mode`; ends in a
        synchronize."""
        first = next(windows)
        vis = [(first + i) % n_train for i in range(BLOCK)]
        if mode == "block":
            trainer.step_block(first, vis, stacks, gts, w, h, n_steps=BLOCK)
        else:
            for i, v in enumerate(vis):
                trainer.step(first + i, cams[v], gts[v], w, h)
        torch.cuda.synchronize()

    turn("step")      # warm-up of both modes; the block captures here
    turn("block")
    turns = []
    for mode in ("step", "block", "block", "step"):
        captures = trainer.graph.captures
        t0 = time.perf_counter()
        turn(mode)
        ms = (time.perf_counter() - t0) / BLOCK * 1e3
        turns.append({"mode": mode, "ms_per_step": ms, "it_per_s": 1e3 / ms,
                      "captures": trainer.graph.captures - captures})

    from torch.profiler import ProfilerActivity, profile

    traced = {}
    for mode in ("step", "block"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            turn(mode)
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        traced[mode] = {
            "device_busy_share": device_us / wall_us if wall_us else None,
            "device_ms_per_step": device_us / BLOCK / 1e3,
            "host_ms_per_step": wall_us / BLOCK / 1e3}
        if mode == "step":
            table = events.table(sort_by="self_device_time_total",
                                 row_limit=40)
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            top_us = {e.key: e.self_device_time_total / BLOCK
                      for e in top[:15]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        f.write(table)
    n_alive = int(trainer.state.num_alive)
    shutil.rmtree(work, ignore_errors=True)
    print(table)

    def mean(mode, key):
        vals = [t[key] for t in turns if t["mode"] == mode]
        return sum(vals) / len(vals)

    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "splats": n_alive,
        "capacity": trainer.state.capacity, "width": w, "height": h,
        "sh_degree": 3, "entry_budget": trainer.config.entry_budget,
        "stage_ms": stage_ms, "stage_ms_sum": sum(stage_ms.values()),
        "block_steps": BLOCK, "turns": turns,
        "step_ms_host": mean("step", "ms_per_step"),
        "block_ms_host": mean("block", "ms_per_step"),
        "it_per_s": {m: mean(m, "it_per_s") for m in ("step", "block")},
        "captures": trainer.graph.captures,
        "capture_seconds": trainer.graph.capture_seconds,
        "replays": trainer.graph.replays, "traced": traced,
        "top_device_us_per_step": top_us}))


if __name__ == "__main__":
    main(sys.argv[1:])
