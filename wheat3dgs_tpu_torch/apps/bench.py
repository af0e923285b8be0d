"""Training-throughput benchmark on the port: trains the bench plot and
prints ONE JSON line of its steady training rate (plus the render rate).

Counterpart of the repo's bench.py, with the same scene, schedule, random
draws and output keys:

    python -m wheat3dgs_tpu_torch.apps.bench [--device cuda|cpu]

prints on stdout
    {"metric": "train_iters_per_sec", "value": N, "unit": "it/s",
     "vs_baseline": N / 60, "mean_ms": ..., "median_ms": ...,
     "n_splats": ..., "render_fps": ...}
and the card's name and power limit (nvidia-smi), the load, warm-up,
training and render lines on stderr. The baseline is bench.py's 60
training it/s.

- Environment: WHEAT3DGS_BENCH_SCENE (default
  `.bench_cache/torch_scene_100k` under the repo root, apart from any
  scene the JAX generator wrote), WHEAT3DGS_BENCH_W / _H (1600 x 1200;
  they size a scene made here) and WHEAT3DGS_BENCH_ITERS (600).
- Scene: made by the port's generator when missing (32 heads x 3000
  points + 104,000 ground points, seed 0, no masks; points3D holds half:
  ~100k initial splats), loaded at SH 3.
- Schedule: densify from 20 every 40 until the end less 100, no opacity
  reset; SH held at its maximum.
- Warm-up: 100 `Trainer.step` calls on views drawn from
  `np.random.default_rng(0)`, one step at the warm-up iteration on view
  0, then three blocks of WINDOW steps on view 0 at the current budget and
  the next two rungs. bench.py runs those blocks to compile the scanned
  block for each rung (XLA compiles each budget anew); here
  `training_graph.StepGraph` captures the block's step once per budget
  and replays it (0.16-0.26 s a capture on the H100), and a capture in
  the timed window is absorbed by the median. The blocks stay so that the
  draws and the state match bench.py's.
- Timed: `Trainer.step_block` blocks of WINDOW steps from the warm-up + 1
  to the end, each on `rng.integers(n_train, size=WINDOW)` views; a
  block's time is the host clock after a `torch.cuda.synchronize()`. The
  rate is one over the median step time of the blocks, as in bench.py.
  The stderr line adds the whole-window rate, the timed iterations over
  the windows' total time: it keeps the recaptures after each densify
  (a user pays them), which the median hides.
- Render rate: `adapt_config` with the budget probed over every fourth
  train camera, one untimed `render_fwd`, then 30 over rotating cameras
  with one synchronize at the end. The stderr line also gives the
  renders' largest entry demand against the budget, and the training
  line the trainer's overflow events.
There is no counterpart of bench.py's remote-TPU health probe or its
.jax_cache.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from .. import resolve_device
from ..config import ModelParams, OptimizationParams
from ..io.synthetic import make_synthetic_colmap_scene
from ..ops.binning import pick_entry_budget
from ..render.pipeline import (RasterConfig, adapt_config, inference_config,
                               render_fwd)
from ..scene import Scene
from ..training import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WARMUP = 100
WINDOW = 20
RENDER_REPS = 30
BASELINE_IPS = 60.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_scene(scene_dir: str, dev: torch.device) -> Scene:
    """The bench scene at SH 3, train/test split, full resolution."""
    model = ModelParams(source_path=scene_dir, model_path="", eval=True,
                        resolution=1)
    t0 = time.time()
    scene = Scene(model, sh_degree=3, shuffle=False, device=dev)
    print(f"scene loaded in {time.time() - t0:.1f}s "
          f"({int(scene.gaussians.num_alive)} splats)", file=sys.stderr)
    return scene


def train(scene: Scene, iters: int, dev: torch.device):
    """bench.py's Trainer, warm-up, rung blocks and timed windows:
    (trainer, the train cameras, the last step's metrics, the seconds a
    step of each window)."""
    w, h = scene.image_size
    opt = OptimizationParams(iterations=iters, densify_from_iter=20,
                             densify_until_iter=iters - 100,
                             densification_interval=40,
                             opacity_reset_interval=100_000)
    trainer = Trainer(scene.gaussians, opt, scene.cameras_extent,
                      sh_degree=3, config=inference_config(RasterConfig()))
    trainer.active_sh_degree = trainer.max_sh_degree
    gt_images = torch.as_tensor(scene.data.train.images, device=dev)
    n_train = gt_images.shape[0]
    cams = [scene.cam_arrays("train", i) for i in range(n_train)]

    rng = np.random.default_rng(0)
    t0 = time.time()
    for it in range(1, WARMUP + 1):
        vi = int(rng.integers(n_train))
        m = trainer.step(it, cams[vi], gt_images[vi], w, h)
        if it in (1, WARMUP):
            _sync(dev)
            print(f"warmup it {it} done at {time.time() - t0:.1f}s",
                  file=sys.stderr)
    trainer.active_sh_degree = trainer.max_sh_degree
    m = trainer.step(WARMUP, cams[0], gt_images[0], w, h)
    cam_stacks = scene.cam_stack("train")
    # bench.py's pre-compile blocks at the current and the next two budget
    # rungs (see the module docstring).
    saved = trainer.config
    rung = saved.entry_budget
    for _ in range(3):
        m = trainer.step_block(WARMUP, np.zeros(WINDOW, np.int64),
                               cam_stacks, gt_images, w, h, n_steps=WINDOW)
        rung = pick_entry_budget(int(rung) + 1, headroom=1.0)
        trainer.config = dataclasses.replace(saved, entry_budget=rung)
    trainer.config = saved
    _sync(dev)

    win_times = []
    t_prev = time.time()
    for it0 in range(WARMUP + 1, iters + 1, WINDOW):
        vis = rng.integers(n_train, size=WINDOW)
        m = trainer.step_block(it0, vis, cam_stacks, gt_images, w, h,
                               n_steps=WINDOW)
        _sync(dev)
        now = time.time()
        win_times.append((now - t_prev) / WINDOW)
        t_prev = now
    return trainer, cams, m, win_times


def render_config(trainer: Trainer, cams, w: int, h: int) -> RasterConfig:
    """The render rate's config: the forward-only inference path (render_sets,
    eval, 360, viewer) at a budget probed over every fourth train camera."""
    return adapt_config(trainer.state, cams[0], w, h,
                        inference_config(RasterConfig()),
                        cams=cams[::4])


def main(argv=None) -> dict:
    parser = ArgumentParser(description="wheat3dgs_tpu_torch training "
                            "throughput benchmark")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..utils.cuda_timing import smi_line

        print(smi_line(), file=sys.stderr)
        print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    else:
        print(f"device: {dev}", file=sys.stderr)

    scene_dir = os.environ.get("WHEAT3DGS_BENCH_SCENE", os.path.join(
        ROOT, ".bench_cache", "torch_scene_100k"))
    width = int(os.environ.get("WHEAT3DGS_BENCH_W", "1600"))
    height = int(os.environ.get("WHEAT3DGS_BENCH_H", "1200"))
    iters = int(os.environ.get("WHEAT3DGS_BENCH_ITERS", "600"))

    if not os.path.exists(os.path.join(scene_dir, "sparse", "0",
                                       "points3D.bin")):
        t0 = time.time()
        make_synthetic_colmap_scene(
            scene_dir, width=width, height=height, n_heads=32,
            pts_per_head=3000, ground_pts=104_000, seed=0, with_masks=False,
            device=dev)
        print(f"synthesized scene in {time.time() - t0:.1f}s",
              file=sys.stderr)

    scene = load_scene(scene_dir, dev)
    w, h = scene.image_size
    trainer, cams, m, win_times = train(scene, iters, dev)
    n_done = len(win_times) * WINDOW
    total = sum(t * WINDOW for t in win_times)
    # The median window is the steady rate: a recapture (densify, budget
    # rung) falls into one window. The whole-window rate (every timed
    # iteration over the windows' total time) keeps those stalls.
    med = float(np.median(win_times))
    mean = total / max(1, n_done)
    ips = 1.0 / med
    print(f"train: {n_done} iters in {total:.2f}s "
          f"(mean {1e3 * mean:.1f} ms, median "
          f"{1e3 * med:.1f} ms -> {ips:.1f} it/s; whole-window "
          f"{n_done / max(total, 1e-9):.1f} it/s) @{w}x{h}, "
          f"n_alive={int(m['n_alive'])}, psnr={float(m['psnr']):.2f}, "
          f"overflow_events={trainer.overflow_events}", file=sys.stderr)

    config = render_config(trainer, cams, w, h)
    render_fwd(trainer.state, *cams[0], w, h, sh_degree=3, config=config)
    _sync(dev)
    demand = []
    t0 = time.time()
    for r in range(RENDER_REPS):
        out = render_fwd(trainer.state, *cams[r % len(cams)], w, h,
                         sh_degree=3, config=config)
        if out.entries_total is not None:
            demand.append(out.entries_total)
    _sync(dev)
    fps = RENDER_REPS / (time.time() - t0)
    top = int(torch.stack(demand).max()) if demand else -1
    print(f"render: {fps:.1f} FPS @{w}x{h} (forward-only inference path), "
          f"demand max {top} of budget {config.entry_budget}",
          file=sys.stderr)

    result = {"metric": "train_iters_per_sec", "value": round(ips, 2),
              "unit": "it/s", "vs_baseline": round(ips / BASELINE_IPS, 3),
              "mean_ms": round(1e3 * mean, 1),
              "median_ms": round(1e3 * med, 1),
              "n_splats": int(m["n_alive"]),
              "render_fps": round(fps, 1)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
