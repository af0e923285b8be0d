"""Several plots trained in one process: P plots x B views a step.

Counterpart of wheat3dgs_tpu/apps/train_multi.py (reference: one SLURM
job per plot, run_wheat_3dgs.sh:7,23-28), with its arguments plus
`--device`:

    python -m wheat3dgs_tpu_torch.apps.train_multi --source_base <dir> \
        --model_base <out> --iterations 7000 [--views_per_step 2] \
        [--device cuda|cpu]

`--source_base` trains every `plot_*` folder in it, `--source_paths` the
folders given. The plots must share a resolution and a number of train
views; their capacities are equalised with `grow_capacity`. Per-plot
states are stacked on a leading P axis and every iteration runs one
`training.multi_plot_step` (on a CUDA device replayed from a CUDA graph)
on B views per plot drawn by `np.random.default_rng(seed).integers`, the
picks JAX's app draws. The schedule is JAX's: the SH ramp every 1000
iterations, densify and prune per plot (`max_screen` 20 after the first
opacity reset; each plot's split noise from one torch.Generator), the
shared capacity doubled (zeros on every per-Gaussian tensor) when a plot
drops a request or exceeds 0.9 of it, and the opacity reset every
`opacity_reset_interval` iterations. The entry budget is JAX's
`entry_budget = 0`: 16 per capacity slot. Writes `metrics_multi.jsonl`
(`iter`, per-plot `loss` / `psnr` / `n_alive` lists, `elapsed_s`) every
`log_every` iterations and at the end, and each plot's `cfg_args` and
`point_cloud/iteration_<N>/point_cloud.ply`.

`--max_per_tile` is a knob of JAX's XLA backend, accepted and unused. The
mesh is factored over this process's one device as JAX factors it over
its devices, which gives 1 x 1 (parallel/mesh.py).
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

from .. import config as cfg
from .. import resolve_device
from ..models import gaussians as G
from ..models.serialization import save_ply
from ..parallel import mesh as M
from ..render.pipeline import RasterConfig
from ..scene import Scene
from ..training import multi_plot_step, plot_scalars, to_device
from ..utils.general import seed_everything


def load_plots(source_paths, model_base, model_tpl: cfg.ModelParams,
               sh_degree: int, device):
    scenes = []
    for sp in source_paths:
        name = os.path.basename(os.path.normpath(sp))
        model = dataclasses.replace(
            model_tpl, source_path=sp,
            model_path=os.path.join(model_base, name))
        os.makedirs(model.model_path, exist_ok=True)
        cfg.save_cfg_args(model.model_path, model)
        scenes.append(Scene(model, sh_degree=sh_degree, device=device))
    # A common capacity, so the states stack.
    cap = max(s.gaussians.capacity for s in scenes)
    for s in scenes:
        if s.gaussians.capacity < cap:
            s.gaussians = G.grow_capacity(s.gaussians, cap)
    return scenes


def mesh_factors(n_plots: int, views_per_step: int, n_dev: int):
    """(plot, view) axis sizes over n_dev devices, JAX's rule: the plot
    axis divides the plot count and the devices, the view axis the views
    per step; spare devices stay idle."""
    n_plot_dev = max(d for d in range(1, min(n_plots, n_dev) + 1)
                     if n_plots % d == 0 and n_dev % d == 0)
    rem = n_dev // n_plot_dev
    n_view_dev = max(d for d in range(1, min(views_per_step, rem) + 1)
                     if views_per_step % d == 0)
    return n_plot_dev, n_view_dev


def _plot(states: G.GaussianState, p: int) -> G.GaussianState:
    return G.map_tensors(lambda x: x[p], states)


def _pad_cap(states: G.GaussianState) -> G.GaussianState:
    """Double the shared capacity: zeros after every per-Gaussian row."""
    return G.map_tensors(
        lambda x: torch.cat([x, torch.zeros_like(x)], dim=1), states)


def training(source_paths, model_base, opt: cfg.OptimizationParams,
             model_tpl: cfg.ModelParams, sh_degree: int = 3,
             views_per_step: int = 1, config: RasterConfig = RasterConfig(),
             log_every: int = 100, quiet: bool = False, seed: int = 0,
             device="cuda"):
    """Train the plots together; returns (scenes, stacked final states)."""
    dev = resolve_device(device)
    scenes = load_plots(source_paths, model_base, model_tpl, sh_degree, dev)
    n_plots = len(scenes)
    w, h = scenes[0].image_size
    for s in scenes:
        if s.image_size != (w, h):
            raise ValueError("plots must share a resolution")

    devices = [dev]
    n_plot_dev, n_view_dev = mesh_factors(n_plots, views_per_step,
                                          len(devices))
    mesh = M.make_mesh(n_plots=n_plot_dev, n_views=n_view_dev,
                       devices=devices[:n_plot_dev * n_view_dev])
    if not quiet:
        print(f"mesh: {mesh.shape} over {len(devices)} devices; "
              f"{n_plots} plots x {views_per_step} views/step @{w}x{h}")

    # Over the mesh's one device, JAX's shardings are placements on it: the
    # tensors below are made there.
    states = M.stack_states([s.gaussians for s in scenes])
    # (P, V, ...) camera and image banks; each step's picks are gathered.
    gts = torch.stack([torch.as_tensor(s.data.train.images, device=dev)
                       for s in scenes])
    cam_stacks = [torch.stack(list(c))
                  for c in zip(*(s.cam_stack("train") for s in scenes))]
    extents = [float(s.cameras_extent) for s in scenes]
    bg = torch.full((3,), 1.0 if model_tpl.white_background else 0.0,
                    dtype=torch.float32, device=dev)
    n_views = gts.shape[1]
    plot_rows = torch.arange(n_plots, device=dev)[:, None]
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    step = None
    rng = np.random.default_rng(seed)
    active_sh = 0
    t0 = time.time()
    with open(os.path.join(model_base, "metrics_multi.jsonl"), "a") as log_f:
        for it in range(1, opt.iterations + 1):
            if it % 1000 == 0 and active_sh < sh_degree:
                active_sh += 1
            if step is None or step.sh_degree != active_sh:
                step = multi_plot_step(active_sh, w, h, opt, config)
            vi = rng.integers(n_views, size=(n_plots, views_per_step))
            vsel = to_device(vi, dev)
            cams = tuple(c[plot_rows, vsel] for c in cam_stacks)
            gsel = gts[plot_rows, vsel]
            scalars = to_device(plot_scalars(
                it, states.adam.step + 1, opt, extents), dev)
            states, metrics = step(states, cams, gsel, bg, scalars)
            states.adam.step += 1

            if it < opt.densify_until_iter:
                if (it > opt.densify_from_iter
                        and it % opt.densification_interval == 0):
                    max_screen = (20.0 if it > opt.opacity_reset_interval
                                  else 0.0)
                    plots, infos = [], []
                    for p, ext in enumerate(extents):
                        st, info = G.densify_and_prune(
                            _plot(states, p), opt.densify_grad_threshold,
                            0.005, ext, max_screen, opt.percent_dense,
                            generator=generator)
                        plots.append(st)
                        infos.append(info)
                    states = M.stack_states(plots)
                    if max(int(i["n_dropped"]) for i in infos) > 0 or max(
                            int(i["n_alive"]) for i in infos) > \
                            0.9 * states.alive.shape[1]:
                        states = _pad_cap(states)
                if it % opt.opacity_reset_interval == 0 and it > 0:
                    states = G.reset_opacity(states)

            if it % log_every == 0 or it == opt.iterations:
                loss = metrics["loss"].tolist()
                rec = {"iter": it, "loss": loss,
                       "psnr": metrics["psnr"].tolist(),
                       "n_alive": metrics["n_alive"].tolist(),
                       "elapsed_s": time.time() - t0}
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                if not quiet:
                    print(f"[it {it}] loss {np.mean(loss):.4f} "
                          f"psnr {np.mean(rec['psnr']):.2f}", flush=True)

    for p, scene in enumerate(scenes):
        out = os.path.join(scene.model_path, "point_cloud",
                           f"iteration_{opt.iterations}")
        os.makedirs(out, exist_ok=True)
        save_ply(_plot(states, p), os.path.join(out, "point_cloud.ply"))
    return scenes, states


def main(argv=None):
    parser = ArgumentParser(
        description="wheat3dgs_tpu_torch multi-plot training")
    cfg.add_params(parser, cfg.OptimizationParams)
    parser.add_argument("--source_base", type=str, default=None,
                        help="directory containing plot_* scene folders")
    parser.add_argument("--source_paths", nargs="*", default=None)
    parser.add_argument("--model_base", type=str, required=True)
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--resolution", "-r", type=int, default=1)
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--views_per_step", type=int, default=1)
    parser.add_argument("--max_per_tile", type=int, default=512,
                        help="JAX's XLA-backend knob; accepted and unused")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(0)

    if args.source_paths:
        sources = args.source_paths
    else:
        sources = sorted(
            os.path.join(args.source_base, d)
            for d in os.listdir(args.source_base) if d.startswith("plot_"))
    if not sources:
        raise ValueError("no plot_* scene folders found")
    opt = cfg.extract(cfg.OptimizationParams, args)
    model_tpl = cfg.ModelParams(resolution=args.resolution,
                                white_background=args.white_background)
    return training(sources, args.model_base, opt, model_tpl,
                    sh_degree=args.sh_degree,
                    views_per_step=args.views_per_step, quiet=args.quiet,
                    device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
