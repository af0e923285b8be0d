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

Over several processes, each is one rank of a torch.distributed group
given in full: `--dist_backend gloo|nccl --dist_init <address>
--world_size N --rank r` (nothing is read from the environment). The
(plot, view) mesh is factored over the N ranks by JAX's rule and must use
all of them; a rank trains its plot group's plots on its share of each
step's views (parallel.mesh.build_multi_plot_trainer: the gradients
all-reduced over the view group before Adam). Over NCCL that step, its
collectives included, is replayed from a CUDA graph as the one-process
step is; over gloo it runs eagerly (gloo's collectives on CUDA tensors
are staged through the host). The capacity's MAX and the log's gather
read the host, between steps. Every rank draws every
plot's view picks and split noise, so its plots see what they would in
one process; the capacity doubling is decided over all plots (a MAX over
the ranks). Rank 0 writes metrics_multi.jsonl (every plot's numbers,
gathered), and the first rank of each view group writes its plots'
cfg_args and PLYs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from argparse import ArgumentParser
from typing import Optional

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
               sh_degree: int, device, write: bool = True):
    """Each plot's Scene (its model dir and cfg_args written when
    `write`); the caller equalises their capacities."""
    scenes = []
    for sp in source_paths:
        name = os.path.basename(os.path.normpath(sp))
        model = dataclasses.replace(
            model_tpl, source_path=sp,
            model_path=os.path.join(model_base, name))
        if write:
            os.makedirs(model.model_path, exist_ok=True)
            cfg.save_cfg_args(model.model_path, model)
        scenes.append(Scene(dataclasses.replace(
            model, model_path=model.model_path if write else ""),
            sh_degree=sh_degree, device=device))
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
             device="cuda", ranks: Optional[M.Ranks] = None):
    """Train the plots together; returns (scenes, stacked final states):
    all plots over one device, this rank's plots over `ranks`."""
    dev = resolve_device(device) if ranks is None else ranks.device
    n_plots = len(source_paths)
    if ranks is None:
        devices = [dev]
        n_plot_dev, n_view_dev = mesh_factors(n_plots, views_per_step, 1)
    else:
        n_plot_dev, n_view_dev = mesh_factors(n_plots, views_per_step,
                                              ranks.world_size)
        if n_plot_dev * n_view_dev != ranks.world_size:
            raise ValueError(
                f"{n_plots} plots x {views_per_step} views a step use a "
                f"{n_plot_dev}x{n_view_dev} mesh, not {ranks.world_size} "
                "ranks")
    mesh = M.make_mesh(n_plots=n_plot_dev, n_views=n_view_dev,
                       devices=None if ranks else devices, ranks=ranks)
    lead = mesh.index("view") == 0          # writes its plots' files
    share = views_per_step // n_view_dev
    my_views = slice(mesh.index("view") * share,
                     (mesh.index("view") + 1) * share)
    mine = list(range(n_plots))
    if ranks is not None:
        per = n_plots // n_plot_dev
        mine = mine[mesh.index("plot") * per:][:per]
    scenes = load_plots([source_paths[p] for p in mine], model_base,
                        model_tpl, sh_degree, dev, write=lead)
    # Every plot's capacity, so the stacks match one process's.
    cap = max(s.gaussians.capacity for s in scenes)
    if ranks is not None:
        cap = _all_max(mesh, [cap])[0]
    for s in scenes:
        if s.gaussians.capacity < cap:
            s.gaussians = G.grow_capacity(s.gaussians, cap)
    w, h = scenes[0].image_size
    for s in scenes:
        if s.image_size != (w, h):
            raise ValueError("plots must share a resolution")
    if not quiet:
        print(f"mesh: {mesh.shape} over {mesh.devices.size} devices; "
              f"{n_plots} plots x {views_per_step} views/step @{w}x{h}")

    # Over one device, JAX's shardings are placements on it: the tensors
    # below are made there. Over ranks, each holds its plots (this rank's
    # share of the views is cut from each step's picks).
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
    plot_rows = torch.arange(len(mine), device=dev)[:, None]
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    step = step_sh = None
    rng = np.random.default_rng(seed)
    active_sh = 0
    t0 = time.time()
    log_f = (open(os.path.join(model_base, "metrics_multi.jsonl"), "a")
             if ranks is None or ranks.rank == 0 else None)
    for it in range(1, opt.iterations + 1):
        if it % 1000 == 0 and active_sh < sh_degree:
            active_sh += 1
        if step is None or step_sh != active_sh:
            step_sh = active_sh
            step = (multi_plot_step(active_sh, w, h, opt, config)
                    if ranks is None else M.build_multi_plot_trainer(
                        mesh, active_sh, w, h, opt, config))
        # Every plot's picks (the draws of one process); this rank's plots
        # and its share of their views.
        vi = rng.integers(n_views, size=(n_plots, views_per_step))[mine]
        vsel = to_device(vi[:, my_views], dev)
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
                for p in range(n_plots):
                    if p not in mine:   # its split noise, drawn and unused
                        torch.randn((2, states.alive.shape[1], 3),
                                    generator=generator, device=dev)
                        continue
                    k = mine.index(p)
                    st, info = G.densify_and_prune(
                        _plot(states, k), opt.densify_grad_threshold,
                        0.005, extents[k], max_screen, opt.percent_dense,
                        generator=generator)
                    plots.append(st)
                    infos.append(info)
                states = M.stack_states(plots)
                top = [max(int(i["n_dropped"]) for i in infos),
                       max(int(i["n_alive"]) for i in infos)]
                if ranks is not None:
                    top = _all_max(mesh, top)
                if top[0] > 0 or top[1] > 0.9 * states.alive.shape[1]:
                    states = _pad_cap(states)
            if it % opt.opacity_reset_interval == 0 and it > 0:
                states = G.reset_opacity(states)

        if it % log_every == 0 or it == opt.iterations:
            cols = {k: metrics[k] for k in ("loss", "psnr", "n_alive")}
            if ranks is not None:
                cols = {k: _gather_plots(mesh, v) for k, v in cols.items()}
            if log_f is not None:
                loss = cols["loss"].tolist()
                rec = {"iter": it, "loss": loss,
                       "psnr": cols["psnr"].tolist(),
                       "n_alive": cols["n_alive"].tolist(),
                       "elapsed_s": time.time() - t0}
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                if not quiet:
                    print(f"[it {it}] loss {np.mean(loss):.4f} "
                          f"psnr {np.mean(rec['psnr']):.2f}", flush=True)
    if log_f is not None:
        log_f.close()

    if lead:
        for k, scene in enumerate(scenes):
            out = os.path.join(scene.model_path, "point_cloud",
                               f"iteration_{opt.iterations}")
            os.makedirs(out, exist_ok=True)
            save_ply(_plot(states, k), os.path.join(out, "point_cloud.ply"))
    return scenes, states


def _all_max(mesh: M.Mesh, values: list) -> list:
    """Each value's maximum over every rank of the mesh."""
    t = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    for axis in mesh.axis_names:
        mesh.collectives(axis).all_reduce_(t, torch.distributed.ReduceOp.MAX)
    return [int(v) for v in t.tolist()]


def _gather_plots(mesh: M.Mesh, col: torch.Tensor) -> torch.Tensor:
    """A (P / n_plots,) metric column of this rank's plots -> every plot's
    (P,) column, in plot order, on every rank."""
    return mesh.collectives("plot").all_gather(col.to(mesh.device))


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
                        help="torch device (default cuda; cpu on request); "
                        "a gloo rank's device, or NCCL's cuda:<rank>")
    parser.add_argument("--dist_backend", choices=M.BACKENDS, default=None,
                        help="run as one rank of a process group: gloo or "
                        "nccl, with --dist_init, --world_size and --rank")
    parser.add_argument("--dist_init", type=str, default=None,
                        help="the group's init address, e.g. "
                        "tcp://localhost:29500 or file:///tmp/init")
    parser.add_argument("--world_size", type=int, default=None)
    parser.add_argument("--rank", type=int, default=None)
    args = parser.parse_args(argv)
    dist_args = (args.dist_backend, args.dist_init, args.world_size,
                 args.rank)
    ranks = None
    if any(a is not None for a in dist_args):
        if any(a is None for a in dist_args):
            parser.error("--dist_backend, --dist_init, --world_size and "
                         "--rank go together")
        ranks = M.init_ranks(args.dist_backend, args.dist_init,
                             args.world_size, args.rank,
                             device=(args.device if args.dist_backend
                                     == "gloo" else None))
        device = ranks.device
    else:
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
    try:
        return training(sources, args.model_base, opt, model_tpl,
                        sh_degree=args.sh_degree,
                        views_per_step=args.views_per_step,
                        quiet=args.quiet or (ranks is not None
                                             and ranks.rank > 0),
                        device=device, ranks=ranks)
    finally:
        if ranks is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
