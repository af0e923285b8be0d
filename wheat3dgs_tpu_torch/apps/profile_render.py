"""Where a render_fwd call spends its time on the card.

    python -m wheat3dgs_tpu_torch.apps.profile_render [--width 1600]
        [--height 1200] [--renders 30] [--out output/profile_render]

Builds the bench plot (the port's synthetic generator, seed 0: 200,000
splats, 12 views) and its SH-3 stand-in model in a work directory under
--out, then on train view 0 at the split's adapted entry budget:
- times each stage of render_fwd with CUDA events (projection, allocation
  prologue, decode_cull, key sort + tile bounds, feature table,
  composite_fwd, background), each over --renders repetitions;
- times whole render_fwd calls on the host clock (ends in a synchronize);
- traces --renders render_fwd calls with torch.profiler and reports the
  device time by kernel and the device's busy share of the wall time.
Prints one JSON line and writes the profiler table to --out. Needs a card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from argparse import ArgumentParser

import torch


def _stage_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--renders", type=int, default=30)
    ap.add_argument("--out", default=os.path.join("output",
                                                  "profile_render"))
    args = ap.parse_args(argv)

    from .. import config as cfg
    from .. import resolve_device
    from ..io.synthetic import (make_synthetic_colmap_scene,
                                write_stand_in_model)
    from ..ops import cuda_build
    from ..ops import cuda_raster as CR
    from ..ops.projection import project_gaussians
    from ..render.pipeline import adapt_config, render_fwd
    from ..scene import Scene

    dev = resolve_device("cuda")
    cuda_build.build()
    work = os.path.join(args.out, "work")
    shutil.rmtree(work, ignore_errors=True)
    bench = dict(n_heads=32, pts_per_head=3000, ground_pts=104_000, seed=0)
    make_synthetic_colmap_scene(os.path.join(work, "scene"),
                                width=args.width, height=args.height,
                                with_masks=False, device=dev, **bench)
    n = write_stand_in_model(os.path.join(work, "model"),
                             os.path.join(work, "scene"), device=dev, **bench)
    scene = Scene(cfg.ModelParams(source_path=os.path.join(work, "scene"),
                                  model_path=os.path.join(work, "model")),
                  load_iteration=-1, device=dev)
    st, w, h, deg = scene.gaussians, args.width, args.height, scene.sh_degree
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    config = adapt_config(st, cams[0], w, h, cams=cams)
    bg = torch.zeros(3, device=dev)
    reps = args.renders

    # Stage by stage, as rasterize_fwd runs them.
    def project():
        return project_gaussians(
            st.params.means, st.scales(), st.params.quats, st.opacity(),
            *cams[0], w, h, sh=st.sh(), sh_degree=deg)

    splats = project()
    plan = CR.alloc_prologue(splats, w, h, config.entry_budget)
    key, _ = CR.decode_cull(plan)
    skeys, starts, ends = CR.sorted_stream(key, plan.t_total, plan.rank_bits)
    feat = CR.entry_features(splats, plan.order, True, True)
    img = CR.composite_fwd(skeys, starts, ends, feat, plan.rank_bits, w, h)
    stages = {
        "project": _stage_ms(project, reps),
        "alloc_prologue": _stage_ms(lambda: CR.alloc_prologue(
            splats, w, h, config.entry_budget), reps),
        "decode_cull": _stage_ms(lambda: CR.decode_cull(plan), reps),
        "sort_and_bounds": _stage_ms(lambda: CR.sorted_stream(
            key, plan.t_total, plan.rank_bits), reps),
        "entry_features": _stage_ms(lambda: CR.entry_features(
            splats, plan.order, True, True), reps),
        "composite_fwd": _stage_ms(lambda: CR.composite_fwd(
            skeys, starts, ends, feat, plan.rank_bits, w, h), reps),
        "background": _stage_ms(lambda: img[2:5] + (1.0 - img[0])[None]
                                * bg[:, None, None], reps),
    }

    def one():
        return render_fwd(st, *cams[0], w, h, sh_degree=deg, bg=bg,
                          config=config)

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) / reps * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        f.write(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    shutil.rmtree(work, ignore_errors=True)
    print(table)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "splats": n,
        "width": w, "height": h, "entry_budget": config.entry_budget,
        "render_ms_host": render_ms, "stage_ms": stages,
        "profiled_renders": reps,
        "device_busy_share": device_us / wall_us if wall_us else None,
        "top_device_us_per_render": {
            e.key: e.self_device_time_total / reps for e in top}}))


if __name__ == "__main__":
    main(sys.argv[1:])
