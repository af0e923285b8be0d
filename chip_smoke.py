#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wheat3dgs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero when either is missing, and
when run outside a checkout of the repo. Phases, each reported on a line:

1. device: the card's name and power limit (nvidia-smi);
2. build: the four CUDA sources of the five kernels from csrc/, compiled
   in parallel;
3. data: the bench's synthetic plot (32 heads x 3000 + 104,000 ground =
   200,000 splats, 12 ring views at 1600x1200 -> 10 train / 2 test) made
   with the port's generator from seed 0, and a "trained" SH-degree-3
   model PLY made from its ground truth (seeded f_rest and per-axis scale
   jitter);
4. kernels: the serving kernels against their plain PyTorch versions on
   one full-width view (decode_cull keys and alive count exactly equal;
   composite_fwd within the stated tolerance), both timed with CUDA events;
5. serving path: `apps/render_sets.main` over both splits with the launch
   counters reset just before and read just after, the PNG trees checked,
   every view's entries_total checked against its budget, one view checked
   against the plain compositor, and the steady render_fwd FPS;
6. train kernels: the training kernels against their plain versions on
   train view 0 of the stand-in model under the L1 + SSIM loss against
   that view's image (composite_train_fwd, composite_bwd, segsum within
   the stated bounds), the end-to-end parameter gradients of the kernel
   path against the all-plain path (within 2% of each leaf's max |g|),
   each kernel, its plain version and, for segsum, torch.segment_reduce
   timed with CUDA events;
7. training path: `apps/train_vanilla.main` on the bench scene (100,000
   initial points from points3D, SH 3, bench.py's densify schedule) with
   the launch counters reset just before and read just after: finite
   logged losses, a densify event, the entry-budget watchdog, the test
   PSNR rise, and the saved PLY rendered through `apps/render_sets`;
8. steady training rate: TRAIN_TIMED Trainer.step calls at SH degree 3
   with no densify event inside, on the host clock;
9. segmentation kernels, on train view 0 of the stand-in model: the lift's
   kernels at 9 value rows (depth + 8 label channels: composite_train_fwd,
   composite_bwd, segsum) against their plain versions and its (8, N)
   counts against the all-plain path; composite_fwd alpha-only (0 value
   rows) at a subset budget and with depth (1 value row), all timed;
10. segmentation path: `apps/run_3d_seg_app.main` on the bench scene and
   the stand-in model with the launch counters reset just before and read
   just after: the artifact tree, the head ids in the 2DSeg maps, the
   subset-budget ladder, seconds and calls per lift / match / predbits, the
   device's busy share over association steps, and the heads scored
   against the generator's ground truth (gt_points.npz);
11. evaluation path: `apps/eval_wheatgs_app.main` on the same model
   (all_counts.pt and the test split's segmentation / overlay PNGs);
12. the scan probe: each kind of the kernel against its plain version on
   the probe's input and a seeded normal block, timed beside a
   torch.cumsum loop, then `apps/prof_scan.main` with the counters reset;
13. a `kernels` JSON line, then the device line last.
Work files go to `_smoke_work/` in the checkout and are removed on success.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_work")

# H100 SXM published peaks (NVIDIA data sheet), used for the bound column.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# composite_fwd against its plain version: the kernel sums each pixel's
# weights sequentially with FMA contraction, the plain version per 128-entry
# chunk through a cumsum, so float32 sums differ in order only.
COMPOSITE_ATOL = 1e-4
COMPOSITE_RTOL = 1e-4

# composite_train_fwd: the image as composite_fwd's. Its stop is equal on
# every pixel but those whose transmittance lands within rounding of the
# 1e-4 floor (the kernel's sequential log-T sum against a cumsum); those
# are counted and printed, and held under STOP_MISMATCH_MAX of the pixels.
STOP_MISMATCH_MAX = 1e-3
# composite_bwd: each entry row's sums over up to 1024 pixels run in
# another order (a shuffle tree against a tensor-axis sum); the error is
# held against each column's max |value|.
BWD_REL = 1e-3
# segsum: float32 sums in a shuffle tree against a float64 running sum.
SEGSUM_REL = 1e-5
# End-to-end parameter gradients, kernel path against all-plain path, as
# tests/test_pallas.py holds the TPU backward to XLA autodiff.
GRAD_REL = 0.02
# The segmentation lift's (8, N) counts, kernel path against the all-plain
# path, against each row's max (float32 sums in another order).
LIFT_REL = 1e-3
# The scan probe against its plain version, against the block's max |value|
# (sums in another order, renormalised every step).
PROBE_REL = 1e-5
# Gross-failure gates of the segmentation path on the 32-head bench plot
# (the CPU parity tests hold the algorithm to the JAX package's).
SEG_HEADS = (8, 96)
SEG_MEDIAN_PURITY = 0.5
# The test-split PSNR after TRAIN_ITERS iterations must beat the one after
# the first iteration by this many dB (the first run on an H100 rose
# 7.35 dB, 17.32 -> 24.67).
PSNR_RISE_DB = 3.0

BENCH = dict(width=1600, height=1200, n_cams=12, n_heads=32,
             pts_per_head=3000, ground_pts=104_000, seed=0)
ITERATION = 30_000
FPS_RENDERS = 30
TRAIN_ITERS = 300
TRAIN_TIMED = 30
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(phase + ": " + json.dumps(kv), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi rc {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_data(scene_dir: str, model_dir: str) -> int:
    """The bench plot and its SH-3 stand-in model; returns the splat count."""
    from wheat3dgs_tpu_torch.io.synthetic import (make_synthetic_colmap_scene,
                                                  write_stand_in_model)

    make_synthetic_colmap_scene(scene_dir, device=DEVICE, **BENCH)
    return write_stand_in_model(
        model_dir, scene_dir, BENCH["n_heads"], BENCH["pts_per_head"],
        BENCH["ground_pts"], BENCH["seed"], ITERATION, device=DEVICE)


def check_kernels(scene):
    """Phase 4: each kernel against its plain version on train view 0."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config

    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    budget = adapt_config(st, cams[0], w, h, cams=cams).entry_budget
    splats = project_gaussians(
        st.params.means, st.scales(), st.params.quats, st.opacity(),
        *cams[0], w, h, sh=st.sh(), sh_degree=scene.sh_degree)
    plan = CR.alloc_prologue(splats, w, h, budget)
    key_k, alive_k = CR.decode_cull(plan)
    key_p, alive_p = CR.decode_cull_plain(plan)
    torch.cuda.synchronize()
    if not torch.equal(key_k, key_p) or int(alive_k) != int(alive_p):
        bad = int((key_k != key_p).sum())
        fail(f"decode_cull differs from its plain version: {bad} keys, "
             f"alive {int(alive_k)} vs {int(alive_p)}")
    e, n = plan.owner.shape[0], plan.geo_r.shape[0]
    dec = dict(
        ms=cuda_time_ms(lambda: CR.decode_cull(plan), 50),
        plain_ms=cuda_time_ms(lambda: CR.decode_cull_plain(plan), 10),
        max_abs_err=0,
        shape={"slots": e, "splats": n, "alive": int(alive_k),
               "total": int(plan.total)})
    # Owner read + key write per slot; per-rank meta, total, alive once.
    dec["bound_ms"], dec["bound_by"] = bound(
        e * (4 + 8) + n * (16 + 24) + 8, e * 60)

    skeys, starts, ends = CR.sorted_stream(key_k, plan.t_total,
                                           plan.rank_bits)
    feat_r = CR.entry_features(splats, plan.order, True, True)
    cargs = (skeys, starts, ends, feat_r, plan.rank_bits, w, h)
    img_k = CR.composite_fwd(*cargs)
    img_p, (visited, weighted) = CR.composite_fwd_plain(*cargs,
                                                        with_counts=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(img_k).all()):
        fail("composite_fwd produced non-finite values")
    err = (img_k - img_p).abs()
    lim = COMPOSITE_ATOL + COMPOSITE_RTOL * img_p.abs()
    if not bool((err <= lim).all()):
        fail(f"composite_fwd differs from its plain version: max abs err "
             f"{float(err.max())} (atol {COMPOSITE_ATOL}, rtol "
             f"{COMPOSITE_RTOL})")
    nv = feat_r.shape[1] - 6
    comp = dict(
        ms=cuda_time_ms(lambda: CR.composite_fwd(*cargs), 20),
        plain_ms=cuda_time_ms(lambda: CR.composite_fwd_plain(*cargs), 2,
                              warmup=1),
        max_abs_err=float(err.max()),
        tolerance={"atol": COMPOSITE_ATOL, "rtol": COMPOSITE_RTOL},
        shape={"tiles": plan.t_total, "entries": int(alive_k),
               "value_rows": nv, "visited_pairs": visited,
               "weighted_pairs": weighted})
    # Keys of the live segments, tile bounds, the feature table and the
    # image; 14 flops per visited (pixel, entry) pair, 4 + 2 (1 + nv) more
    # per weighted pair (transcendentals counted as one).
    comp["bound_ms"], comp["bound_by"] = bound(
        int(alive_k) * 8 + plan.t_total * 8 + feat_r.numel() * 4
        + (1 + nv) * w * h * 4,
        visited * 14 + weighted * (4 + 2 * (1 + nv)))
    return dec, comp


def main_path(model_dir: str, scene) -> dict:
    """Phase 5: render_sets over both splits through the user entry point,
    with the launch counters read around exactly that call."""
    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch.apps import render_sets
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config, render_fwd

    CR.reset_launches()
    t0 = time.perf_counter()
    render_sets.main(["-m", model_dir, "--device", DEVICE, "--quiet"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(CR.launches)
    for k in ("decode_cull", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serving path")

    w, h = scene.image_size
    bg = torch.zeros(3, device=DEVICE)
    views = []
    for split in ("train", "test"):
        n = len(getattr(scene.data, split))
        base = os.path.join(model_dir, split, f"ours_{ITERATION}")
        cams = [scene.cam_arrays(split, i) for i in range(n)]
        config = adapt_config(scene.gaussians, cams[0], w, h, cams=cams)
        for i in range(n):
            for sub in ("renders", "gt"):
                path = os.path.join(base, sub, f"{i:05d}.png")
                if not os.path.exists(path):
                    fail(f"missing {path}")
            png = np.asarray(Image.open(
                os.path.join(base, "renders", f"{i:05d}.png")))
            if png.shape != (h, w, 3) or png.std() < 1.0:
                fail(f"{split} view {i}: blank or misshapen render "
                     f"{png.shape}")
            out = render_fwd(scene.gaussians, *cams[i], w, h,
                             sh_degree=scene.sh_degree, bg=bg,
                             config=config)
            total, alive = int(out.entries_total), int(out.entries_alive)
            if not bool(torch.isfinite(out.color).all()):
                fail(f"{split} view {i}: non-finite colour")
            if total > config.entry_budget:
                fail(f"{split} view {i}: demand {total} over budget "
                     f"{config.entry_budget}")
            views.append((split, i, total, alive, config.entry_budget, png))
    expected = (len(scene.data.train), len(scene.data.test))
    if expected != (10, 2):
        fail(f"split is {expected}, expected (10, 2)")

    # One view against the plain compositor, at the PNGs' 8-bit precision.
    split, i, *_ = views[0]
    png = views[0][-1].astype(np.int32)
    plain = render_fwd_plain(scene, split, i, views[0][4])
    ref = (np.clip(plain, 0, 1).transpose(1, 2, 0) * 255).astype(np.int32)
    off = np.abs(png - ref) > 1
    if off.mean() > 1e-3:
        fail(f"main-path PNG differs from the plain render on "
             f"{off.mean():.2%} of pixel channels")

    # Steady-state FPS over the train views at their adapted budget.
    cams = [scene.cam_arrays("train", i) for i in range(len(scene.data.train))]
    config = adapt_config(scene.gaussians, cams[0], w, h, cams=cams)

    def one(i):
        return render_fwd(scene.gaussians, *cams[i % len(cams)], w, h,
                          sh_degree=scene.sh_degree, bg=bg, config=config)

    for i in range(3):
        one(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FPS_RENDERS):
        one(i)
    torch.cuda.synchronize()
    fps = FPS_RENDERS / (time.perf_counter() - t0)
    return dict(seconds=seconds, launches=launches, fps=fps,
                views=[v[:5] for v in views],
                plain_check_pixels_off=float(off.mean()))


def render_fwd_plain(scene, split: str, i: int, budget: int):
    """View `i`'s colour (background 0) through both kernels' plain
    versions instead of the kernels."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians

    st = scene.gaussians
    w, h = scene.image_size
    splats = project_gaussians(
        st.params.means, st.scales(), st.params.quats, st.opacity(),
        *scene.cam_arrays(split, i), w, h, sh=st.sh(),
        sh_degree=scene.sh_degree)
    plan = CR.alloc_prologue(splats, w, h, budget)
    key, _ = CR.decode_cull_plain(plan)
    skeys, starts, ends = CR.sorted_stream(key, plan.t_total, plan.rank_bits)
    feat_r = CR.entry_features(splats, plan.order, True, True)
    img = CR.composite_fwd_plain(skeys, starts, ends, feat_r, plan.rank_bits,
                                 w, h)
    return img[2:5].cpu().numpy()       # rows: weight sum, depth, rgb


def timed_once(fn):
    """(fn(), its time in ms) with CUDA events, for the plain versions,
    which are too slow to repeat at full width."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


@contextlib.contextmanager
def plain_kernels():
    """Route the rasterizer's kernel calls to their plain versions on the
    card's tensors for the duration (the all-plain reference path)."""
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    names = ("decode_cull", "composite_train_fwd", "composite_bwd", "segsum")
    saved = {k: getattr(CR, k) for k in names}
    try:
        for k in names:
            setattr(CR, k, getattr(CR, k + "_plain"))
        yield
    finally:
        for k, fn in saved.items():
            setattr(CR, k, fn)


def check_train_kernels(scene):
    """Phase 6: the training kernels against their plain versions on train
    view 0 of the stand-in model, under the L1 + SSIM loss."""
    import dataclasses

    import torch

    from wheat3dgs_tpu_torch.models.gaussians import GaussianParams
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.binning import pick_entry_budget
    from wheat3dgs_tpu_torch.ops.losses import photometric_loss
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians
    from wheat3dgs_tpu_torch.render.pipeline import (RasterConfig,
                                                     entry_demand_probe,
                                                     render)

    st = scene.gaussians
    w, h = scene.image_size
    cam = scene.cam_arrays("train", 0)
    gt = scene.gt_image("train", 0)
    bg = torch.zeros(3, device=DEVICE)
    # The entry budget the trainer's ladder picks for this view.
    budget = pick_entry_budget(int(entry_demand_probe(
        st, *cam, width=w, height=h)))
    with torch.no_grad():
        splats = project_gaussians(
            st.params.means, st.scales(), st.params.quats, st.opacity(),
            *cam, w, h, sh=st.sh(), sh_degree=scene.sh_degree)
        plan = CR.alloc_prologue(splats, w, h, budget)
        key, alive = CR.decode_cull(plan)
        skeys, starts, ends, perm = CR.sorted_stream(
            key, plan.t_total, plan.rank_bits, with_perm=True)
        feat = CR.entry_features(splats, plan.order, True, True)
    nv = feat.shape[1] - 6
    cols = 6 + nv
    e, n = skeys.shape[0], feat.shape[0]
    entries = int(alive)

    # composite_train_fwd
    fargs = (skeys, starts, ends, feat, plan.rank_bits, w, h)
    img_k, stop_k = CR.composite_train_fwd(*fargs)
    (img_p, stop_p), fwd_plain_ms = timed_once(
        lambda: CR.composite_train_fwd_plain(*fargs))
    if not bool(torch.isfinite(img_k).all()):
        fail("composite_train_fwd produced non-finite values")
    err = (img_k - img_p).abs()
    if not bool((err <= COMPOSITE_ATOL + COMPOSITE_RTOL * img_p.abs()).all()):
        fail(f"composite_train_fwd differs from its plain version: max abs "
             f"err {float(err.max())}")
    if not torch.equal(img_k, CR.composite_fwd(*fargs)):
        fail("composite_train_fwd's image differs from composite_fwd's")
    stop_off = int((stop_k != stop_p).sum())
    if stop_off > STOP_MISMATCH_MAX * w * h:
        fail(f"composite_train_fwd stop differs on {stop_off} pixels")
    _, (visited, weighted) = CR.composite_fwd_plain(*fargs, with_counts=True)
    fwd = dict(
        ms=cuda_time_ms(lambda: CR.composite_train_fwd(*fargs), 20),
        plain_ms=fwd_plain_ms, max_abs_err=float(err.max()),
        stop_pixels_differing=stop_off,
        tolerance={"atol": COMPOSITE_ATOL, "rtol": COMPOSITE_RTOL},
        shape={"tiles": plan.t_total, "entries": entries, "value_rows": nv,
               "visited_pairs": visited, "weighted_pairs": weighted})
    fwd["bound_ms"], fwd["bound_by"] = bound(
        entries * 8 + plan.t_total * 8 + feat.numel() * 4
        + ((1 + nv) * 4 + 4) * w * h,
        visited * 14 + weighted * (4 + 2 * (1 + nv)))

    # The image's cotangent under the training loss.
    img_v = img_k.detach().requires_grad_(True)
    color = img_v[2:5] + (1.0 - img_v[0])[None] * bg[:, None, None]
    grad = torch.autograd.grad(photometric_loss(color, gt),
                               img_v)[0].contiguous()

    # composite_bwd
    bargs = (skeys, perm, starts, ends, feat, img_k, stop_k, grad,
             plan.rank_bits, w, h)
    rows_k = CR.composite_bwd(*bargs)
    rows_p, bwd_plain_ms = timed_once(lambda: CR.composite_bwd_plain(*bargs))
    if not bool(torch.isfinite(rows_k).all()):
        fail("composite_bwd produced non-finite values")
    col_max = rows_p.abs().amax(dim=0).clamp(min=1e-30)
    bwd_rel = float(((rows_k - rows_p).abs() / col_max).max())
    if bwd_rel > BWD_REL:
        fail(f"composite_bwd differs from its plain version: {bwd_rel} of "
             f"the column max (bound {BWD_REL})")
    # Pairs the replay walks: every pixel up to its stop.
    tiles_x = plan.tiles_x
    ty = torch.arange(h, device=DEVICE)[:, None] // CR.TILE_PX
    tx = torch.arange(w, device=DEVICE)[None, :] // CR.TILE_PX
    bwd_visited = int((stop_k.long() - starts[ty * tiles_x + tx]).sum())
    bwd = dict(
        ms=cuda_time_ms(lambda: CR.composite_bwd(*bargs), 20),
        plain_ms=bwd_plain_ms,
        max_abs_err=float((rows_k - rows_p).abs().max()),
        max_rel_err_of_column_max=bwd_rel, bound_rel=BWD_REL,
        shape={"slots": e, "entries": entries, "columns": cols,
               "visited_pairs": bwd_visited, "weighted_pairs": weighted})
    # Keys + permutation of the live entries, the feature table, image,
    # cotangent and stop per pixel, the (E, cols) row write; the forward's
    # replay per visited pair, ~36 + 4 nv ops per weighted pair (u, the
    # prefix, dα and the 6 + nv columns and their reduction).
    bwd["bound_ms"], bwd["bound_by"] = bound(
        entries * 16 + plan.t_total * 8 + feat.numel() * 4
        + (2 * (1 + nv) * 4 + 4) * w * h + e * cols * 4,
        bwd_visited * 14 + weighted * (36 + 4 * nv))

    # segsum
    sargs = (rows_k, plan.seg_start, plan.seg_end)
    out_k = CR.segsum(*sargs)
    out_p, seg_plain_ms = timed_once(lambda: CR.segsum_plain(*sargs))
    scale = out_p.abs().amax(dim=0).clamp(min=1e-30)
    seg_rel = float(((out_k - out_p).abs() / scale).max())
    if seg_rel > SEGSUM_REL:
        fail(f"segsum differs from its plain version: {seg_rel} of the "
             f"column max (bound {SEGSUM_REL})")
    used = int(plan.seg_end[-1])
    offsets = torch.cat([plan.seg_start, plan.seg_end[-1:]]).long()
    lib_out = torch.segment_reduce(rows_k[:used], "sum", offsets=offsets)
    lib_rel = float(((lib_out - out_p).abs() / scale).max())
    seg = dict(
        ms=cuda_time_ms(lambda: CR.segsum(*sargs), 50),
        plain_ms=seg_plain_ms,
        library_ms=cuda_time_ms(lambda: torch.segment_reduce(
            rows_k[:used], "sum", offsets=offsets), 50),
        library_rel_err=lib_rel,
        max_abs_err=float((out_k - out_p).abs().max()),
        max_rel_err_of_column_max=seg_rel, bound_rel=SEGSUM_REL,
        shape={"slots_summed": used, "ranks": n, "columns": cols})
    seg["bound_ms"], seg["bound_by"] = bound(
        used * cols * 4 + n * 8 + n * cols * 4, used * cols)

    # End-to-end parameter gradients: kernels against the all-plain path.
    def leaf_grads():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in st.params.as_dict().items()}
        view = dataclasses.replace(st, params=GaussianParams(**leaves))
        out = render(view, *cam, w, h, scene.sh_degree, bg=bg,
                     config=RasterConfig(entry_budget=budget))
        return torch.autograd.grad(photometric_loss(out.color, gt),
                                   list(leaves.values()))

    names = list(st.params.as_dict())
    got = leaf_grads()
    with plain_kernels():
        ref = leaf_grads()
    grad_rel = {}
    for k, a, b in zip(names, got, ref):
        top = float(b.abs().max())
        grad_rel[k] = float((a - b).abs().max()) / top if top > 0 else 0.0
        if not bool(torch.isfinite(a).all()) or grad_rel[k] > GRAD_REL:
            fail(f"end-to-end gradient of {k}: {grad_rel[k]} of its max "
                 f"(bound {GRAD_REL})")
    return fwd, bwd, seg, {"budget": budget, "grad_rel_of_max": grad_rel}


def train_path(scene_dir: str, out_dir: str):
    """Phase 7: apps/train_vanilla over the bench scene, with the launch
    counters read around exactly that call."""
    import math

    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch import training
    from wheat3dgs_tpu_torch.apps import render_sets, train_vanilla
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    # Record each step's demand and budget (tensors; read after the run so
    # the record adds no host sync).
    record = []
    step = training.Trainer.step

    def recording_step(self, it, *args):
        m = step(self, it, *args)
        record.append((it, m["entries_total"], self.config.entry_budget,
                       m["loss"]))
        return m

    n_iter = TRAIN_ITERS
    argv = ["-s", scene_dir, "-m", out_dir, "--device", DEVICE, "--eval",
            "--iterations", str(n_iter), "--densify_from_iter", "20",
            "--densification_interval", "40",
            "--densify_until_iter", str(n_iter - 100),
            "--opacity_reset_interval", "100000",
            "--test_iterations", "1", str(n_iter),
            "--save_iterations", str(n_iter), "--quiet"]
    training.Trainer.step = recording_step
    try:
        CR.reset_launches()
        t0 = time.perf_counter()
        trainer, scene = train_vanilla.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
    finally:
        training.Trainer.step = step
    for k in ("decode_cull", "composite_train_fwd", "composite_bwd",
              "segsum", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the training path")

    n_init = len(scene.data.point_cloud.points)
    logs = [json.loads(ln) for ln in open(os.path.join(out_dir,
                                                       "metrics.jsonl"))]
    steps = [r for r in logs if "loss" in r]
    tests = [r for r in logs if "test_psnr" in r]
    if not steps or not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"non-finite or missing logged loss: {steps}")
    losses = [float(x[3]) for x in record]
    if not all(math.isfinite(x) for x in losses):
        fail("a training step's loss is not finite")
    if not any(r["n_alive"] != n_init for r in steps):
        fail(f"no densify event changed n_alive from {n_init}")
    # Every step whose demand exceeded its budget must see the watchdog
    # raise the budget within 2 checks, unless the run ended first.
    k = trainer.overflow_check_every
    demand = [(it, int(t), b) for it, t, b, _ in record]
    budget_at = {it: b for it, _, b in demand}
    over = [(it, t, b) for it, t, b in demand if t > b]
    for it, t, b in over:
        later = [budget_at[j] for j in range(it + 1, it + 2 * k + 2)
                 if j in budget_at]
        if len(later) == 2 * k + 1 and max(later) <= b:
            fail(f"step {it}: demand {t} over budget {b} and the watchdog "
                 "did not raise it")
    if [r["iter"] for r in tests] != [1, n_iter]:
        fail(f"test evaluations at {[r['iter'] for r in tests]}")
    rise = tests[-1]["test_psnr"] - tests[0]["test_psnr"]
    if not rise > PSNR_RISE_DB:
        fail(f"test PSNR rose {rise:.3f} dB (< {PSNR_RISE_DB})")
    ply = os.path.join(out_dir, "point_cloud", f"iteration_{n_iter}",
                       "point_cloud.ply")
    if not os.path.exists(ply):
        fail(f"missing {ply}")
    render_sets.main(["-m", out_dir, "--device", DEVICE, "--quiet",
                      "--skip_train"])
    for i in range(len(scene.data.test)):
        png = np.asarray(Image.open(os.path.join(
            out_dir, "test", f"ours_{n_iter}", "renders", f"{i:05d}.png")))
        if png.shape != (BENCH["height"], BENCH["width"], 3) or \
                png.std() < 1.0:
            fail(f"trained model: blank or misshapen test render {i}")
    return trainer, scene, dict(
        seconds=seconds, launches=launches, iterations=n_iter,
        initial_points=n_init, capacity=trainer.state.capacity,
        n_alive=int(trainer.state.num_alive), logged=steps,
        test_psnr=[r["test_psnr"] for r in tests], psnr_rise_db=rise,
        overflow_steps=len(over), overflow_events=trainer.overflow_events,
        entry_budget=trainer.config.entry_budget,
        max_demand=max(t for _, t, _ in demand))


def train_rate(trainer, scene) -> dict:
    """Phase 8: TRAIN_TIMED Trainer.step calls at SH degree 3 with no SH
    ramp, densify event or budget probe inside the window (iterations
    10_004.. avoid multiples of 40 and 1000)."""
    import random

    import torch

    w, h = scene.image_size
    n_train = len(scene.data.train)
    gts = torch.as_tensor(scene.data.train.images, device=DEVICE)
    cams = [scene.cam_arrays("train", i) for i in range(n_train)]
    trainer.active_sh_degree = trainer.max_sh_degree
    rnd = random.Random(1)
    it0 = 10_001
    for it in range(it0, it0 + 3):
        vi = rnd.randint(0, n_train - 1)
        trainer.step(it, cams[vi], gts[vi], w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(it0 + 3, it0 + 3 + TRAIN_TIMED):
        vi = rnd.randint(0, n_train - 1)
        m = trainer.step(it, cams[vi], gts[vi], w, h)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(it_per_s=TRAIN_TIMED / seconds,
                ms_per_step=seconds / TRAIN_TIMED * 1e3,
                n_alive=int(trainer.state.num_alive),
                entry_budget=trainer.config.entry_budget,
                last_loss=float(m["loss"]))


def fwd_bound(entries, t_total, feat_numel, nv, w, h, visited, weighted):
    """composite_fwd's bound, as in phase 4: the live keys, tile bounds,
    feature table and image; 14 ops per visited pair, 4 + 2 (1 + nv) per
    weighted pair."""
    return bound(entries * 8 + t_total * 8 + feat_numel * 4
                 + (1 + nv) * w * h * 4,
                 visited * 14 + weighted * (4 + 2 * (1 + nv)))


def subset_stream(st, cam, used, w, h, budget, with_depth):
    """Prologue, decode and sort of a subset render (opacity masked to 0
    off the subset, as render_fwd does) at `budget`, raised to twice the
    demand as the segmentation ladder does when the demand exceeds it."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians

    with torch.no_grad():
        opacity = torch.where(used, st.opacity(),
                              torch.zeros_like(st.params.opacity_logit))
        splats = project_gaussians(
            st.params.means, st.scales(), st.params.quats, opacity, *cam, w,
            h, colors=torch.zeros((st.capacity, 1), device=DEVICE))
        plan = CR.alloc_prologue(splats, w, h, budget)
        if int(plan.total) > budget:
            budget = (int(plan.total) * 2 + 127) // 128 * 128
            plan = CR.alloc_prologue(splats, w, h, budget)
        key, alive = CR.decode_cull(plan)
        skeys, starts, ends = CR.sorted_stream(key, plan.t_total,
                                               plan.rank_bits)
        feat = CR.entry_features(splats, plan.order, False, with_depth)
    return (skeys, starts, ends, feat, plan.rank_bits, w, h), plan, \
        int(alive), budget


def check_seg_kernels(scene, scene_dir: str):
    """Phase 9: the segmentation shapes of the compositor kernels on train
    view 0 of the stand-in model."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config
    from wheat3dgs_tpu_torch.seg import flashsplat
    from wheat3dgs_tpu_torch.utils import image_ops

    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    cam = cams[0]
    config = adapt_config(st, cam, w, h, cams=cams)   # run_3d_seg_app's
    budget = config.entry_budget
    # The lift's first batch of view 0: its first masks, the all-ones row,
    # zero rows to 8 (as SegContext._lift_camera builds it).
    paths = scene.data.train.metas[0].mask_paths or []
    rows = [image_ops.read_mask(p, (w, h)) for p in paths[:7]]
    rows.append(np.ones((h, w), bool))
    rows += [np.zeros((h, w), bool)] * (8 - len(rows))
    planes = torch.as_tensor(np.stack(rows), dtype=torch.float32,
                             device=DEVICE)
    bits8 = torch.as_tensor(np.stack([np.packbits(r, axis=None)
                                      for r in rows]), device=DEVICE)

    with torch.no_grad():
        splats = project_gaussians(
            st.params.means, st.scales(), st.params.quats, st.opacity(),
            *cam, w, h, colors=torch.zeros((st.capacity, 8), device=DEVICE))
        plan = CR.alloc_prologue(splats, w, h, budget)
        key, alive = CR.decode_cull(plan)
        skeys, starts, ends, perm = CR.sorted_stream(
            key, plan.t_total, plan.rank_bits, with_perm=True)
        feat = CR.entry_features(splats, plan.order, True, True)
    nv = feat.shape[1] - 6
    if nv != 9:
        fail(f"the lift composites {nv} value rows, expected 9")
    cols, e, n, entries = 6 + nv, skeys.shape[0], feat.shape[0], int(alive)

    fargs = (skeys, starts, ends, feat, plan.rank_bits, w, h)
    img_k, stop_k = CR.composite_train_fwd(*fargs)
    (img_p, stop_p), fwd_plain_ms = timed_once(
        lambda: CR.composite_train_fwd_plain(*fargs))
    err = (img_k - img_p).abs()
    if not bool(torch.isfinite(img_k).all()) or not bool(
            (err <= COMPOSITE_ATOL + COMPOSITE_RTOL * img_p.abs()).all()):
        fail(f"composite_train_fwd at nv=9 differs from its plain version: "
             f"max abs err {float(err.max())}")
    stop_off = int((stop_k != stop_p).sum())
    if stop_off > STOP_MISMATCH_MAX * w * h:
        fail(f"composite_train_fwd at nv=9: stop differs on {stop_off} "
             "pixels")
    _, (visited, weighted) = CR.composite_fwd_plain(*fargs, with_counts=True)
    fwd = dict(value_rows=nv, ms=cuda_time_ms(
        lambda: CR.composite_train_fwd(*fargs), 20), plain_ms=fwd_plain_ms,
        max_abs_err=float(err.max()), stop_pixels_differing=stop_off,
        shape={"slots": e, "entries": entries, "value_rows": nv,
               "visited_pairs": visited, "weighted_pairs": weighted})
    fwd["bound_ms"], fwd["bound_by"] = bound(
        entries * 8 + plan.t_total * 8 + feat.numel() * 4
        + ((1 + nv) * 4 + 4) * w * h,
        visited * 14 + weighted * (4 + 2 * (1 + nv)))

    # The label planes are the cotangent of the 8 colour rows.
    grad = torch.zeros_like(img_k)
    grad[2:] = planes
    bargs = (skeys, perm, starts, ends, feat, img_k, stop_k, grad,
             plan.rank_bits, w, h)
    rows_k = CR.composite_bwd(*bargs)
    rows_p, bwd_plain_ms = timed_once(lambda: CR.composite_bwd_plain(*bargs))
    col_max = rows_p.abs().amax(dim=0).clamp(min=1e-30)
    bwd_rel = float(((rows_k - rows_p).abs() / col_max).max())
    if not bool(torch.isfinite(rows_k).all()) or bwd_rel > BWD_REL:
        fail(f"composite_bwd at nv=9 differs from its plain version: "
             f"{bwd_rel} of the column max (bound {BWD_REL})")
    tiles_x = plan.tiles_x
    ty = torch.arange(h, device=DEVICE)[:, None] // CR.TILE_PX
    tx = torch.arange(w, device=DEVICE)[None, :] // CR.TILE_PX
    bwd_visited = int((stop_k.long() - starts[ty * tiles_x + tx]).sum())
    bwd = dict(value_rows=nv, ms=cuda_time_ms(
        lambda: CR.composite_bwd(*bargs), 20), plain_ms=bwd_plain_ms,
        max_abs_err=float((rows_k - rows_p).abs().max()),
        max_rel_err_of_column_max=bwd_rel,
        shape={"slots": e, "entries": entries, "columns": cols,
               "visited_pairs": bwd_visited, "weighted_pairs": weighted})
    bwd["bound_ms"], bwd["bound_by"] = bound(
        entries * 16 + plan.t_total * 8 + feat.numel() * 4
        + (2 * (1 + nv) * 4 + 4) * w * h + e * cols * 4,
        bwd_visited * 14 + weighted * (36 + 4 * nv))

    sargs = (rows_k, plan.seg_start, plan.seg_end)
    out_k = CR.segsum(*sargs)
    out_p, seg_plain_ms = timed_once(lambda: CR.segsum_plain(*sargs))
    scale = out_p.abs().amax(dim=0).clamp(min=1e-30)
    seg_rel = float(((out_k - out_p).abs() / scale).max())
    if seg_rel > SEGSUM_REL:
        fail(f"segsum at 15 columns differs from its plain version: "
             f"{seg_rel} of the column max (bound {SEGSUM_REL})")
    used = int(plan.seg_end[-1])
    offsets = torch.cat([plan.seg_start, plan.seg_end[-1:]]).long()
    seg = dict(value_rows=nv, ms=cuda_time_ms(lambda: CR.segsum(*sargs), 50),
               plain_ms=seg_plain_ms,
               library_ms=cuda_time_ms(lambda: torch.segment_reduce(
                   rows_k[:used], "sum", offsets=offsets), 50),
               max_abs_err=float((out_k - out_p).abs().max()),
               max_rel_err_of_column_max=seg_rel,
               shape={"slots_summed": used, "ranks": n, "columns": cols})
    seg["bound_ms"], seg["bound_by"] = bound(
        used * cols * 4 + n * 8 + n * cols * 4, used * cols)

    # The lifted counts: kernels against the all-plain path.
    lift_args = (st, *cam, bits8)
    lift_kw = dict(width=w, height=h, config=config)
    got = flashsplat.lift_batch8(*lift_args, **lift_kw)
    with plain_kernels():
        ref = flashsplat.lift_batch8(*lift_args, **lift_kw)
    row_max = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    lift_rel = float(((got - ref).abs() / row_max).max())
    if not bool(torch.isfinite(got).all()) or lift_rel > LIFT_REL:
        fail(f"lift_batch8 counts differ from the all-plain path: "
             f"{lift_rel} of the row max (bound {LIFT_REL})")
    lift = dict(ms=cuda_time_ms(
        lambda: flashsplat.lift_batch8(*lift_args, **lift_kw), 5),
        max_rel_err_of_row_max=lift_rel, masks=len(paths),
        entry_budget=budget)

    # composite_fwd at the subset renders' shapes: alpha-only at the subset
    # budget (match / predbits), with depth at the scene's (eval).
    gt = np.load(os.path.join(scene_dir, "gt_points.npz"))["head_id"]
    head = torch.zeros((st.capacity,), dtype=torch.bool, device=DEVICE)
    head[:len(gt)] = torch.as_tensor(gt == 1, device=DEVICE)
    seg_budget = max(2048, (budget // 8 + 127) // 128 * 128)
    comp = []
    for with_depth, b in ((False, seg_budget), (True, budget)):
        cargs, splan, s_entries, b = subset_stream(st, cam, head, w, h, b,
                                                   with_depth)
        img_k = CR.composite_fwd(*cargs)
        img_p, (vis, wtd) = CR.composite_fwd_plain(*cargs, with_counts=True)
        err = (img_k - img_p).abs()
        if not bool((err <= COMPOSITE_ATOL + COMPOSITE_RTOL *
                     img_p.abs()).all()) or float(img_k[0].max()) <= 0.5:
            fail(f"composite_fwd at nv={int(with_depth)} differs from its "
                 f"plain version ({float(err.max())}) or renders nothing")
        r = dict(value_rows=int(with_depth),
                 ms=cuda_time_ms(lambda: CR.composite_fwd(*cargs), 50),
                 plain_ms=timed_once(
                     lambda: CR.composite_fwd_plain(*cargs))[1],
                 max_abs_err=float(err.max()),
                 shape={"slots": b, "demand": int(splan.total),
                        "entries": s_entries, "value_rows": int(with_depth),
                        "visited_pairs": vis, "weighted_pairs": wtd})
        r["bound_ms"], r["bound_by"] = fwd_bound(
            s_entries, splan.t_total, cargs[3].numel(), int(with_depth), w,
            h, vis, wtd)
        comp.append(r)
    return fwd, bwd, seg, comp, lift


def seg_path(scene_dir: str, model_dir: str) -> dict:
    """Phase 10: apps/run_3d_seg_app over the bench scene and the stand-in
    model, with the launch counters read around exactly that call."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.apps import run_3d_seg_app
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.seg import flashsplat
    from wheat3dgs_tpu_torch.seg.pipeline import SegContext, load_pt

    # Host-clock seconds and calls of each device step (each returns host
    # arrays, so the device work is inside), the subset renders' demand
    # against their budget, and the run's SegContext.
    calls = {k: [0, 0.0] for k in ("lift", "match", "predbits")}
    renders, ctxs = [], []
    saved = {"lift": SegContext._lift_camera,
             "match": SegContext.match_device,
             "predbits": SegContext.predbits_device}
    raw = {k: getattr(flashsplat, k) for k in ("match_views_packed",
                                               "predbits_views")}

    def timed(kind):
        def wrapper(self, *a, **k):
            if not ctxs:
                ctxs.append(self)
            t0 = time.perf_counter()
            out = saved[kind](self, *a, **k)
            calls[kind][0] += 1
            calls[kind][1] += time.perf_counter() - t0
            return out
        return wrapper

    def recorded(name):
        def wrapper(*a, **k):
            out = raw[name](*a, **k)
            renders.append((name, int(out[-1]), k["config"].entry_budget))
            return out
        return wrapper

    try:
        SegContext._lift_camera = timed("lift")
        SegContext.match_device = timed("match")
        SegContext.predbits_device = timed("predbits")
        for name in raw:
            setattr(flashsplat, name, recorded(name))
        CR.reset_launches()
        t0 = time.perf_counter()
        summary = run_3d_seg_app.main(["-s", scene_dir, "-m", model_dir,
                                       "--exp_name", "smoke", "--device",
                                       DEVICE, "--quiet"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
    finally:
        SegContext._lift_camera = saved["lift"]
        SegContext.match_device = saved["match"]
        SegContext.predbits_device = saved["predbits"]
        for name, fn in raw.items():
            setattr(flashsplat, name, fn)
    for k in ("decode_cull", "composite_fwd", "composite_train_fwd",
              "composite_bwd", "segsum"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the segmentation path")

    base = summary["out_dir"]
    num_heads = summary["num_heads"]
    rows = open(os.path.join(base, "results.csv")).read().splitlines()
    plys = [f for f in os.listdir(os.path.join(base, "ply"))
            if f.startswith("wh_")]
    maps = sorted(os.listdir(os.path.join(base, "2DSeg")))
    if len(rows) < 2 or not plys or len(maps) != 12:
        fail(f"segmentation artifacts: {len(rows)} csv lines, {len(plys)} "
             f"head plys, {len(maps)} 2DSeg maps (expected 12)")
    ids = set()
    for f in maps:
        ids |= set(np.unique(load_pt(os.path.join(base, "2DSeg", f))))
    if len(ids - {0}) != num_heads:
        fail(f"2DSeg maps hold {len(ids - {0})} head ids, run found "
             f"{num_heads}")
    # A subset render over its budget must be rerun at a budget that holds
    # its demand: the next render of the same step.
    for i, (name, demand, budget) in enumerate(renders):
        if demand > budget and not (
                i + 1 < len(renders) and renders[i + 1][0] == name
                and renders[i + 1][2] >= demand):
            fail(f"{name}: demand {demand} over budget {budget} without a "
                 "rerun")

    # The heads against the generator's ground truth (splat i of the
    # stand-in is gt point i).
    gt = np.load(os.path.join(scene_dir, "gt_points.npz"))["head_id"]
    inst = summary["state"].instance_id.cpu().numpy()[:len(gt)]
    purity, majority = [], set()
    for hid in np.unique(inst[inst > 0]):
        vals, counts = np.unique(gt[inst == hid], return_counts=True)
        purity.append(float(counts.max() / counts.sum()))
        majority.add(int(vals[np.argmax(counts)]))
    median_purity = float(np.median(purity)) if purity else 0.0
    covered = len(majority - {0})
    if not (SEG_HEADS[0] <= num_heads <= SEG_HEADS[1]) or \
            median_purity < SEG_MEDIAN_PURITY:
        fail(f"segmentation found {num_heads} heads (gate {SEG_HEADS}), "
             f"median purity {median_purity} (gate {SEG_MEDIAN_PURITY})")

    # Device busy share over association steps of the run's context.
    from torch.profiler import ProfilerActivity, profile

    ctx = ctxs[0]
    counts = ctx.cached_counts(0, ctx.mask_paths[0][0])
    ctx.match_device(counts)
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            ctx.match_device(counts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        seconds=seconds, launches=launches, num_heads=num_heads,
        heads_with_letter_saves=len(plys), results_rows=len(rows) - 1,
        calls={k: {"calls": c, "seconds": t,
                   "ms_per_call": t / c * 1e3 if c else None}
               for k, (c, t) in calls.items()},
        subset_renders=len(renders),
        subset_overflows=sum(d > b for _, d, b in renders),
        seg_budget=ctx.seg_budget, entry_budget=ctx.config.entry_budget,
        max_subset_demand=max((d for _, d, _ in renders), default=0),
        masks=int(sum(len(p) for p in ctx.mask_paths)),
        purity=purity, median_purity=median_purity,
        gt_heads_covered=covered,
        match_step={"ms_host": wall_us / reps / 1e3,
                    "device_busy_share": device_us / wall_us,
                    "top_device_us": {e.key: e.self_device_time_total / reps
                                      for e in top}})


def eval_path(model_dir: str) -> dict:
    """Phase 11: apps/eval_wheatgs_app over the same model, with the launch
    counters read around exactly that call."""
    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch.apps import eval_wheatgs_app
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    CR.reset_launches()
    t0 = time.perf_counter()
    labels = eval_wheatgs_app.main(["-m", model_dir, "--exp_name", "smoke",
                                    "--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(CR.launches)
    for k in ("decode_cull", "composite_fwd", "composite_train_fwd",
              "composite_bwd", "segsum"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the evaluation path")
    if not os.path.exists(os.path.join(model_dir, "wheat-head", "smoke",
                                       "all_counts.pt")):
        fail("all_counts.pt was not written")
    nonzero = {}
    for sub in ("segmentation", "overlay"):
        d = os.path.join(model_dir, "test", sub)
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        if len(files) != 2:
            fail(f"test/{sub}: {len(files)} PNGs, expected 2")
        for f in files:
            png = np.asarray(Image.open(os.path.join(d, f)))
            if png.shape[:2] != (BENCH["height"], BENCH["width"]) or \
                    not png.any():
                fail(f"test/{sub}/{f}: empty or misshapen {png.shape}")
            nonzero[f"{sub}/{f}"] = float((png > 0).mean())
    return dict(seconds=seconds, launches=launches,
                labelled_gaussians=int(labels[1:].any(axis=0).sum()),
                label_rows=int(labels.shape[0]), nonzero_share=nonzero)


def check_probe() -> dict:
    """Phase 12: the scan probe's kinds against the plain version, timed,
    then apps/prof_scan with the launch counters read around it."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.apps import prof_scan
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops import scan_probe as SP

    p, c, steps = prof_scan.P, prof_scan.C, prof_scan.STEPS
    inputs = {
        "ones": torch.full((p, c), 0.001, device=DEVICE),
        "normal": torch.as_tensor(np.random.default_rng(0).normal(
            size=(p, c)).astype(np.float32), device=DEVICE)}
    # Every kind computes one function: a row prefix sum (one add per
    # value), then |s|, the max and the scale, so one bound holds for all
    # of them. algorithm_ops is what each kind's own algorithm does.
    func_ops = 1 + 3
    algorithm_ops = {"matmul": 2 * c, "cumsum": 1, "roll": 7}
    kinds = {}
    for kind in SP.KINDS:
        errs = {}
        for name, x in inputs.items():
            got = SP.scan_probe(x, kind, steps)
            ref = SP.scan_probe_plain(x, kind, steps)
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max())
            rel = errs[name] / float(ref.abs().max())
            if not bool(torch.isfinite(got).all()) or rel > PROBE_REL:
                fail(f"scan_probe {kind} on {name}: {rel} of the max "
                     f"(bound {PROBE_REL})")
        x = inputs["ones"]
        r = dict(ms=cuda_time_ms(lambda: SP.scan_probe(x, kind, steps), 10),
                 plain_ms=cuda_time_ms(
                     lambda: SP.scan_probe_plain(x, kind, steps), 2,
                     warmup=1),
                 max_abs_err=max(errs.values()), max_abs_err_by_input=errs)
        r["us_per_scan"] = r["ms"] * 1e3 / steps
        r["bound_ms"], r["bound_by"] = bound(2 * p * c * 4,
                                             p * c * steps * func_ops)
        r["algorithm_ops"] = p * c * steps * (algorithm_ops[kind] + 3)
        kinds[kind] = r
    library_ms = cuda_time_ms(
        lambda: prof_scan.cumsum_loop(inputs["ones"], steps), 3)
    CR.reset_launches()
    t0 = time.perf_counter()
    app = prof_scan.main([])
    seconds = time.perf_counter() - t0
    launches = CR.launches["scan_probe"]
    if launches <= 0:
        fail("the scan probe kernel was not launched by apps/prof_scan")
    return dict(kinds=kinds, library_ms=library_ms,
                library_us_per_scan=library_ms * 1e3 / steps,
                app_us_per_scan=app, seconds=seconds,
                launches={"scan_probe": launches},
                shape={"rows": p, "lanes": c, "steps": steps})


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        import wheat3dgs_tpu_torch  # noqa: F401
        from wheat3dgs_tpu_torch.ops import cuda_build
    except ImportError as exc:
        fail(f"the port is not importable next to this script ({exc})")
    t_start = time.perf_counter()

    # 1. device
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    say("device", name=kind, count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    # 2. build (every source in parallel)
    t0 = time.perf_counter()
    per_kernel = cuda_build.build()
    ptxas = {}
    for name in cuda_build.KERNELS:
        log = (cuda_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    say("build", seconds=time.perf_counter() - t0, per_kernel=per_kernel,
        ptxas=ptxas)

    # 3. data
    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "scene")
    model_dir = os.path.join(WORK, "model")
    t0 = time.perf_counter()
    n = make_data(scene_dir, model_dir)
    say("data", seconds=time.perf_counter() - t0, splats=n,
        width=BENCH["width"], height=BENCH["height"], sh_degree=3)

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.scene import Scene

    scene = Scene(cfg.ModelParams(source_path=scene_dir, model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    if scene.sh_degree != 3:
        fail(f"model loaded at SH degree {scene.sh_degree}")

    # 4. kernels against their plain versions
    dec, comp = check_kernels(scene)
    say("kernels", decode_cull=dec, composite_fwd=comp)

    # 5. the serving path
    mp = main_path(model_dir, scene)
    say("main_path", **mp)
    print(f"render_fwd: {mp['fps']:.3f} FPS at "
          f"{BENCH['width']}x{BENCH['height']}, {n} splats, SH 3 on "
          f"{smi}", flush=True)

    # 6. training kernels against their plain versions
    tfwd, tbwd, tseg, e2e = check_train_kernels(scene)
    say("train_kernels", composite_train_fwd=tfwd, composite_bwd=tbwd,
        segsum=tseg, end_to_end=e2e)
    del scene

    # 7. the training path
    trainer, tscene, tp = train_path(scene_dir,
                                     os.path.join(WORK, "train_model"))
    say("train_path", **tp)

    # 8. steady training rate
    rate = train_rate(trainer, tscene)
    say("train_rate", **rate)
    print(f"train_step: {rate['it_per_s']:.3f} it/s at "
          f"{BENCH['width']}x{BENCH['height']}, {rate['n_alive']} splats, "
          f"SH 3 on {smi}", flush=True)
    del trainer, tscene

    # 9. segmentation kernels against their plain versions
    scene = Scene(cfg.ModelParams(source_path=scene_dir, model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    sfwd, sbwd, sseg, scomp, lift = check_seg_kernels(scene, scene_dir)
    say("seg_kernels", composite_train_fwd=sfwd, composite_bwd=sbwd,
        segsum=sseg, composite_fwd=scomp, lift_batch8=lift)
    del scene

    # 10. the segmentation path
    sp = seg_path(scene_dir, model_dir)
    say("seg_path", **sp)
    print(f"segmentation: {sp['num_heads']} heads, median purity "
          f"{sp['median_purity']:.3f}, {sp['gt_heads_covered']} of "
          f"{BENCH['n_heads']} ground-truth heads, {sp['seconds']:.1f} s on "
          f"{smi}", flush=True)

    # 11. the evaluation path
    ep = eval_path(model_dir)
    say("eval_path", **ep)

    # 12. the scan probe
    probe = check_probe()
    say("probe", **probe)

    src = "wheat3dgs_tpu_torch/csrc/"
    tpu = "wheat3dgs_tpu/ops/pallas_raster.py:"
    keys = ("value_rows", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "library_ms", "shape")
    rows = []
    for name, r, file, line, path, shapes in (
            ("decode_cull", dec, "decode_cull.cu", 381, mp, []),
            ("composite_fwd", comp, "composite_fwd.cu", 1094, mp, scomp),
            ("composite_train_fwd", tfwd, "composite_fwd.cu", 704, tp,
             [sfwd]),
            ("composite_bwd", tbwd, "composite_bwd.cu", 840, tp, [sbwd]),
            ("segsum", tseg, "segsum.cu", 507, tp, [sseg])):
        rows.append({"name": name, "route": "cuda", "source": src + file,
                     "replaces": f"{tpu}{line}",
                     "launches": path["launches"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "launches_by_path": {
                         "serving": mp["launches"][name],
                         "training": tp["launches"][name],
                         "segmentation": sp["launches"][name],
                         "evaluation": ep["launches"][name]},
                     "segmentation_shapes": [
                         {k: x.get(k) for k in keys} for x in shapes]})
    # The probe's row: the cumsum kind (torch.cumsum computes the same
    # function), each kind beside it.
    cum = probe["kinds"]["cumsum"]
    rows.append({"name": "scan_probe", "route": "cuda",
                 "source": src + "scan_probe.cu",
                 "replaces": "scripts/prof_scan.py:21",
                 "launches": probe["launches"]["scan_probe"],
                 "max_abs_err": max(k["max_abs_err"]
                                    for k in probe["kinds"].values()),
                 "ms": cum["ms"], "plain_ms": cum["plain_ms"],
                 "bound_ms": cum["bound_ms"], "bound_by": cum["bound_by"],
                 "library_ms": probe["library_ms"],
                 "kinds": {k: {x: v[x] for x in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "max_abs_err",
                                                 "us_per_scan",
                                                 "algorithm_ops")}
                           for k, v in probe["kinds"].items()}})
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s; card: {smi}",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
