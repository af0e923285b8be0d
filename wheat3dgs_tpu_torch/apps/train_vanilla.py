"""3DGS reconstruction training CLI (reference: train_vanilla_3dgs.py).

Counterpart of wheat3dgs_tpu/apps/train_vanilla.py, with the same flags,
schedule and output tree (`cfg_args`, `input.ply`, `cameras.json`,
`metrics.jsonl`, TensorBoard scalars, `profile/`,
`point_cloud/iteration_<it>/point_cloud.ply`, `chkpnt<it>.npz`), plus
`--device`:

    python -m wheat3dgs_tpu_torch.apps.train_vanilla -s <scene> -m <model>
        [--iterations N] [--device cuda|cpu] [--profile]

The run is cut into blocks as the JAX CLI cuts it (`block_len`): a block
of K > 1 steps runs through `Trainer.step_block` (on a CUDA device, a
captured step replayed from a CUDA graph), K = 1 through `Trainer.step`.
Views are drawn with `random.Random(0).randint`, one per step, the
sequence the JAX CLI draws, so a run of either package sees the same
views. Kept differences from the JAX CLI: autograd's anomaly detection
cannot run inside a captured step, so `--detect_anomaly` runs every step
alone, and `--debug_from D` every step from D + 1 on (JAX's
`jax_debug_nans` runs inside its scan); `--profile` writes a
`torch.profiler` Chrome trace of the 20 steps from the first iteration +
200 to `<model>/profile/` (JAX: a jax.profiler trace), with the program's
spans (`utils/trace.py`: "w3dgs/train.*", "w3dgs/graph.*") on.
TensorBoard scalars are written when `torch.utils.tensorboard` imports;
the JSONL log holds the same numbers. `--max_per_tile` and
`--max_tiles_per_gauss` are the JAX XLA backend's knobs, accepted and
unused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import time
import uuid
from argparse import ArgumentParser

import torch

from .. import config as cfg
from .. import resolve_device
from ..models.serialization import load_checkpoint, save_checkpoint
from ..ops.losses import psnr
from ..render.pipeline import adapt_config, render_fwd
from ..scene import Scene
from ..training import Trainer
from ..utils import trace
from ..utils.general import seed_everything


def prepare_output(model: cfg.ModelParams) -> cfg.ModelParams:
    if not model.model_path:
        model = dataclasses.replace(
            model, model_path=os.path.join("./output", str(uuid.uuid4())[:10]))
    os.makedirs(model.model_path, exist_ok=True)
    cfg.save_cfg_args(model.model_path, model)
    return model


def evaluate_test(scene: Scene, trainer: Trainer) -> float | None:
    """Mean PSNR over the test split (reference training_report,
    train_vanilla_3dgs.py:145-180), rendered with the forward-only path at
    an entry budget probed over all test views (so no view crops)."""
    n = len(scene.data.test.metas)
    if n == 0:
        return None
    cams = [scene.cam_arrays("test", i) for i in range(n)]
    w, h = scene.data.test.cameras.width, scene.data.test.cameras.height
    config = adapt_config(trainer.state, cams[0], w, h, cams=cams)
    vals = []
    for i in range(n):
        out = render_fwd(trainer.state, *cams[i], w, h,
                         sh_degree=trainer.active_sh_degree, bg=trainer.bg,
                         config=config)
        vals.append(psnr(torch.clamp(out.color, 0, 1),
                         scene.gt_image("test", i)))
    return float(torch.stack(vals).mean())


LOG_EVERY = 100
# A block's most steps past its first (the JAX CLI's `it + 49`).
BLOCK_SPAN = 49
# Steps traced with --profile, from the first iteration + PROFILE_FROM.
PROFILE_FROM, PROFILE_STEPS = 200, 20


def block_len(it: int, opt: cfg.OptimizationParams, end_events,
              profile_at: int = -1, debug_from: int = -1) -> int:
    """Steps to run as one block from iteration `it` (the JAX CLI's rule,
    wheat3dgs_tpu/apps/train_vanilla.py:104-127).

    A block ends AT the next log, densify, `end_events` (test, save,
    checkpoint) iteration, `it + BLOCK_SPAN` or the run's end (their host
    work runs on the block's last iteration), and BEFORE the next SH-ramp
    multiple, the profile window (`profile_at` >= 0) and `debug_from`
    (those must start a block). 1 with a random background, inside the
    profile window, and (the port's own rules) from debug_from + 1 on
    (anomaly detection cannot run in a captured step) and from a multiple
    of BLOCK_SPAN + 1: JAX's rule ends every later block of BLOCK_SPAN + 1
    steps one short of the log and densify multiples, so from an SH-ramp
    block at 1000 on no block ends at a densify iteration and no densify
    runs until an end event realigns the blocks (without checkpoints
    every 1000 iterations, 14 of the 104 densifies of the default
    schedule run); a one-step block there realigns them."""
    in_profile = profile_at >= 0 and (
        profile_at - 1 <= it <= profile_at + PROFILE_STEPS)
    if (opt.random_background or in_profile or 0 <= debug_from < it
            or it % (BLOCK_SPAN + 1) == 0):
        return 1
    ends = [(it // LOG_EVERY + 1) * LOG_EVERY,
            (it // opt.densification_interval + 1)
            * opt.densification_interval,
            it + BLOCK_SPAN, opt.iterations]
    ends += [e for e in end_events if e >= it]
    if debug_from >= it:
        ends.append(debug_from)
    nxt_sh = (it // 1000 + 1) * 1000 if it % 1000 else it + 1000
    ends.append(nxt_sh - 1)
    if profile_at > it:
        ends.append(profile_at - 1)
    return max(1, min(ends) - it + 1)


def densify_record(it: int, trainer: Trainer, metrics: dict) -> dict:
    """The metrics.jsonl record of the densify at `it`: densify_and_prune's
    counts, then the entry budget, the block's (or step's) entries_total
    (-1 on the padded-tile backend, which also logs its max_per_tile and
    max_tiles_per_gauss), the overflow events so far and the capacity."""
    info = {k: int(v) for k, v in trainer.last_densify[1].items()}
    info.update(entry_budget=trainer.config.entry_budget,
                entries_total=int(metrics["entries_total"]),
                overflow_events=trainer.overflow_events,
                capacity=trainer.state.capacity)
    if trainer.config.backend == "xla":
        info.update(max_per_tile=trainer.config.max_per_tile,
                    max_tiles_per_gauss=trainer.config.max_tiles_per_gauss)
    return {"iter": it, "densify": info}


def _tensorboard(model_path: str):
    """A SummaryWriter into the model dir, or None where
    torch.utils.tensorboard does not import (the reference's scalars,
    train_vanilla_3dgs.py:145-180)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(model_path)


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    trace.on()          # the program's spans, inside the profiler's range
    return prof


def _stop_profile(prof, dev: torch.device, model_path: str) -> None:
    """Stop the trace once the traced steps ran and write it to
    <model>/profile/trace.json (Chrome trace format)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    trace.off()
    prof.stop()
    out = os.path.join(model_path, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def training(model: cfg.ModelParams, opt: cfg.OptimizationParams,
             test_iterations, save_iterations, checkpoint_iterations,
             start_checkpoint: str | None, quiet: bool = False,
             detect_anomaly: bool = False, debug_from: int = -1,
             profile: bool = False, device="cuda"):
    """Train one plot; returns (trainer, scene). Autograd's anomaly
    detection is on for every step with detect_anomaly, and from iteration
    debug_from + 1 on with debug_from >= 0 (the reference's rasterizer
    debug mode, train_vanilla_3dgs.py:68); those steps run one at a
    time."""
    dev = resolve_device(device)
    model = prepare_output(model)
    scene = Scene(model, sh_degree=model.sh_degree, device=dev)
    width, height = scene.image_size
    trainer = Trainer(scene.gaussians, opt, scene.cameras_extent,
                      sh_degree=model.sh_degree,
                      white_background=model.white_background)
    first_iter = 0
    if start_checkpoint:
        trainer.state, first_iter = load_checkpoint(start_checkpoint,
                                                    device=dev)
        trainer.active_sh_degree = min(first_iter // 1000,
                                       trainer.max_sh_degree)

    gt_images = torch.as_tensor(scene.data.train.images, device=dev)
    cam_stack = scene.cam_stack("train")
    n_train = gt_images.shape[0]
    log_f = open(os.path.join(model.model_path, "metrics.jsonl"), "a")
    tb = _tensorboard(model.model_path)
    rnd = random.Random(0)
    t0 = time.time()
    window_t0, window_it = t0, first_iter
    ema_loss = None
    profile_at = first_iter + PROFILE_FROM if profile else -1
    prof = None
    end_events = (set(test_iterations) | set(save_iterations)
                  | set(checkpoint_iterations) | {opt.iterations})

    it = first_iter + 1
    while it <= opt.iterations:
        anomaly = detect_anomaly or 0 <= debug_from < it
        if it == profile_at:
            prof = _start_profile(dev)
        k = 1 if anomaly else block_len(it, opt, end_events, profile_at,
                                        debug_from)
        if k == 1:
            vi = rnd.randint(0, n_train - 1)  # with replacement (:65)
            with torch.autograd.set_detect_anomaly(anomaly):
                metrics = trainer.step(it, scene.cam_arrays("train", vi),
                                       gt_images[vi], width, height)
        else:
            vis = [rnd.randint(0, n_train - 1) for _ in range(k)]
            metrics = trainer.step_block(it, vis, cam_stack, gt_images,
                                         width, height, n_steps=k)
        it += k - 1
        if prof is not None and it == profile_at + PROFILE_STEPS:
            _stop_profile(prof, dev, model.model_path)
            prof = None
        if it % LOG_EVERY == 0 or it == opt.iterations:
            loss = float(metrics["loss"])
            ema_loss = (loss if ema_loss is None
                        else 0.6 * ema_loss + 0.4 * loss)
            now = time.time()
            ips = (it - window_it) / max(now - window_t0, 1e-9)
            window_t0, window_it = now, it
            rec = {"iter": it, "loss": loss, "ema_loss": ema_loss,
                   "psnr": float(metrics["psnr"]),
                   "n_alive": int(metrics["n_alive"]), "iters_per_sec": ips,
                   "capacity": trainer.state.capacity,
                   "entry_budget": trainer.config.entry_budget,
                   "entries_total": int(metrics["entries_total"])}
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
            if tb is not None:
                tb.add_scalar("train_loss_patches/total_loss", loss, it)
                tb.add_scalar("train/psnr", rec["psnr"], it)
                tb.add_scalar("total_points", rec["n_alive"], it)
                tb.add_scalar("iter_time", 1e3 / max(ips, 1e-9), it)
            if not quiet:
                print(f"[it {it:6d}] loss {loss:.4f} psnr {rec['psnr']:.2f} "
                      f"alive {rec['n_alive']} {ips:.1f} it/s", flush=True)
        if trainer.last_densify is not None and trainer.last_densify[0] == it:
            rec = densify_record(it, trainer, metrics)
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
            if not quiet:
                print(f"[it {it:6d}] densify " + " ".join(
                    f"{k} {v}" for k, v in rec["densify"].items()),
                    flush=True)
        if it in test_iterations:
            tp = evaluate_test(scene, trainer)
            if tp is not None:
                if not quiet:
                    print(f"[it {it}] TEST psnr {tp:.2f}", flush=True)
                log_f.write(json.dumps({"iter": it, "test_psnr": tp}) + "\n")
                log_f.flush()
                if tb is not None:
                    tb.add_scalar("test/psnr", tp, it)
        if it in save_iterations:
            scene.save(it, trainer.state)
        if it in checkpoint_iterations:
            save_checkpoint(trainer.state, it, os.path.join(
                model.model_path, f"chkpnt{it}.npz"))
        it += 1
    if prof is not None:     # the run ended inside the traced steps
        _stop_profile(prof, dev, model.model_path)
    if opt.iterations not in save_iterations:
        scene.save(opt.iterations, trainer.state)
    log_f.close()
    if tb is not None:
        tb.close()
    total = time.time() - t0
    if not quiet:
        print(f"Training complete in {total:.1f}s "
              f"({(opt.iterations - first_iter) / max(total, 1e-9):.1f} it/s)")
    return trainer, scene


def main(argv=None):
    parser = ArgumentParser(description="wheat3dgs_tpu_torch training")
    cfg.add_params(parser, cfg.ModelParams)
    cfg.add_params(parser, cfg.OptimizationParams)
    # The reference's pipeline flags select reference-internal paths
    # (Python SH / covariance); accepted for the same command lines.
    cfg.add_params(parser, cfg.PipelineParams)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 15_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of 20 hot steps")
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--debug_from", type=int, default=-1,
                        help="iteration from which autograd's anomaly "
                             "detection is on (reference "
                             "train_vanilla_3dgs.py:188 flips the "
                             "rasterizer's debug mode)")
    parser.add_argument("--max_per_tile", type=int, default=512)
    parser.add_argument("--max_tiles_per_gauss", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(0)

    model = cfg.extract(cfg.ModelParams, args)
    opt = cfg.extract(cfg.OptimizationParams, args)
    print(f"Optimizing {model.model_path or '(new output dir)'}")
    out = training(model, opt, set(args.test_iterations),
                   set(args.save_iterations),
                   set(args.checkpoint_iterations), args.start_checkpoint,
                   quiet=args.quiet, detect_anomaly=args.detect_anomaly,
                   debug_from=args.debug_from, profile=args.profile,
                   device=device)
    print("Training done.")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
