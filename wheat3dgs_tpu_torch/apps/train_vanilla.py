"""3DGS reconstruction training CLI (reference: train_vanilla_3dgs.py).

Counterpart of wheat3dgs_tpu/apps/train_vanilla.py, with the same flags,
schedule and output tree (`cfg_args`, `input.ply`, `cameras.json`,
`metrics.jsonl`, `point_cloud/iteration_<it>/point_cloud.ply`,
`chkpnt<it>.npz`), plus `--device`:

    python -m wheat3dgs_tpu_torch.apps.train_vanilla -s <scene> -m <model>
        [--iterations N] [--device cuda|cpu]

Views are drawn with `random.Random(0).randint` once per iteration, the
sequence the JAX CLI draws (per step or per block), so a run of either
package sees the same views. Left out of the JAX CLI: its TensorBoard
scalars (the JSONL log holds the same numbers) and `--profile` (a trace of
20 steps; `apps/profile_train.py` breaks a step down by stage and kernel).
`--max_per_tile` and `--max_tiles_per_gauss` are its XLA-backend knobs,
accepted and unused.
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


def training(model: cfg.ModelParams, opt: cfg.OptimizationParams,
             test_iterations, save_iterations, checkpoint_iterations,
             start_checkpoint: str | None, quiet: bool = False,
             detect_anomaly: bool = False, debug_from: int = -1,
             device="cuda"):
    """Train one plot; returns (trainer, scene). Autograd's anomaly
    detection is on for every step with detect_anomaly, and from iteration
    debug_from + 1 on with debug_from >= 0 (the reference's rasterizer
    debug mode, train_vanilla_3dgs.py:68)."""
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
    n_train = gt_images.shape[0]
    log_f = open(os.path.join(model.model_path, "metrics.jsonl"), "a")
    rnd = random.Random(0)
    t0 = time.time()
    window_t0, window_it = t0, first_iter
    ema_loss = None

    for it in range(first_iter + 1, opt.iterations + 1):
        vi = rnd.randint(0, n_train - 1)  # sample with replacement (:65)
        anomaly = detect_anomaly or 0 <= debug_from < it
        with torch.autograd.set_detect_anomaly(anomaly):
            metrics = trainer.step(it, scene.cam_arrays("train", vi),
                                   gt_images[vi], width, height)
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
            if not quiet:
                print(f"[it {it:6d}] loss {loss:.4f} psnr {rec['psnr']:.2f} "
                      f"alive {rec['n_alive']} {ips:.1f} it/s", flush=True)
        if it in test_iterations:
            tp = evaluate_test(scene, trainer)
            if tp is not None:
                if not quiet:
                    print(f"[it {it}] TEST psnr {tp:.2f}", flush=True)
                log_f.write(json.dumps({"iter": it, "test_psnr": tp}) + "\n")
                log_f.flush()
        if it in save_iterations:
            scene.save(it, trainer.state)
        if it in checkpoint_iterations:
            save_checkpoint(trainer.state, it, os.path.join(
                model.model_path, f"chkpnt{it}.npz"))
    if opt.iterations not in save_iterations:
        scene.save(opt.iterations, trainer.state)
    log_f.close()
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
                   debug_from=args.debug_from, device=device)
    print("Training done.")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
