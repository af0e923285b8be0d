"""Minimal training variant (reference: test.py, C2 in SURVEY.md).

Counterpart of the repo's root `test.py`:

    python -m wheat3dgs_tpu_torch.apps.train_minimal -s <scene> -m <model> \
        [--iterations N] [--save_iterations ...] [--device cuda|cpu]

The same loop as apps/train_vanilla without checkpoint-resume or metrics
logging, one `Trainer.step` per iteration, and the cameras drawn WITHOUT
replacement per epoch: `random.randint` pops from a stack refilled when
empty (test.py:27-32), under `seed_everything(0)`. Every 10 iterations the
loss enters an EMA, printed every 100; the model is saved at each save
iteration and at the end.
"""

from __future__ import annotations

import random
import sys
from argparse import ArgumentParser

import torch

from .. import config as cfg
from .. import resolve_device
from ..scene import Scene
from ..training import Trainer
from ..utils.general import seed_everything


def training(model, opt, pipe, saving_iterations, quiet=False,
             device="cuda"):
    dev = resolve_device(device)
    scene = Scene(model, sh_degree=model.sh_degree, device=dev)
    width, height = scene.image_size
    trainer = Trainer(scene.gaussians, opt, scene.cameras_extent,
                      sh_degree=model.sh_degree,
                      white_background=model.white_background)
    gt_images = torch.as_tensor(scene.data.train.images, device=dev)
    stack = []
    ema = 0.0
    for it in range(1, opt.iterations + 1):
        if not stack:
            stack = list(range(gt_images.shape[0]))
        vi = stack.pop(random.randint(0, len(stack) - 1))
        m = trainer.step(it, scene.cam_arrays("train", vi), gt_images[vi],
                         width, height)
        if it % 10 == 0:
            ema = 0.6 * ema + 0.4 * float(m["loss"])
            if not quiet and it % 100 == 0:
                print(f"[{it}] ema loss {ema:.5f} "
                      f"alive {int(m['n_alive'])}", flush=True)
        if it in saving_iterations:
            scene.save(it, trainer.state)
    scene.save(opt.iterations, trainer.state)
    return trainer, scene


def main(argv=None):
    parser = ArgumentParser(description="minimal training script")
    cfg.add_params(parser, cfg.ModelParams)
    cfg.add_params(parser, cfg.OptimizationParams)
    cfg.add_params(parser, cfg.PipelineParams)
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 15_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(0)
    from .train_vanilla import prepare_output

    model = prepare_output(cfg.extract(cfg.ModelParams, args))
    return training(model, cfg.extract(cfg.OptimizationParams, args),
                    cfg.extract(cfg.PipelineParams, args),
                    set(args.save_iterations), quiet=args.quiet,
                    device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
