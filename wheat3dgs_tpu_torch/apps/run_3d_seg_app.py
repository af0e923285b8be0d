"""3D instance segmentation CLI (reference: run_3d_seg.py __main__:394-407).

Counterpart of wheat3dgs_tpu/apps/run_3d_seg_app.py: loads the trained
scene, builds the SegContext from the train split's YOLO-SAM mask and bbox
files, sizes the entry budget over every train view, and runs the
find-&-match loop, writing `<model>/wheat-head/<exp_name>/`.

    python -m wheat3dgs_tpu_torch.apps.run_3d_seg_app -s <scene> -m <model>
        --exp_name e [--iou_threshold 0.6] [--device cpu]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

from .. import config as cfg
from .. import resolve_device
from ..io.synthetic import load_bboxes
from ..render.pipeline import RasterConfig, adapt_config, inference_config
from ..scene import Scene
from ..seg.pipeline import SegContext, run_segmentation
from ..utils.general import seed_everything


def build_context(scene: Scene, config: RasterConfig) -> SegContext:
    group = scene.data.train
    image_names, mask_paths, bboxes = [], [], []
    for m in group.metas:
        image_names.append(m.image_name)
        mask_paths.append(list(m.mask_paths or []))
        if m.bbox_path and os.path.exists(m.bbox_path):
            scale = m.resolution_scale or 1.0
            bboxes.append(load_bboxes(m.bbox_path) / scale)
        else:
            bboxes.append(np.zeros((0, 4), np.float32))
    return SegContext(state=scene.gaussians, cams=scene.cam_stack("train"),
                      image_names=image_names, mask_paths=mask_paths,
                      bboxes=bboxes, width=group.cameras.width,
                      height=group.cameras.height, config=config,
                      images=group.images)


def main(argv=None):
    parser = ArgumentParser(description="wheat3dgs_tpu_torch 3D segmentation")
    cfg.add_params(parser, cfg.ModelParams)
    cfg.add_params(parser, cfg.PipelineParams)
    parser.add_argument("--load_iteration", default=-1, type=int)
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--iou_threshold", type=float, default=0.6)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(0)

    model = cfg.extract(cfg.ModelParams, args)
    scene = Scene(model, load_iteration=args.load_iteration, shuffle=False,
                  device=device)
    print(f"Loaded iteration {scene.loaded_iter}: "
          f"{int(scene.gaussians.num_alive)} Gaussians")
    w0, h0 = scene.image_size
    n_train = len(scene.data.train.metas)
    config = adapt_config(
        scene.gaussians, scene.cam_arrays("train", 0), w0, h0,
        inference_config(RasterConfig()),
        cams=[scene.cam_arrays("train", i) for i in range(n_train)])
    ctx = build_context(scene, config)

    test_group = scene.data.test
    eval_names = [m.image_name for m in test_group.metas]
    eval_cams = scene.cam_stack("test") if eval_names else None

    summary = run_segmentation(
        ctx, model.model_path, args.exp_name,
        iou_threshold=args.iou_threshold, eval_names=eval_names,
        eval_cams=eval_cams, verbose=not args.quiet)
    print(f"Identified {summary['num_heads']} wheat heads -> "
          f"{summary['out_dir']}")
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
