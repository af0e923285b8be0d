"""2D evaluation of the 3D segmentation (reference: eval_wheatgs.py).

Counterpart of wheat3dgs_tpu/apps/eval_wheatgs_app.py: rebuilds the
per-Gaussian labels from the saved 2DSeg maps (writing all_counts.pt), or
from a stored all_counts.pt with --load_counts, then writes per-view
`segmentation` (binary L-mode) and `overlay` PNGs for the train and test
splits under the model directory.

    python -m wheat3dgs_tpu_torch.apps.eval_wheatgs_app -m <model>
        --exp_name e [--skip_train] [--load_counts] [--device cpu]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from .. import config as cfg
from .. import resolve_device
from ..render.pipeline import (RasterConfig, adapt_config, inference_config,
                               render_fwd)
from ..scene import Scene
from ..seg import flashsplat
from ..seg.eval import eval_obj_labels, labels_from_seg_maps
from ..seg.pipeline import load_pt, save_pt
from ..utils import image_ops


def render_set(scene: Scene, split: str, obj_labels, bg,
               config: RasterConfig) -> None:
    from PIL import Image

    group = scene.data.train if split == "train" else scene.data.test
    if not len(group.metas):
        return
    overlay_dir = os.path.join(scene.model_path, split, "overlay")
    seg_dir = os.path.join(scene.model_path, split, "segmentation")
    os.makedirs(overlay_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    w, h = group.cameras.width, group.cameras.height
    labels = torch.as_tensor(obj_labels, device=scene.device)
    for i, meta in enumerate(group.metas):
        cam = scene.cam_arrays(split, i)
        out = render_fwd(scene.gaussians, *cam, w, h,
                         sh_degree=scene.sh_degree, bg=bg, config=config)
        pred = eval_obj_labels(scene.gaussians, labels, *cam, width=w,
                               height=h, config=config).cpu().numpy()
        binary = np.where(pred != 0, 255, 0).astype(np.uint8)
        Image.fromarray(binary, mode="L").save(
            os.path.join(seg_dir, f"{meta.image_name}.png"))
        rgb_mask = image_ops.visualize_obj(pred).astype(np.float32) / 255.0
        over = image_ops.overlay_image(
            np.clip(out.color.cpu().numpy(), 0, 1), rgb_mask)
        Image.fromarray((over.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            os.path.join(overlay_dir, f"{meta.image_name}.png"))


def render_sets(model: cfg.ModelParams, exp_name: str, skip_train: bool,
                load_counts: bool, config: RasterConfig = RasterConfig(),
                device="cuda") -> np.ndarray:
    scene = Scene(model, load_iteration=-1, shuffle=False, device=device)
    base = os.path.join(model.model_path, "wheat-head", exp_name)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0,
                    dtype=torch.float32, device=scene.device)
    w, h = scene.image_size
    probe_cams = [
        scene.cam_arrays(s, i)
        for s, grp in (("train", scene.data.train), ("test", scene.data.test))
        for i in range(len(grp.metas))]
    config = adapt_config(scene.gaussians, scene.cam_arrays("train", 0),
                          w, h, inference_config(config), cams=probe_cams)

    if load_counts:
        all_counts = load_pt(os.path.join(base, "all_counts.pt"))
        obj_labels = flashsplat.multi_instance_opt(
            torch.as_tensor(all_counts), 0.0).numpy()
    else:
        seg_dir = os.path.join(base, "2DSeg")
        seg_maps = [load_pt(os.path.join(seg_dir, f"{m.image_name}.pt"))
                    for m in scene.data.train.metas]
        all_counts, obj_labels = labels_from_seg_maps(
            scene.gaussians, scene.cam_stack("train"), seg_maps, w, h,
            config)
        save_pt(all_counts, os.path.join(base, "all_counts.pt"))
    if not skip_train:
        render_set(scene, "train", obj_labels, bg, config)
    render_set(scene, "test", obj_labels, bg, config)
    return obj_labels


def main(argv=None):
    parser = ArgumentParser(description="wheat3dgs_tpu_torch seg evaluation")
    cfg.add_params(parser, cfg.ModelParams, fill_none=True)
    cfg.add_params(parser, cfg.PipelineParams)
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--load_counts", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = cfg.get_combined_args(parser, argv)
    device = resolve_device(args.device)
    model = cfg.extract(cfg.ModelParams, args)
    print(f"Rendering {model.model_path}/{args.exp_name}")
    return render_sets(model, args.exp_name, args.skip_train,
                       args.load_counts, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
