"""Interactive viewer entry point (reference:
wheat3dgsviewer/wheatgs_rendering.py and singlewheat_rendering.py).

Counterpart of the root wheatgs_rendering.py / singlewheat_rendering.py:
loads the trained scene and the all_obj_labels.pth that the field 360 run
wrote, and serves the web viewer (viewer/server.py) with the per-head
overlay (`main`) or without it (`main_single`), with the COLMAP train and
test cameras as teleports.

    python -m wheat3dgs_tpu_torch.apps.viewer_app -s <scene> -m <model>
        --exp_name e [--port 8080] [--width 960 --height 720] [--device cpu]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

from .. import config as cfg
from .. import resolve_device
from ..render.pipeline import RasterConfig, adapt_config, inference_config
from ..scene import Scene
from ..seg.pipeline import load_pt
from ..viewer import ViewerState, serve


def build_viewer(argv=None, with_overlay=True):
    parser = ArgumentParser()
    cfg.add_params(parser, cfg.ModelParams)
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--no_scale_filter", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model = cfg.extract(cfg.ModelParams, args)
    scene = Scene(model, load_iteration=-1, shuffle=False, load_images=False,
                  device=device)

    obj_labels = None
    if with_overlay:
        labels_path = os.path.join(model.model_path, "wheat-head",
                                   args.exp_name, "all_obj_labels.pth")
        if os.path.exists(labels_path):
            obj_labels = load_pt(labels_path).astype(bool)
            cap = scene.gaussians.capacity
            if obj_labels.shape[1] < cap:
                pad = np.zeros((obj_labels.shape[0],
                                cap - obj_labels.shape[1]), bool)
                obj_labels = np.concatenate([obj_labels, pad], axis=1)
        else:
            print(f"(no overlay: {labels_path} not found — run "
                  "render_360_app --render_type field first)")

    names, poses = [], []
    for split in ("train", "test"):
        group = scene.data.train if split == "train" else scene.data.test
        c = group.cameras
        for i, m in enumerate(group.metas):
            names.append(f"{split}:{m.image_name}")
            eye = c.cam_center[i].cpu().numpy()
            fwd = c.w2c[i][2, :3].cpu().numpy()   # camera +z in world
            poses.append((eye, eye + fwd))

    vs = ViewerState(
        scene.gaussians, scene.sh_degree, width=args.width,
        height=args.height, obj_labels=obj_labels, camera_names=names,
        camera_poses=poses,
        scale_filter=None if args.no_scale_filter else 0.1,
        config=adapt_config(
            scene.gaussians, scene.cam_arrays("train", 0),
            args.width, args.height, inference_config(RasterConfig())),
        device=device)
    return vs, args


def main(argv=None):
    vs, args = build_viewer(argv)
    serve(vs, port=args.port)


def main_single(argv=None):
    vs, args = build_viewer(argv, with_overlay=False)
    serve(vs, port=args.port)


if __name__ == "__main__":
    main(sys.argv[1:])
