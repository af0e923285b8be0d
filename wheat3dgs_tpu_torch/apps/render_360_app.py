"""360° turntable videos (reference: render_360.py).

Counterpart of wheat3dgs_tpu/apps/render_360_app.py.
--render_type field: rebuild per-Gaussian labels from the saved 2DSeg maps,
save all_counts.pth / all_obj_labels.pth, orbit the field at half
resolution with the depth-resolved per-head overlay -> wheat_field_360.mp4.
--render_type head: per wh_*.ply closeup turntable (1/3 resolution, FoV/5,
white background) -> one video per head under wheat_head_360/.

The entry budget is probed once per orbit over all its cameras
(adapt_config(cams=...)), and every frame's entries_total is checked
against it: a frame over budget raises, it is never cropped. A caller's
"xla" config (the library functions' `config`) is used as given, as JAX's
app uses its config: no probe, no check, and the padded-tile path crops a
tile at max_per_tile.

    python -m wheat3dgs_tpu_torch.apps.render_360_app -m <model>
        --exp_name e --render_type field|head [--n_frames 100]
        [--framerate 10] [--elevation 45] [--save_frames] [--device cpu]
"""

from __future__ import annotations

import math
import os
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from .. import config as cfg
from .. import resolve_device
from ..models.serialization import load_ply
from ..render.camera_paths import (c2ws_to_camera_arrays,
                                   camera_path_fixed_elevation)
from ..render.pipeline import (RasterConfig, adapt_config, inference_config,
                               render_fwd)
from ..scene import Scene
from ..seg.eval import eval_obj_labels, labels_from_seg_maps
from ..seg.pipeline import load_pt, save_pt
from ..utils import image_ops
from ..utils.video import write_video


def _fov_from_cameras(cams):
    fovx = 2.0 * math.atan(float(cams.tanfovx[0]))
    fovy = 2.0 * math.atan(float(cams.tanfovy[0]))
    return fovx, fovy


def _orbit_cams(c2ws, fovx, fovy, device):
    """The orbit's cameras as device tensors, copied once: (w2c, full_proj,
    cam_center, tanfovx, tanfovy) per frame, each a view of one stack."""
    stacks = [torch.as_tensor(a, device=device)
              for a in c2ws_to_camera_arrays(c2ws, fovx, fovy)]
    return [tuple(s[i] for s in stacks) for i in range(len(c2ws))]


def orbit_config(state, c2ws, fovx, fovy, width, height,
                 config: RasterConfig = RasterConfig()) -> RasterConfig:
    """The entry budget for every frame of the orbit `c2ws`: the maximum
    allocation demand over all its cameras. An "xla" config is returned
    as given."""
    if config.backend == "xla":
        return config
    cams = _orbit_cams(c2ws, fovx, fovy, state.device)
    return adapt_config(state, cams[0], width, height,
                        inference_config(config), cams=cams)


def _to_host(tensors):
    """Start the copies of `tensors` to the host; returns (host tensors,
    a CUDA event to wait on, or None on the CPU). Each copy queues behind
    the work that made its tensor, so waiting on the event waits for that
    frame only, not for a later frame queued after it."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _orbit_frames(state, sh_degree, c2ws, fovx, fovy, width, height, bg,
                  config, obj_labels=None, save_dir=None):
    """(H, W, 3) uint8 frames of the orbit `c2ws`, with the per-head
    overlay when `obj_labels` ((L+1, cap) bool) is given.

    Frame i + 1's renders are queued before the host reads frame i, and
    nothing in the queueing reads the host, so the device renders the next
    frame while the host overlays and encodes this one. `config` must carry
    the orbit's probed budget; a frame whose demand exceeds it raises
    (each head's render draws a subset of the colour render's splats, so
    its demand is no larger). An "xla" config reports no demand and is
    not checked."""
    check = config.backend == "pallas"
    if check and config.entry_budget <= 0:
        raise ValueError("_orbit_frames needs a probed entry budget "
                         "(orbit_config)")
    cams = _orbit_cams(c2ws, fovx, fovy, state.device)
    labels = nonempty = None
    if obj_labels is not None:
        labels = torch.as_tensor(np.asarray(obj_labels),
                                 device=state.device).to(torch.bool)
        nonempty = labels.any(dim=1).tolist()       # once per orbit
    frames = []

    def dispatch(i):
        out = render_fwd(state, *cams[i], width, height,
                         sh_degree=sh_degree, bg=bg, config=config)
        parts = [out.color, out.entries_total if check
                 else torch.zeros((), device=state.device)]
        if labels is not None:
            parts.append(eval_obj_labels(state, labels, *cams[i],
                                         width=width, height=height,
                                         config=config, nonempty=nonempty))
        return _to_host(parts)

    pending = dispatch(0) if len(c2ws) else None
    for i in range(len(c2ws)):
        nxt = dispatch(i + 1) if i + 1 < len(c2ws) else None
        parts, done = pending
        if done is not None:
            done.synchronize()                       # frame i only
        total = int(parts[1])
        if check and total > config.entry_budget:
            raise RuntimeError(
                f"orbit frame {i}: entry demand {total} over the probed "
                f"budget {config.entry_budget}")
        img = np.clip(parts[0].numpy(), 0, 1)
        if labels is not None:
            rgb_mask = image_ops.visualize_obj(
                parts[2].numpy()).astype(np.float32) / 255.0
            img = image_ops.overlay_image(img, rgb_mask)
        frame = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
        frames.append(frame)
        if save_dir is not None:
            from PIL import Image

            Image.fromarray(frame).save(
                os.path.join(save_dir, f"{i:05d}.png"))
        pending = nxt
    return frames


def render_wheat_field(model: cfg.ModelParams, exp_name: str,
                       n_frames: int = 100, framerate: int = 10,
                       elevation: float = 45, save_frames: bool = False,
                       load_iteration: int = -1,
                       config: RasterConfig = RasterConfig(),
                       device="cuda"):
    """reference render_wheat_field (render_360.py:139-188)."""
    scene = Scene(model, load_iteration=load_iteration, shuffle=False,
                  device=device)
    base = os.path.join(model.model_path, "wheat-head", exp_name)
    out_dir = os.path.join(base, "3DSeg")
    os.makedirs(out_dir, exist_ok=True)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0,
                    dtype=torch.float32, device=scene.device)
    w, h = scene.image_size
    cams = scene.data.train.cameras
    seg_maps = [load_pt(os.path.join(base, "2DSeg", f"{m.image_name}.pt"))
                for m in scene.data.train.metas]
    # The lift renders the train views at full size: their budget.
    n_train = len(scene.data.train.metas)
    lift_config = config if config.backend == "xla" else adapt_config(
        scene.gaussians, scene.cam_arrays("train", 0), w, h,
        inference_config(config),
        cams=[scene.cam_arrays("train", i) for i in range(n_train)])
    all_counts, obj_labels = labels_from_seg_maps(
        scene.gaussians, scene.cam_stack("train"), seg_maps, w, h,
        lift_config)
    save_pt(all_counts, os.path.join(base, "all_counts.pth"))
    save_pt(obj_labels, os.path.join(base, "all_obj_labels.pth"))

    st = scene.gaussians
    centroid = st.params.means[st.alive].mean(0).cpu().numpy()
    fovx, fovy = _fov_from_cameras(cams)
    c2ws = camera_path_fixed_elevation(
        n_frames, 1, camera_distance=scene.cameras_extent * 2,
        cam_center=centroid.tolist(), elevation=elevation)
    orbit = orbit_config(st, c2ws, fovx, fovy, w // 2, h // 2, config)
    frames = _orbit_frames(st, scene.sh_degree, c2ws, fovx, fovy, w // 2,
                           h // 2, bg, orbit, obj_labels=obj_labels,
                           save_dir=out_dir if save_frames else None)
    video = write_video(frames, os.path.join(base, "wheat_field_360.mp4"),
                        framerate)
    if not save_frames:
        shutil.rmtree(out_dir, ignore_errors=True)
    return video


def render_wheat_head(model: cfg.ModelParams, exp_name: str,
                      n_frames: int = 100, framerate: int = 10,
                      elevation: float = 15, save_frames: bool = False,
                      config: RasterConfig = RasterConfig(), device="cuda"):
    """reference render_wheat_head (render_360.py:71-137): per-head closeup
    turntables at 1/3 resolution with FoV/5, white background."""
    scene = Scene(model, load_iteration=-1, shuffle=False, load_images=False,
                  device=device)
    bg = torch.ones(3, dtype=torch.float32, device=scene.device)
    cams = scene.data.train.cameras
    w, h = cams.width // 3, cams.height // 3
    fovx, fovy = _fov_from_cameras(cams)
    fovx, fovy = fovx / 5, fovy / 5

    ply_dir = os.path.join(model.model_path, "wheat-head", exp_name, "ply")
    out_base = os.path.join(os.path.dirname(ply_dir), "wheat_head_360")
    videos = []
    for ply_file in sorted(os.listdir(ply_dir)):
        stem = os.path.splitext(ply_file)[0]
        if not (ply_file.startswith("wh") and ply_file.endswith(".ply")):
            continue
        if len(stem.split("_")) > 2:   # skip letter-suffixed duplicates
            continue
        head_state, head_sh = load_ply(os.path.join(ply_dir, ply_file),
                                       device=scene.device)
        alive = head_state.alive
        if not bool(alive.any()):
            continue
        centroid = head_state.params.means[alive].mean(0).cpu().numpy()
        ply_id = stem.replace("wh_", "", 1)
        frames_dir = os.path.join(out_base, ply_id)
        os.makedirs(frames_dir, exist_ok=True)
        c2ws = camera_path_fixed_elevation(
            n_frames, 1, camera_distance=scene.cameras_extent * 0.65,
            cam_center=centroid.tolist(), elevation=elevation)
        orbit = orbit_config(head_state, c2ws, fovx, fovy, w, h, config)
        frames = _orbit_frames(head_state, head_sh, c2ws, fovx, fovy, w, h,
                               bg, orbit,
                               save_dir=frames_dir if save_frames else None)
        videos.append(write_video(
            frames, os.path.join(out_base, f"{ply_id}.mp4"), framerate))
        if not save_frames:
            shutil.rmtree(frames_dir, ignore_errors=True)
    return videos


def main(argv=None):
    parser = ArgumentParser(description="wheat3dgs_tpu_torch 360 rendering")
    cfg.add_params(parser, cfg.ModelParams, fill_none=True)
    cfg.add_params(parser, cfg.PipelineParams)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--render_type", type=str, default=None)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--n_frames", type=int, default=100)
    parser.add_argument("--framerate", type=int, default=10)
    parser.add_argument("--elevation", type=int, default=45)
    parser.add_argument("--save_frames", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = cfg.get_combined_args(parser, argv)
    device = resolve_device(args.device)
    model = cfg.extract(cfg.ModelParams, args)
    print(f"Rendering {model.model_path} exp {args.exp_name} "
          f"type {args.render_type}")
    if args.render_type == "field":
        return render_wheat_field(model, args.exp_name, args.n_frames,
                                  args.framerate, args.elevation,
                                  args.save_frames, args.iteration,
                                  device=device)
    if args.render_type == "head":
        return render_wheat_head(model, args.exp_name, args.n_frames,
                                 args.framerate, args.elevation,
                                 args.save_frames, device=device)
    raise SystemExit("--render_type must be 'field' or 'head'")


if __name__ == "__main__":
    main(sys.argv[1:])
