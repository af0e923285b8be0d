"""Synthetic wheat-plot dataset generator (COLMAP layout), partial.

Counterpart of wheat3dgs_tpu/io/synthetic.py without the masks: writes
`sparse/0/{cameras,images,points3D}.bin` and `images/plot_<id>_<cam:02d>.png`
(cam index > 10 => test split). The ground-truth images are rendered with
the port's own `render_fwd` from a known Gaussian scene (ground plane +
ellipsoidal "wheat heads"), with override colours at SH degree 0 as the
JAX generator does. Splat sizes come from a 3-nearest-neighbour distance
(scipy's cKDTree). Per-head masks and bboxes wait for the segmentation
slice of the port.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist
from ..utils import graphics

# The JAX generator's defaults (wheat3dgs_tpu/io/synthetic.py).
COLOR_NOISE = 0.15      # per-point colour stddev (texture pins fine splats)
SPLAT_SCALE = 0.9       # splat size as a fraction of the 3-NN distance
FOV = 0.9
CAM_RADIUS = 2.2
CAM_ELEV_DEG = 40.0
POINT_JITTER = 0.02     # noise on the COLMAP points3D subsample


def _scene_points(rng: np.random.Generator, n_heads: int, pts_per_head: int,
                  ground_pts: int):
    """Returns (points, colors, head_id) with head_id 0 = ground; the same
    draws, in the same order, as the JAX generator."""
    color_noise = COLOR_NOISE
    pts, cols, hid = [], [], []
    g = np.stack([rng.uniform(-1.2, 1.2, ground_pts),
                  rng.uniform(-1.2, 1.2, ground_pts),
                  rng.normal(0.0, 0.02, ground_pts)], axis=1)
    pts.append(g)
    base = np.array([0.25, 0.45, 0.15])
    cols.append(base + rng.normal(0, color_noise, (ground_pts, 3)))
    hid.append(np.zeros(ground_pts, np.int32))
    for h in range(n_heads):
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        cz = rng.uniform(0.35, 0.55)
        axis = rng.normal(0, 0.08, 3) + np.array([0, 0, 1.0])
        axis /= np.linalg.norm(axis)
        t = rng.normal(0, 1.0, pts_per_head)
        radial = rng.normal(0, 0.025, (pts_per_head, 3))
        p = (np.array([cx, cy, cz])[None]
             + axis[None] * (t[:, None] * 0.09) + radial)
        pts.append(p)
        gold = np.array([0.8, 0.7, 0.3])
        cols.append(gold + rng.normal(0, color_noise * 0.8,
                                      (pts_per_head, 3)))
        hid.append(np.full(pts_per_head, h + 1, np.int32))
    return (np.concatenate(pts).astype(np.float32),
            np.clip(np.concatenate(cols), 0, 1).astype(np.float32),
            np.concatenate(hid))


def _ring_cameras(n: int, radius: float, elev_deg: float,
                  center=(0.0, 0.0, 0.2)):
    """COLMAP (qvec, tvec) for n cameras on a ring looking at `center`
    (+z forward, +y down)."""
    out = []
    center = np.asarray(center)
    elev = np.deg2rad(elev_deg)
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = center + radius * np.array(
            [np.cos(ang) * np.cos(elev), np.sin(ang) * np.cos(elev),
             np.sin(elev)])
        fwd = center - eye
        fwd /= np.linalg.norm(fwd)
        world_down = np.array([0.0, 0.0, -1.0])
        right = np.cross(fwd, world_down)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right) * -1.0
        down /= np.linalg.norm(down)
        R = np.stack([right, down, fwd], axis=0)  # w2c rotation
        t = -R @ eye
        out.append((graphics.rotmat_to_qvec(R), t))
    return out


def _image_name(plot_id: int, i: int, n_cams: int) -> str:
    # >12 ring positions cycle the FIP camera labels 1..12 (the split keys
    # on the last underscore token: cam > 10 => test).
    if n_cams <= 12:
        return f"plot_{plot_id:03d}_{i + 1:02d}.png"
    return f"plot_{plot_id:03d}_r{i // 12}_{(i % 12) + 1:02d}.png"


def gt_params(n_heads: int = 4, pts_per_head: int = 120,
              ground_pts: int = 900, seed: int = 0):
    """The generator's ground-truth scene: (rng, params dict of numpy
    GaussianParams fields, colors, head_id). Isotropic splats sized by the
    3-NN distance, opacity logit 4, SH degree 0 (colours are rendered as
    override colours). The rng is returned for the draws that follow."""
    rng = np.random.default_rng(seed)
    points, colors, head_id = _scene_points(rng, n_heads, pts_per_head,
                                            ground_pts)
    n = len(points)
    dist = np.sqrt(np.maximum(knn_mean_sq_dist(points), 1e-12))
    log_scales = np.log(np.clip(dist * SPLAT_SCALE, 1e-4, 0.1))
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    params = {
        "means": points,
        "quats": quats,
        "log_scales": np.repeat(log_scales[:, None], 3, 1).astype(np.float32),
        "sh_dc": np.zeros((n, 3), np.float32),
        "sh_rest": np.zeros((n, 0), np.float32),
        "opacity_logit": np.full((n,), 4.0, np.float32),
    }
    return rng, params, colors, head_id


def cam_args(qvec, tvec, proj, fovx, fovy, device):
    """Per-camera render arguments (w2c, full_proj, center, tan half-fovs)."""
    R = graphics.qvec_to_rotmat(qvec)
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = tvec
    full_proj = (proj @ w2c).astype(np.float32)
    cam_center = (-R.T @ tvec).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return (t(w2c), t(full_proj), t(cam_center), t(np.tan(fovx / 2)),
            t(np.tan(fovy / 2)))


def make_synthetic_colmap_scene(
    out_dir: str,
    plot_id: int = 0,
    width: int = 160,
    height: int = 120,
    n_cams: int = 12,
    n_heads: int = 4,
    pts_per_head: int = 120,
    ground_pts: int = 900,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Create the dataset on disk; returns a manifest dict. The COLMAP
    points3D are a jittered subsample of the true points."""
    from PIL import Image

    from .. import resolve_device
    from ..models.gaussians import GaussianParams, init_state
    from ..render.pipeline import adapt_config, render_fwd
    from . import colmap

    dev = resolve_device(device)
    rng, params, colors, head_id = gt_params(n_heads, pts_per_head,
                                             ground_pts, seed)
    n = len(colors)
    state = init_state(GaussianParams(**{
        k: torch.as_tensor(v, device=dev) for k, v in params.items()}),
        instance_id=head_id)
    colors_cap = torch.zeros((state.capacity, 3), dtype=torch.float32,
                             device=dev)
    colors_cap[:n] = torch.as_tensor(colors, device=dev)

    fx = graphics.fov2focal(FOV, width)
    fovx = graphics.focal2fov(fx, width)
    fovy = graphics.focal2fov(fx, height)
    proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    cams = _ring_cameras(n_cams, radius=CAM_RADIUS, elev_deg=CAM_ELEV_DEG)
    args = [cam_args(q, t, proj, fovx, fovy, dev) for q, t in cams]
    config = adapt_config(state, args[0], width, height, cams=args)

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)

    intr = {1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                                   np.array([fx, fx, width / 2, height / 2]))}
    extr = {}
    manifest = {"images": [], "n_points": n, "n_heads": n_heads}
    for i, ((qvec, tvec), a) in enumerate(zip(cams, args)):
        name = _image_name(plot_id, i, n_cams)
        extr[i + 1] = colmap.ColmapImage(
            i + 1, qvec, tvec, 1, name, np.zeros((0, 2)),
            np.zeros(0, np.int64))
        out = render_fwd(state, *a, width, height, sh_degree=0,
                         override_color=colors_cap, config=config)
        img = np.clip(out.color.cpu().numpy().transpose(1, 2, 0), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "images", name))
        manifest["images"].append(name)

    colmap.write_intrinsics_binary(os.path.join(sparse, "cameras.bin"), intr)
    colmap.write_extrinsics_binary(os.path.join(sparse, "images.bin"), extr)
    sub = rng.choice(n, size=max(n // 2, 64), replace=False)
    noisy = params["means"][sub] + rng.normal(0, POINT_JITTER, (len(sub), 3))
    colmap.write_points3D_binary(
        os.path.join(sparse, "points3D.bin"), noisy.astype(np.float64),
        (colors[sub] * 255).astype(np.uint8))
    np.savez_compressed(os.path.join(out_dir, "gt_points.npz"),
                        points=params["means"], head_id=head_id)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def write_stand_in_model(model_dir: str, scene_dir: str, n_heads: int = 4,
                         pts_per_head: int = 120, ground_pts: int = 900,
                         seed: int = 0, iteration: int = 30_000,
                         device="cuda") -> int:
    """A stand-in "trained" SH-degree-3 model of the generator's scene
    (same arguments and seed): the ground-truth splats with sh_dc =
    rgb_to_sh(colours), seeded N(0, 0.05) f_rest and a seeded per-axis
    log-scale jitter N(0, 0.3) (anisotropic conics). Writes
    `point_cloud/iteration_<it>/point_cloud.ply` and `cfg_args` pointing at
    scene_dir; returns the splat count."""
    from .. import config as cfg
    from ..models.gaussians import state_from_numpy
    from ..models.serialization import save_ply
    from ..utils.sh import rgb_to_sh

    _, params, colors, head_id = gt_params(n_heads, pts_per_head,
                                           ground_pts, seed)
    n = len(colors)
    rng = np.random.default_rng(seed + 1)
    params["sh_dc"] = rgb_to_sh(colors).astype(np.float32)
    params["sh_rest"] = rng.normal(0.0, 0.05, (n, 45)).astype(np.float32)
    params["log_scales"] = (params["log_scales"] + rng.normal(
        0.0, 0.3, (n, 3))).astype(np.float32)
    state = state_from_numpy(params, instance_id=head_id, device=device)
    save_ply(state, os.path.join(model_dir, "point_cloud",
                                 f"iteration_{iteration}", "point_cloud.ply"))
    cfg.save_cfg_args(model_dir, cfg.ModelParams(source_path=scene_dir,
                                                 model_path=model_dir))
    return n
