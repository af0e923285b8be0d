"""Synthetic wheat-plot dataset generator (COLMAP layout).

Counterpart of wheat3dgs_tpu/io/synthetic.py: writes
`sparse/0/{cameras,images,points3D}.bin`, `images/plot_<id>_<cam:02d>.png`
(cam index > 10 => test split), per-view SAM-style binary head masks
`masks/<image>_<k>.png` and YOLO-style bbox tensors `bboxes/<image>.pt`.
The ground-truth images are rendered with the port's own `render_fwd` from
a known Gaussian scene (ground plane + ellipsoidal "wheat heads"), with
override colours at SH degree 0 as the JAX generator does; the masks come
from the depth-resolved head map of `seg/eval.py::eval_obj_labels`.
Splat sizes come from a 3-nearest-neighbour distance (scipy's cKDTree).
Both generators render with inference_config(RasterConfig(
max_tiles_per_gauss=32, max_per_tile=256, tile_batch=16)): JAX's runs
its XLA backend there on a CPU host (16-px tiles), the port's the entry
stream (32-px tiles; the tile fields are carried and unused), so the two
packages' masks differ by a few boundary pixels.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist, knn_mean_sq_dist_bf16
from ..utils import graphics

# The JAX generator's constants (wheat3dgs_tpu/io/synthetic.py).
COLOR_NOISE = 0.15      # per-point colour stddev (texture pins fine splats)
SPLAT_SCALE = 0.9       # splat size as a fraction of the 3-NN distance
FOV = 0.9


def _scene_points(rng: np.random.Generator, n_heads: int, pts_per_head: int,
                  ground_pts: int, head_centers=None,
                  color_noise: float = COLOR_NOISE):
    """Returns (points, colors, head_id) with head_id 0 = ground; the same
    draws, in the same order, as the JAX generator. head_centers: optional
    (n_heads, 2) xy positions in place of uniform-random ones (adjacent
    heads on purpose). color_noise: the ground colours' stddev; the heads'
    is 0.8 of it."""
    pts, cols, hid = [], [], []
    g = np.stack([rng.uniform(-1.2, 1.2, ground_pts),
                  rng.uniform(-1.2, 1.2, ground_pts),
                  rng.normal(0.0, 0.02, ground_pts)], axis=1)
    pts.append(g)
    base = np.array([0.25, 0.45, 0.15])
    cols.append(base + rng.normal(0, color_noise, (ground_pts, 3)))
    hid.append(np.zeros(ground_pts, np.int32))
    for h in range(n_heads):
        if head_centers is not None:
            cx, cy = float(head_centers[h][0]), float(head_centers[h][1])
        else:
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


def _ring_cameras(n: int, radius: float, elev_deg,
                  center=(0.0, 0.0, 0.2)):
    """COLMAP (qvec, tvec) for n cameras on a ring looking at `center`
    (+z forward, +y down). elev_deg: one elevation, or one per ring row
    (row i // 12, as the FIP image names count)."""
    out = []
    center = np.asarray(center)
    elevs = (list(elev_deg) if isinstance(elev_deg, (list, tuple))
             else [elev_deg])
    for i in range(n):
        ang = 2 * np.pi * i / n
        elev = np.deg2rad(elevs[(i // 12) % len(elevs)])
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
              ground_pts: int = 900, seed: int = 0, head_centers=None,
              color_noise: float = COLOR_NOISE, knn: str = "exact",
              device="cpu"):
    """The generator's ground-truth scene: (rng, params dict of numpy
    GaussianParams fields, colors, head_id). Isotropic splats sized by the
    3-NN distance, opacity logit 4, SH degree 0 (colours are rendered as
    override colours). The rng is returned for the draws that follow.
    knn: "exact" (ops/knn.knn_mean_sq_dist), or "bfloat16", the distance
    JAX's generator computes on a TPU (knn_mean_sq_dist_bf16, run on
    `device`), where most splats of a dense plot get the 1e-4 floor."""
    rng = np.random.default_rng(seed)
    points, colors, head_id = _scene_points(rng, n_heads, pts_per_head,
                                            ground_pts, head_centers,
                                            color_noise)
    n = len(points)
    if knn == "exact":
        d2 = knn_mean_sq_dist(points)
    elif knn == "bfloat16":
        d2 = knn_mean_sq_dist_bf16(points, device=device)
    else:
        raise ValueError(f"knn {knn!r}: 'exact' or 'bfloat16'")
    dist = np.sqrt(np.maximum(d2, 1e-12))
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


def _build_gt_scene(width: int, height: int, n_cams: int, n_heads: int,
                    pts_per_head: int, ground_pts: int, seed: int, dev,
                    cam_radius: float, cam_elev_deg, head_centers,
                    color_noise: float = COLOR_NOISE, knn: str = "exact"):
    """The ground-truth scene shared by full synthesis and mask-only
    regeneration: (rng, params, colors, head_id, state, cameras, per-camera
    render arguments, focal length, raster config)."""
    from ..models.gaussians import GaussianParams, init_state
    from ..render.pipeline import RasterConfig, adapt_config, inference_config

    rng, params, colors, head_id = gt_params(n_heads, pts_per_head,
                                             ground_pts, seed, head_centers,
                                             color_noise, knn, dev)
    state = init_state(GaussianParams(**{
        k: torch.as_tensor(v, device=dev) for k, v in params.items()}),
        instance_id=head_id)
    fx = graphics.fov2focal(FOV, width)
    fovx = graphics.focal2fov(fx, width)
    fovy = graphics.focal2fov(fx, height)
    proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    cams = _ring_cameras(n_cams, radius=cam_radius, elev_deg=cam_elev_deg)
    args = [cam_args(q, t, proj, fovx, fovy, dev) for q, t in cams]
    config = adapt_config(state, args[0], width, height, inference_config(
        RasterConfig(max_tiles_per_gauss=32, max_per_tile=256,
                     tile_batch=16)), cams=args)
    return rng, params, colors, head_id, state, cams, args, fx, config


def _solidify_mask(mask: np.ndarray) -> np.ndarray:
    """Make a raw alpha > 0.5 instance region SAM-like: morphological
    closing, hole fill, largest connected component (real SAM emits one
    solid region per detection; the depth-resolved splat map is speckled at
    its boundaries)."""
    from scipy import ndimage

    m = ndimage.binary_closing(mask, structure=np.ones((3, 3)), iterations=2)
    m = ndimage.binary_fill_holes(m)
    lab, n = ndimage.label(m)
    if n > 1:
        sizes = ndimage.sum_labels(m, lab, index=np.arange(1, n + 1))
        m = lab == (1 + int(np.argmax(sizes)))
    return m


def _solidify_cropped(mask: np.ndarray) -> np.ndarray:
    """_solidify_mask of the whole image, computed on the mask's bounding
    box grown by 4 pixels: the closing reaches 2 pixels past the region and
    everything beyond stays background, so the result is the same. (Whole-
    image morphology per head and view would dominate the generator's time
    at full resolution.)"""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return mask
    y0, y1 = max(ys.min() - 4, 0), ys.max() + 5
    x0, x1 = max(xs.min() - 4, 0), xs.max() + 5
    out = np.zeros_like(mask)
    out[y0:y1, x0:x1] = _solidify_mask(mask[y0:y1, x0:x1])
    return out


def _write_view_masks(out_dir: str, image_name: str, state, n_heads: int,
                      args, width: int, height: int, config,
                      min_visibility: float = 0.35,
                      min_mask_frac: float = 6e-4) -> None:
    """Visible-surface per-head masks and bboxes for one view.

    Real SAM masks (reference README.md:36-45) cover only the visible
    surface of a head, so the masks come from one depth-resolved instance
    map (the reference eval_obj_labels rule: per pixel, the nearest head
    with alpha > 0.5 wins), solidified. Detector-visibility gate (a stand-in
    for YOLO's confidence threshold): a head's mask is written only when its
    visible area is >= min_visibility of its amodal footprint (the head
    rendered alone) and >= min_mask_frac of the image."""
    from PIL import Image

    from ..seg.eval import eval_obj_labels

    labels = torch.arange(n_heads + 1, device=state.device)
    obj_labels = labels[:, None] == state.instance_id[None, :]
    pred, amodal = eval_obj_labels(state, obj_labels, *args, width=width,
                                   height=height, config=config,
                                   with_areas=True)
    pred, amodal = pred.cpu().numpy(), amodal.cpu().numpy()
    min_px = max(12, int(min_mask_frac * width * height))
    boxes = []
    mask_k = 0
    for h in range(1, n_heads + 1):
        mask = _solidify_cropped(pred == h)
        vis = int(mask.sum())
        if vis < min_px or vis < min_visibility * max(int(amodal[h]), 1):
            continue
        ys, xs = np.where(mask)
        boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
        Image.fromarray((mask * 255).astype(np.uint8), mode="L").save(
            os.path.join(out_dir, "masks", f"{image_name}_{mask_k:03d}.png"))
        mask_k += 1
    _save_bboxes(os.path.join(out_dir, "bboxes", image_name + ".pt"),
                 np.asarray(boxes, np.float32).reshape(-1, 4))


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
    point_jitter: float = 0.02,
    with_masks: bool = True,
    cam_radius: float = 2.2,
    cam_elev_deg=40.0,
    head_centers=None,
    min_visibility: float = 0.35,
    min_mask_frac: float = 6e-4,
    color_noise: float = COLOR_NOISE,
    knn: str = "exact",
    device="cuda",
) -> dict:
    """Create the dataset on disk; returns a manifest dict. The COLMAP
    points3D are a subsample of the true points with N(0, point_jitter)
    noise. with_masks=False writes empty bbox files and no masks. The
    cameras sit on a ring of radius cam_radius at cam_elev_deg (one
    elevation, or one per ring row of 12); head_centers (n_heads, 2)
    places the heads; min_visibility / min_mask_frac gate each head's mask
    (_write_view_masks).
    color_noise and knn exist only to write the scenes JAX's generator
    wrote on a TPU, on which JAX's tables were measured; JAX's writer
    takes neither. color_noise is the per-point colour stddev
    (_scene_points): JAX's exp_bench2 table (docs/REPORT.md) was taken at
    commit 54bd0ea, when it was 0.05 (0.04 on the heads), and a later
    commit raised it to 0.15 and changed nothing else the scene depends
    on. knn="bfloat16" sizes the splats with the 3-NN distance as JAX's
    generator computes it on a TPU (gt_params); JAX's on a CPU is the
    exact one to float32 rounding. color_noise=0.05, knn="bfloat16" is the
    scene of JAX's exp_bench2 table; the defaults write JAX's writer's
    scene as a CPU computes it."""
    from PIL import Image

    from .. import resolve_device
    from ..render.pipeline import render_fwd
    from . import colmap

    dev = resolve_device(device)
    (rng, params, colors, head_id, state, cams, args, fx,
     config) = _build_gt_scene(width, height, n_cams, n_heads, pts_per_head,
                               ground_pts, seed, dev, cam_radius,
                               cam_elev_deg, head_centers, color_noise,
                               knn)
    n = len(colors)
    colors_cap = torch.zeros((state.capacity, 3), dtype=torch.float32,
                             device=dev)
    colors_cap[:n] = torch.as_tensor(colors, device=dev)

    for d in ("images", "masks", "bboxes"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)
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
        if with_masks:
            _write_view_masks(out_dir, name[:-4], state, n_heads, a, width,
                              height, config, min_visibility, min_mask_frac)
        else:
            _save_bboxes(os.path.join(out_dir, "bboxes", name[:-4] + ".pt"),
                         np.zeros((0, 4), np.float32))
        manifest["images"].append(name)

    colmap.write_intrinsics_binary(os.path.join(sparse, "cameras.bin"), intr)
    colmap.write_extrinsics_binary(os.path.join(sparse, "images.bin"), extr)
    sub = rng.choice(n, size=max(n // 2, 64), replace=False)
    noisy = params["means"][sub] + rng.normal(0, point_jitter, (len(sub), 3))
    colmap.write_points3D_binary(
        os.path.join(sparse, "points3D.bin"), noisy.astype(np.float64),
        (colors[sub] * 255).astype(np.uint8))
    np.savez_compressed(os.path.join(out_dir, "gt_points.npz"),
                        points=params["means"], head_id=head_id)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def regen_masks(
    out_dir: str,
    plot_id: int = 0,
    width: int = 160,
    height: int = 120,
    n_cams: int = 12,
    n_heads: int = 4,
    pts_per_head: int = 120,
    ground_pts: int = 900,
    seed: int = 0,
    cam_radius: float = 2.2,
    cam_elev_deg=40.0,
    head_centers=None,
    min_visibility: float = 0.35,
    min_mask_frac: float = 6e-4,
    device="cuda",
) -> None:
    """Rewrite masks/ and bboxes/ of an existing synthetic scene (the same
    parameters and seed give the same geometry and cameras) without
    rendering the images again."""
    from .. import resolve_device

    dev = resolve_device(device)
    (_, _, _, _, state, _, args, _,
     config) = _build_gt_scene(width, height, n_cams, n_heads, pts_per_head,
                               ground_pts, seed, dev, cam_radius,
                               cam_elev_deg, head_centers)
    for d in ("masks", "bboxes"):
        full = os.path.join(out_dir, d)
        if os.path.isdir(full):
            for f in os.listdir(full):
                os.remove(os.path.join(full, f))
        else:
            os.makedirs(full)
    for i, a in enumerate(args):
        _write_view_masks(out_dir, _image_name(plot_id, i, n_cams)[:-4],
                          state, n_heads, a, width, height, config,
                          min_visibility, min_mask_frac)


def _save_bboxes(path: str, boxes: np.ndarray) -> None:
    """YOLO-style boxes as a torch .pt tensor (the reference's format)."""
    torch.save(torch.from_numpy(boxes), path)


def load_bboxes(path: str) -> np.ndarray:
    """Counterpart of torch.load(cam.bbox_path) (run_3d_seg.py:137)."""
    return torch.load(path, weights_only=True).numpy()


def write_stand_in_model(model_dir: str, scene_dir: str, n_heads: int = 4,
                         pts_per_head: int = 120, ground_pts: int = 900,
                         seed: int = 0, iteration: int = 30_000,
                         device="cuda") -> int:
    """A stand-in "trained" SH-degree-3 model of the generator's scene
    (same arguments and seed): the ground-truth splats with sh_dc =
    rgb_to_sh(colours), seeded N(0, 0.05) f_rest and a seeded per-axis
    log-scale jitter N(0, 0.3) (anisotropic conics). Like a trained model
    it carries no head ids (which_object 0, so segmentation starts from
    none); splat i is point i of the scene's gt_points.npz, whose head_id
    scores a segmentation. Writes `point_cloud/iteration_<it>/
    point_cloud.ply` and `cfg_args` pointing at scene_dir; returns the splat
    count."""
    from .. import config as cfg
    from ..models.gaussians import state_from_numpy
    from ..models.serialization import save_ply
    from ..utils.sh import rgb_to_sh

    _, params, colors, _ = gt_params(n_heads, pts_per_head, ground_pts,
                                     seed)
    n = len(colors)
    rng = np.random.default_rng(seed + 1)
    params["sh_dc"] = rgb_to_sh(colors).astype(np.float32)
    params["sh_rest"] = rng.normal(0.0, 0.05, (n, 45)).astype(np.float32)
    params["log_scales"] = (params["log_scales"] + rng.normal(
        0.0, 0.3, (n, 3))).astype(np.float32)
    state = state_from_numpy(params, device=device)
    save_ply(state, os.path.join(model_dir, "point_cloud",
                                 f"iteration_{iteration}", "point_cloud.ply"))
    cfg.save_cfg_args(model_dir, cfg.ModelParams(source_path=scene_dir,
                                                 model_path=model_dir))
    return n
