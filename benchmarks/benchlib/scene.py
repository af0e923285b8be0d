"""The benchmark's wheat plots, made in memory from a seed.

A frozen copy of the synthetic wheat-plot generator's geometry (ground
plane and ellipsoidal heads on a 2.4 x 2.4 plot, cameras on rings looking
at its centre, the FIP split: camera label > 10 is a test view), drawn on
the device with a torch.Generator from the configuration's `scene.seed`:
every run trains the same plots from the same start, and the run's seed
draws only the order of the views and the split noise (drive.py), so
every seed does the same work in another order. The ground-truth images are rendered
with the plain reference (`reference.raster`, splats sized by their 3-NN
distance, opacity logit 4, override colours) and quantised to 8 bits, as
a PNG would hold them. The initial point cloud is a random half of the
true points with N(0, point_jitter) noise and 8-bit colours, as a COLMAP
points3D would hold them. Unlike the generator, colours are clipped to
[1/255, 1], not [0, 1] (see `_points`). Nothing is written to disk.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from reference.raster import Camera, render
from reference.step import knn_mean_sq_dist

ZNEAR, ZFAR = 0.01, 100.0
GROUND_RGB = (0.25, 0.45, 0.15)
HEAD_RGB = (0.8, 0.7, 0.3)
COLOR_FLOOR = 1.0 / 255.0


class Plot(NamedTuple):
    """One plot's inputs: the initial point cloud (host numpy), the train
    cameras (for the reference, and stacked on the device for the
    program), the ground-truth images (V, 3, H, W) on the device and the
    scene extent (1.1 x the train cameras' largest distance from their
    mean)."""

    points: np.ndarray
    colors: np.ndarray
    cams: List[Camera]
    cam_stack: tuple
    gt: torch.Tensor
    extent: float
    width: int
    height: int


def plot_seed(seed: int, plot: int) -> int:
    """The generator seed of plot `plot` of a run seeded `seed`."""
    return (int(seed) * 1_000_003 + plot) % (1 << 63)


def _points(gen: torch.Generator, s: dict, dev):
    """(points, colours) of the true scene: ground points, then each head's
    points along its tilted axis."""
    g, h, k = s["ground_pts"], s["n_heads"], s["pts_per_head"]
    noise = s["color_noise"]

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def nrm(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    ground = torch.cat([uni((g, 2), -1.2, 1.2), nrm((g, 1), 0.02)], dim=1)
    centers = torch.cat([uni((h, 2), -0.8, 0.8), uni((h, 1), 0.35, 0.55)], 1)
    axis = nrm((h, 3), 0.08) + torch.tensor([0.0, 0.0, 1.0], device=dev)
    axis = axis / torch.linalg.vector_norm(axis, dim=1, keepdim=True)
    t = nrm((h, k, 1), 1.0)
    heads = centers[:, None] + axis[:, None] * (t * 0.09) + nrm((h, k, 3),
                                                                0.025)
    cols = torch.cat([
        torch.tensor(GROUND_RGB, device=dev) + nrm((g, 3), noise),
        (torch.tensor(HEAD_RGB, device=dev) + nrm((h * k, 3), noise * 0.8))])
    # Colours keep a floor of 1/255: an initial colour of exactly 0 puts
    # the SH colour (0.5 + C0 * (0 - 0.5) / C0) on the SH clamp's kink,
    # where the last bit of the division decides whether a gradient
    # passes (PERF.md).
    return (torch.cat([ground, heads.reshape(-1, 3)]),
            torch.clamp(cols, COLOR_FLOOR, 1.0))


def ring_cameras(s: dict, dev):
    """Every camera of the ring(s) as (w2c, full_proj, centre, tanfovx,
    tanfovy) in float64 numpy, and the indices of the train views."""
    w, h, n = s["width"], s["height"], s["n_cams"]
    elevs = s["cam_elev_deg"]
    fx = w / (2.0 * math.tan(s["fov_x"] / 2.0))
    fovx = 2.0 * math.atan(w / (2.0 * fx))
    fovy = 2.0 * math.atan(h / (2.0 * fx))
    tx, ty = math.tan(fovx * 0.5), math.tan(fovy * 0.5)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tx, 1.0 / ty
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    proj[3, 2] = 1.0
    center = np.array([0.0, 0.0, 0.2])
    cams, train = [], []
    for i in range(n):
        ang = 2 * math.pi * i / n
        el = math.radians(elevs[(i // 12) % len(elevs)])
        eye = center + s["cam_radius"] * np.array(
            [math.cos(ang) * math.cos(el), math.sin(ang) * math.cos(el),
             math.sin(el)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 0.0, -1.0])
        right /= np.linalg.norm(right)
        down = -np.cross(fwd, right)
        down /= np.linalg.norm(down)
        rot = np.stack([right, down, fwd])
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = rot, -rot @ eye
        cams.append((w2c, proj @ w2c, eye, tx, ty))
        if (i % 12) + 1 <= s["test_label_above"]:
            train.append(i)
    return cams, train


def make_plot(s: dict, seed: int, dev) -> Plot:
    """Plot inputs from the config's `scene` settings and a seed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pts, cols = _points(gen, s, dev)
    n = pts.shape[0]
    d2 = knn_mean_sq_dist(pts)
    log_s = torch.log(torch.clamp(torch.sqrt(torch.clamp(d2, min=1e-12))
                                  * s["gt_splat_scale"], 1e-4, 0.1))
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1.0
    truth = {"means": pts, "quats": quats,
             "log_scales": log_s[:, None].repeat(1, 3),
             "opacity_logit": torch.full((n,), s["gt_opacity_logit"],
                                         device=dev)}
    all_cams, train = ring_cameras(s, dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cams = [Camera(f32(c[0]), f32(c[1]), f32(c[2]), float(np.float32(c[3])),
                   float(np.float32(c[4]))) for c in (all_cams[i]
                                                      for i in train)]
    w, h = s["width"], s["height"]
    gt = torch.empty((len(cams), 3, h, w), device=dev)
    with torch.no_grad():
        for v, cam in enumerate(cams):
            img = render(truth, cam, w, h, 0, colors=cols).image
            gt[v] = torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0) / 255.0
    keep = torch.randperm(n, generator=gen, device=dev)[
        :int(n * s["init_fraction"])]
    init = pts[keep] + torch.randn((len(keep), 3), generator=gen,
                                   device=dev) * s["point_jitter"]
    init_cols = torch.clamp(torch.floor(cols[keep] * 255.0) / 255.0,
                            min=COLOR_FLOOR)
    stack = (torch.stack([c.w2c for c in cams]),
             torch.stack([c.full_proj for c in cams]),
             torch.stack([c.center for c in cams]),
             f32([c.tanfovx for c in cams]), f32([c.tanfovy for c in cams]))
    centers = np.stack([all_cams[i][2] for i in train])
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(0),
                                        axis=1).max())
    return Plot(init.cpu().numpy(), init_cols.cpu().numpy(), cams, stack,
                gt, extent, w, h)
