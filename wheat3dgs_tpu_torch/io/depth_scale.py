"""Per-image mono-depth alignment scales (reference:
wheat3dgsviewer/utils/make_depth_scale.py).

A numpy copy of wheat3dgs_tpu/io/depth_scale.py. For each image, align an
inverse mono-depth map to COLMAP's sparse inverse depths with a robust
median/MAD fit: invcolmap ~ scale * invmono + offset. Writes
sparse/0/depth_params.json. Needs per-image 16-bit inverse-depth PNGs
(e.g. from DepthAnything) in depths_dir:

    python -m wheat3dgs_tpu_torch.io.depth_scale --base_dir <scene> \
        --depths_dir <dir of PNGs>
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.graphics import qvec_to_rotmat
from . import colmap


def _scales_for_image(meta, cam, points3d_ordered, depths_dir):
    mask = (meta.point3D_ids >= 0) & (meta.point3D_ids
                                      < len(points3d_ordered))
    pts_idx = meta.point3D_ids[mask]
    xys = meta.xys[mask]
    if len(pts_idx) == 0:
        return None
    pts = points3d_ordered[pts_idx]
    R = qvec_to_rotmat(meta.qvec)
    cam_pts = pts @ R.T + meta.tvec
    inv_colmap = 1.0 / cam_pts[..., 2]

    stem = os.path.splitext(meta.name)[0]
    path = os.path.join(depths_dir, stem + ".png")
    if not os.path.exists(path):
        return None
    from PIL import Image

    inv_mono_map = np.asarray(Image.open(path)).astype(np.float32)
    if inv_mono_map.ndim != 2:
        inv_mono_map = inv_mono_map[..., 0]
    inv_mono_map /= 2 ** 16
    s = inv_mono_map.shape[0] / cam.height

    uv = (xys * s).astype(np.float32)
    valid = ((uv[..., 0] >= 0) & (uv[..., 1] >= 0)
             & (uv[..., 0] < cam.width * s) & (uv[..., 1] < cam.height * s)
             & (inv_colmap > 0))
    if valid.sum() > 10 and np.ptp(inv_colmap) > 1e-3:
        uv = uv[valid]
        ic = inv_colmap[valid]
        # bilinear sample of the mono inverse-depth at the track locations
        x0 = np.clip(uv[:, 0].astype(int), 0, inv_mono_map.shape[1] - 2)
        y0 = np.clip(uv[:, 1].astype(int), 0, inv_mono_map.shape[0] - 2)
        fx = np.clip(uv[:, 0] - x0, 0, 1)
        fy = np.clip(uv[:, 1] - y0, 0, 1)
        im = ((1 - fy) * ((1 - fx) * inv_mono_map[y0, x0]
                          + fx * inv_mono_map[y0, x0 + 1])
              + fy * ((1 - fx) * inv_mono_map[y0 + 1, x0]
                      + fx * inv_mono_map[y0 + 1, x0 + 1]))
        t_c = np.median(ic)
        s_c = np.mean(np.abs(ic - t_c))
        t_m = np.median(im)
        s_m = np.mean(np.abs(im - t_m))
        scale = s_c / s_m if s_m > 0 else 0.0
        offset = t_c - t_m * scale
    else:
        scale, offset = 0.0, 0.0
    return {"image_name": stem, "scale": float(scale),
            "offset": float(offset)}


def make_depth_scales(base_dir: str, depths_dir: str) -> dict:
    sparse = os.path.join(base_dir, "sparse", "0")
    intr, extr, points = colmap.load_colmap_model(sparse)
    xyz, _, _ = points
    # points3D ids are 1-based sequential from our writer; reference handles
    # arbitrary ids — rebuild an id-ordered table the same way.
    points3d_ordered = np.zeros((len(xyz) + 1, 3))
    points3d_ordered[1:] = xyz

    with ThreadPoolExecutor() as ex:
        results = list(ex.map(
            lambda m: _scales_for_image(m, intr[m.camera_id],
                                        points3d_ordered, depths_dir),
            extr.values()))
    params = {r["image_name"]: {"scale": r["scale"], "offset": r["offset"]}
              for r in results if r is not None}
    out = os.path.join(sparse, "depth_params.json")
    with open(out, "w") as f:
        json.dump(params, f, indent=2)
    return params


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--depths_dir", required=True)
    a = p.parse_args(argv)
    params = make_depth_scales(a.base_dir, a.depths_dir)
    print(f"wrote depth params for {len(params)} images")


if __name__ == "__main__":
    main()
