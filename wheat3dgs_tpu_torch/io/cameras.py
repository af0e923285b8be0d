"""Cameras as batched tensors (reference: scene/cameras.py,
utils/camera_utils.py).

Counterpart of wheat3dgs_tpu/io/cameras.py: a scene's cameras are one set
of stacked tensors on the chosen device (`Cameras`); host-only metadata
lives in `CameraMeta`. znear=0.01, zfar=100; matrices act on column vectors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import graphics

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of pinhole cameras (all the same resolution); every tensor
    has a leading batch dim B."""

    w2c: torch.Tensor          # (B, 4, 4) world->camera
    full_proj: torch.Tensor    # (B, 4, 4) proj @ w2c
    cam_center: torch.Tensor   # (B, 3)
    tanfovx: torch.Tensor      # (B,)
    tanfovy: torch.Tensor      # (B,)
    width: int
    height: int


@dataclasses.dataclass
class CameraMeta:
    """Host-side per-view metadata."""

    uid: int
    colmap_id: int
    image_name: str
    image_path: Optional[str] = None
    bbox_path: Optional[str] = None
    mask_paths: Optional[List[str]] = None
    resolution_scale: float = 1.0
    R: Optional[np.ndarray] = None  # C2W rotation (COLMAP R^T), for JSON export
    T: Optional[np.ndarray] = None
    fovx: float = 0.0
    fovy: float = 0.0


def make_camera(R_c2w: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                translate: np.ndarray | None = None, scale: float = 1.0,
                device="cuda") -> Cameras:
    """A single-view Cameras batch (B = 1) from a COLMAP-style pose."""
    return make_camera_batch([R_c2w], [t], [fovx], [fovy], width, height,
                             translate=translate, scale=scale, device=device)


def make_camera_batch(Rs: Sequence[np.ndarray], ts: Sequence[np.ndarray],
                      fovxs: Sequence[float], fovys: Sequence[float],
                      width: int, height: int,
                      translate: np.ndarray | None = None,
                      scale: float = 1.0, device="cuda") -> Cameras:
    """Cameras from COLMAP-style poses (C2W rotation + COLMAP translation;
    the camera centre optionally shifted by `translate` and scaled),
    built in float64 numpy exactly as the JAX package does, then moved to
    `device` as float32."""
    B = len(Rs)
    w2c = np.zeros((B, 4, 4), dtype=np.float32)
    fp = np.zeros((B, 4, 4), dtype=np.float32)
    centers = np.zeros((B, 3), dtype=np.float32)
    tanx = np.zeros((B,), dtype=np.float32)
    tany = np.zeros((B,), dtype=np.float32)
    for i in range(B):
        m = graphics.world_to_view(Rs[i], ts[i], translate=translate,
                                   scale=scale)
        P = graphics.projection_matrix(ZNEAR, ZFAR, fovxs[i], fovys[i])
        w2c[i] = m.astype(np.float32)
        fp[i] = (P @ m).astype(np.float32)
        centers[i] = np.linalg.inv(m)[:3, 3].astype(np.float32)
        tanx[i] = math.tan(fovxs[i] * 0.5)
        tany[i] = math.tan(fovys[i] * 0.5)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return Cameras(w2c=dev(w2c), full_proj=dev(fp), cam_center=dev(centers),
                   tanfovx=dev(tanx), tanfovy=dev(tany), width=int(width),
                   height=int(height))


def make_camera_from_c2w(c2w: np.ndarray, fovx: float, fovy: float,
                         width: int, height: int, device="cuda") -> Cameras:
    """Camera from a camera-to-world matrix (synthetic and trajectory
    views, reference MiniCam, scene/cameras.py:100-111)."""
    w2c = np.linalg.inv(np.asarray(c2w, dtype=np.float64))
    R_c2w = w2c[:3, :3].T  # the reference keeps the transposed rotation
    return make_camera(R_c2w, w2c[:3, 3], fovx, fovy, width, height,
                       device=device)


def concat_cameras(cams: Sequence[Cameras]) -> Cameras:
    """One batch of several same-size batches, in order."""
    if any(c.width != cams[0].width or c.height != cams[0].height
           for c in cams):
        raise ValueError("concat_cameras: batches of different sizes")
    return Cameras(
        *(torch.cat([getattr(c, f) for c in cams])
          for f in ("w2c", "full_proj", "cam_center", "tanfovx", "tanfovy")),
        width=cams[0].width, height=cams[0].height)


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0,
                       _warned=[False]) -> tuple:
    """Resolution policy (reference: utils/camera_utils.py:22-40).

    Returns ((w, h), total_scale). -1 auto-downscales >1.6K-wide images.
    """
    if resolution in (1, 2, 4, 8):
        res = (round(orig_w / (resolution_scale * resolution)),
               round(orig_h / (resolution_scale * resolution)))
        scale = float(resolution_scale) * float(resolution)
        return res, scale
    if resolution == -1:
        if orig_w > 1600:
            if not _warned[0]:
                print("[ INFO ] Large input images (>1.6K width); rescaling "
                      "to 1.6K. Use --resolution 1 to disable.")
                _warned[0] = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return (int(orig_w / scale), int(orig_h / scale)), scale


def camera_to_json(uid: int, meta: CameraMeta, width: int,
                   height: int) -> dict:
    """Serialize for cameras.json (reference: utils/camera_utils.py:64-84)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = meta.R.transpose()
    Rt[:3, 3] = meta.T
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    return {
        "id": uid,
        "img_name": meta.image_name,
        "width": width,
        "height": height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fy": graphics.fov2focal(meta.fovy, height),
        "fx": graphics.fov2focal(meta.fovx, width),
    }
