"""Synthetic camera trajectories: 360° orbits + slerp interpolation
(reference: utils/wheatgs_helper.py:176-241).

Counterpart of wheat3dgs_tpu/render/camera_paths.py, in numpy on the
port's utils/graphics.py; the renderers take the stacked arrays as
tensors."""

from __future__ import annotations

import numpy as np

from ..utils import graphics


def c2w_from_up_and_look_at(up: np.ndarray, look_at: np.ndarray,
                            pos: np.ndarray) -> np.ndarray:
    """3x4 camera-to-world with +z forward, y = -up (gsgen convention,
    reference :217-230)."""
    up = up / np.linalg.norm(up)
    z = look_at - pos
    z = z / np.linalg.norm(z)
    y = -up
    x = np.cross(y, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.zeros((3, 4), np.float32)
    c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = x, y, z, pos
    return c2w


def camera_path_fixed_elevation(n_frames: int, n_circles: int = 1,
                                camera_distance: float = 2.0,
                                cam_center=(0, 0, 0),
                                elevation: float = 0.0) -> np.ndarray:
    """(n_frames, 3, 4) c2w orbit at fixed elevation (reference :232-241)."""
    azimuth = np.linspace(0, 2 * np.pi * n_circles, n_frames)
    el = np.deg2rad(elevation)
    pos = np.stack([camera_distance * np.cos(azimuth) * np.cos(el),
                    camera_distance * np.sin(azimuth) * np.cos(el),
                    camera_distance * np.sin(el) * np.ones_like(azimuth)], 1)
    pos = pos + np.asarray(cam_center, np.float64)[None]
    up = np.array([0, 0, 1], np.float32)
    look = np.asarray(cam_center, np.float32)
    return np.stack([c2w_from_up_and_look_at(up, look, p) for p in pos])


def c2ws_to_camera_arrays(c2ws: np.ndarray, fovx: float, fovy: float,
                          znear: float = 0.01, zfar: float = 100.0):
    """(F, 3, 4) c2w -> stacked (w2c, full_proj, cam_center, tanfovx, tanfovy)
    numpy arrays, one row per frame."""
    proj = graphics.projection_matrix(znear, zfar, fovx, fovy)
    w2cs, fps, ccs = [], [], []
    for c2w in c2ws:
        m = np.vstack([c2w, [0, 0, 0, 1.0]])
        w2c = np.linalg.inv(np.float64(m))
        w2cs.append(w2c.astype(np.float32))
        fps.append((proj @ w2c).astype(np.float32))
        ccs.append(m[:3, 3].astype(np.float32))
    f = len(c2ws)
    tfx = np.full(f, np.tan(fovx / 2), np.float32)
    tfy = np.full(f, np.tan(fovy / 2), np.float32)
    return (np.stack(w2cs), np.stack(fps), np.stack(ccs), tfx, tfy)


def interpolate_viewpoints(R1, T1, R2, T2, fovx, fovy, n: int = 100):
    """Slerp camera interpolation between two (R_c2w, T) COLMAP poses
    (reference get_interpolated_viewpts, :176-208)."""
    from scipy.spatial.transform import Rotation, Slerp

    q1 = graphics.rotmat_to_qvec(R1.T)
    q2 = graphics.rotmat_to_qvec(R2.T)
    c1 = -R1 @ T1
    c2 = -R2 @ T2
    # scipy quats are (x, y, z, w); ours (w, x, y, z).
    rots = Rotation.from_quat([np.r_[q1[1:], q1[0]], np.r_[q2[1:], q2[0]]])
    slerp = Slerp([0, 1], rots)
    ts = np.linspace(0, 1, n)
    out = []
    for t, rot in zip(ts, slerp(ts)):
        c = (1 - t) * c1 + t * c2
        R_w2c = rot.as_matrix().T
        w2c = np.eye(4)
        w2c[:3, :3] = R_w2c
        w2c[:3, 3] = -R_w2c @ c
        out.append(w2c.astype(np.float32))
    return np.stack(out)
