"""EWA projection of 3D Gaussians to screen space (stage 1 of the rasterizer).

Counterpart of wheat3dgs_tpu/ops/projection.py, in torch, with the same
conventions (those of the reference CUDA `preprocess`):
- near-plane cull at view z <= 0.2;
- 2D covariance = J W Sigma W^T J^T with the t.x/t.z clamp at 1.3*tanfov,
  then +0.3 on the diagonal (screen-space dilation);
- radius = ceil(3 * sqrt(max eigenvalue)) in pixels;
- pixel coords via ndc2Pix: ((ndc + 1) * size - 1) / 2.
Every cull and `where` guard of the reference is kept, in the same order of
float32 operations, so the parity tests can hold radii exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import sh as sh_utils


class Splats2D(NamedTuple):
    """Screen-space Gaussians for one view. All tensors have leading dim N."""

    xy: torch.Tensor        # (N, 2) pixel-space center
    depth: torch.Tensor     # (N,) view-space z
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor    # (N,) int32 pixel radius, 0 = culled
    color: torch.Tensor     # (N, C) RGB (or label channels)
    opacity: torch.Tensor   # (N,) activated opacity in [0, 1]


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    w2c: torch.Tensor,
    full_proj: torch.Tensor,
    cam_center: torch.Tensor,
    tanfovx,
    tanfovy,
    width: int,
    height: int,
    sh: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    colors: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    ndc_offset: Optional[torch.Tensor] = None,
) -> Splats2D:
    """Project N Gaussians into one camera.

    means3d (N, 3); scales (N, 3) activated; quats (N, 4) unnormalized;
    opacities (N,) activated; w2c / full_proj (4, 4) acting on column
    vectors; sh (N, 3K) flat coefficients (used when `colors` is None);
    colors (N, C) precomputed colours (label rendering path); ndc_offset
    (N, 2) zeros whose gradient is the CUDA rasterizer's viewspace-point
    gradient (dL/d_ndc, with the 0.5 * W pixel scale), which densification
    accumulates. Every guard keeps the autograd partials finite on culled
    and dead slots (zero quats, points at the camera centre or behind it).
    Returns Splats2D with radius == 0 where culled.
    """
    n = means3d.shape[0]
    ones = torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)
    hom = torch.cat([means3d, ones], dim=1)                  # (N, 4)

    t = hom @ w2c.T                                          # view space
    depth = t[:, 2]
    in_front = depth > 0.2

    p_hom = hom @ full_proj.T                                # clip space
    # Culled points route their reciprocals through 1.0 (no inf/NaN).
    w_safe = torch.where(in_front, p_hom[:, 3] + 1e-7,
                         torch.ones_like(depth))
    p_w = 1.0 / w_safe
    ndc = p_hom[:, :2] * p_w[:, None]                        # (N, 2)
    if ndc_offset is not None:
        ndc = ndc + ndc_offset
    xy = torch.stack(
        [((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
         ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], dim=1)

    tanfovx = torch.as_tensor(tanfovx, dtype=torch.float32,
                              device=means3d.device)
    tanfovy = torch.as_tensor(tanfovy, dtype=torch.float32,
                              device=means3d.device)
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    # EWA: J W Sigma W^T J^T with frustum-clamped t.
    lim_x = 1.3 * tanfovx
    lim_y = 1.3 * tanfovy
    tz = torch.where(in_front, depth, torch.ones_like(depth))
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -lim_x), lim_x) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -lim_y), lim_y) * tz

    # 2D covariance in the reference's expanded scalar form:
    # cov3d = M M^T with M = R diag(s); cov2d = V V^T with V = (J W) M.
    W = w2c[:3, :3]
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    # Exactly-zero quats (dead capacity slots) take the identity quat.
    q_sq = torch.sum(quats * quats, dim=1, keepdim=True)
    unit_w = torch.zeros_like(quats)
    unit_w[:, 0] = 1.0
    q_safe = torch.where(q_sq > 0.0, quats, unit_w)
    qn = q_safe / torch.linalg.vector_norm(q_safe, dim=1, keepdim=True)
    qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    sx_, sy_, sz_ = (scales[:, 0] * scale_modifier,
                     scales[:, 1] * scale_modifier,
                     scales[:, 2] * scale_modifier)
    # M[k][i] = R[k][i] * s_i (rotation rows scaled per column).
    m = [[(1.0 - 2.0 * (qy * qy + qz * qz)) * sx_,
          2.0 * (qx * qy - qw * qz) * sy_,
          2.0 * (qx * qz + qw * qy) * sz_],
         [2.0 * (qx * qy + qw * qz) * sx_,
          (1.0 - 2.0 * (qx * qx + qz * qz)) * sy_,
          2.0 * (qy * qz - qw * qx) * sz_],
         [2.0 * (qx * qz - qw * qy) * sx_,
          2.0 * (qy * qz + qw * qx) * sy_,
          (1.0 - 2.0 * (qx * qx + qy * qy)) * sz_]]
    # T[a][k] = (J W)[a][k]; J rows [fx/tz, 0, -fx tx/tz^2] and
    # [0, fy/tz, -fy ty/tz^2]; W entries are per-camera scalars.
    gx = focal_x * inv_tz
    gy = focal_y * inv_tz
    hx = focal_x * tx * inv_tz2
    hy = focal_y * ty * inv_tz2
    t_row = [[gx * W[0, k] - hx * W[2, k] for k in range(3)],
             [gy * W[1, k] - hy * W[2, k] for k in range(3)]]
    # V[a][i] = sum_k T[a][k] M[k][i]
    v = [[t_row[a][0] * m[0][i] + t_row[a][1] * m[1][i]
          + t_row[a][2] * m[2][i] for i in range(3)] for a in range(2)]
    a = v[0][0] * v[0][0] + v[0][1] * v[0][1] + v[0][2] * v[0][2] + 0.3
    b = v[0][0] * v[1][0] + v[0][1] * v[1][1] + v[0][2] * v[1][2]
    c = v[1][0] * v[1][0] + v[1][1] * v[1][1] + v[1][2] * v[1][2] + 0.3

    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    # Visibility: in front, invertible cov, and touching the image.
    visible = in_front & det_ok
    visible &= (xy[:, 0] + radius_f > 0) & (xy[:, 0] - radius_f < width)
    visible &= (xy[:, 1] + radius_f > 0) & (xy[:, 1] - radius_f < height)
    visible &= opacities > (1.0 / 255.0)
    radius = torch.where(visible, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    if colors is None:
        if sh is None:
            raise ValueError("either sh or colors must be given")
        dirs = means3d - cam_center[None, :]
        d_sq = torch.sum(dirs * dirs, dim=1, keepdim=True)
        dirs = torch.where(d_sq > 0.0, dirs, torch.ones_like(dirs))
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
                       + 1e-9)
        color = sh_utils.sh_to_rgb(sh_degree, sh, dirs)
    else:
        color = colors

    return Splats2D(xy=xy, depth=depth, conic=conic, radius=radius,
                    color=color, opacity=opacities)
