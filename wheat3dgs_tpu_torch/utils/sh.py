"""Real spherical harmonics, degrees 0-3 (reference: utils/sh_utils.py), in
torch, for the FLAT coefficient-major layout (..., 3K) = [k0_rgb, k1_rgb,
...] that GaussianState stores (models/gaussians.py).

Counterpart of wheat3dgs_tpu/utils/sh.py (`sh_basis`, `eval_sh_flat`,
`sh_to_rgb`, `rgb_to_sh`); the same term order keeps float32 sums in step.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def num_sh_bands(deg: int) -> int:
    return (deg + 1) ** 2


def sh_basis(deg: int, dirs: torch.Tensor) -> list:
    """The K = (deg+1)^2 real-SH basis values at unit `dirs` (..., 3), as a
    list of (..., 1) tensors (band 0 first, 3DGS ordering)."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} outside 0..3")
    out = [C0 * torch.ones_like(dirs[..., 0:1])]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        out += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                    C2[3] * xz, C2[4] * (xx - yy)]
            if deg > 2:
                out += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                        C3[2] * y * (4 * zz - xx - yy),
                        C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                        C3[4] * x * (4 * zz - xx - yy),
                        C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
    return out


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH evaluated at unit `dirs` (..., 3) from flat coefficients (..., 3K),
    K >= (deg+1)^2; bands above deg are ignored. No +0.5 shift."""
    result = None
    for k, b in enumerate(sh_basis(deg, dirs)):
        term = b * sh[..., 3 * k:3 * k + 3]
        result = term if result is None else result + term
    return result


def sh_to_rgb(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> RGB as the 3DGS rasterizer does: eval + 0.5, clamped at 0."""
    return torch.clamp(eval_sh(deg, sh, dirs) + 0.5, min=0.0)


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb_dc(sh):
    return sh * C0 + 0.5
