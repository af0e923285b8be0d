"""Naive O(N * pixels) rasterizer: the golden model for the tiled paths.

Counterpart of wheat3dgs_tpu/ops/reference_raster.py. Composites every
Gaussian at every pixel with the front-to-back semantics of the CUDA
renderCUDA loop of the reference's diff-gaussian-rasterization fork (alpha
clamped at 0.99, alpha below 1/255 skipped, stop when transmittance would
drop below 1e-4; the constants live in ops/raster.py). Only usable on tiny
scenes; the padded-tile rasterizer (ops/raster.py::rasterize) must agree
with it up to float summation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from .binning import tile_rect
from .projection import Splats2D
from .raster import ALPHA_MAX, ALPHA_MIN, T_EPS


def composite_pixels(pix_xy: torch.Tensor, splats: Splats2D,
                     bg: torch.Tensor, tile_grid=None) -> dict:
    """Composite depth-sorted splats at arbitrary pixel centres.

    pix_xy: (P, 2) pixel coordinates; splats: one view's Splats2D (N
    splats, any visibility); bg: (C,). tile_grid: optional (tiles_x,
    tiles_y, tile): a splat then shades only the pixels whose tile lies in
    its covered tile rectangle, as the CUDA tile binning cuts a Gaussian's
    tail at tile granularity.

    Returns a dict with color (P, C), depth (P,), alpha (P,), n_contrib
    (P,), weights (P, N) in the sorted order, the sort order and t_final.
    """
    order = torch.argsort(splats.depth, stable=True)
    xy = splats.xy[order]
    conic = splats.conic[order]
    color = splats.color[order]
    opac = splats.opacity[order]
    radius = splats.radius[order]
    depth = splats.depth[order]

    d = pix_xy[:, None, :] - xy[None, :, :]                    # (P, N, 2)
    power = (-0.5 * (conic[None, :, 0] * d[..., 0] ** 2
                     + conic[None, :, 2] * d[..., 1] ** 2)
             - conic[None, :, 1] * d[..., 0] * d[..., 1])      # (P, N)
    alpha = torch.clamp(opac[None, :] * torch.exp(power), max=ALPHA_MAX)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(power > 0.0, zero, alpha)
    alpha = torch.where(alpha < ALPHA_MIN, zero, alpha)
    alpha = torch.where(radius[None, :] > 0, alpha, zero)
    if tile_grid is not None:
        tiles_x, tiles_y, tile = tile_grid
        rx0, ry0, rx1, ry1 = tile_rect(xy, radius.to(xy.dtype), tiles_x,
                                       tiles_y, tile)
        ptx = torch.div(pix_xy[:, 0], tile, rounding_mode="floor").to(
            torch.int32)
        pty = torch.div(pix_xy[:, 1], tile, rounding_mode="floor").to(
            torch.int32)
        in_rect = ((ptx[:, None] >= rx0[None, :])
                   & (ptx[:, None] < rx1[None, :])
                   & (pty[:, None] >= ry0[None, :])
                   & (pty[:, None] < ry1[None, :]))
        alpha = torch.where(in_rect, alpha, zero)

    one_minus = 1.0 - alpha
    t_after = torch.cumprod(one_minus, dim=1)                  # (P, N)
    include = t_after >= T_EPS                                 # CUDA stop
    t_before = t_after / torch.where(one_minus == 0.0,
                                     torch.ones_like(one_minus), one_minus)
    weights = torch.where(include, alpha * t_before, zero)     # (P, N)

    # include is a prefix mask (t_after never rises), so the final
    # transmittance is t_after at the last included position: the min.
    ones = torch.ones_like(t_after)
    t_final = torch.where(include.any(dim=1),
                          torch.where(include, t_after, ones).amin(dim=1),
                          ones[:, 0])
    out_color = weights @ color + t_final[:, None] * bg[None, :]
    out_depth = weights @ depth
    out_alpha = weights.sum(dim=1)
    n_contrib = (weights > 0).sum(dim=1)
    return {"color": out_color, "depth": out_depth, "alpha": out_alpha,
            "n_contrib": n_contrib, "weights": weights, "order": order,
            "t_final": t_final}


def rasterize_naive(splats: Splats2D, width: int, height: int,
                    bg: Optional[torch.Tensor] = None,
                    tile: int = 16) -> dict:
    """Full-image naive rasterization with the CUDA tile-rect cut-off.
    Returns (C, H, W) color and (H, W) depth / alpha / n_contrib."""
    dev = splats.xy.device
    if bg is None:
        bg = torch.zeros((splats.color.shape[1],), dtype=splats.color.dtype,
                         device=dev)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)  # (H*W, 2)
    tile_grid = (-(-width // tile), -(-height // tile), tile)
    out = composite_pixels(pix, splats, bg, tile_grid=tile_grid)
    c = splats.color.shape[1]
    return {
        "color": out["color"].reshape(height, width, c).permute(2, 0, 1),
        "depth": out["depth"].reshape(height, width),
        "alpha": out["alpha"].reshape(height, width),
        "n_contrib": out["n_contrib"].reshape(height, width),
    }
