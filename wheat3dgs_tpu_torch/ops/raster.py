"""The padded-tile differentiable rasterizer, the raster output type and
the compositing constants.

Counterpart of wheat3dgs_tpu/ops/raster.py (JAX's "xla" backend) and of
the renderCUDA constants in wheat3dgs_tpu/ops/reference_raster.py: alpha
clamped at 0.99, alpha floor 1/255, compositing stops when transmittance
would fall below 1e-4.

`rasterize` composites the dense per-tile lists of ops/binning.py's
`bin_splats` in plain torch ops: for a batch of `tile_batch` tiles it
gathers each tile's K packed splat rows, computes the (pixels, K) alphas,
the front-to-back transmittance as exp of a cumulative sum of
log(1 - alpha), and the (pixels, K) @ (K, C + 1) product of the blending
weights with colour and depth. Autograd differentiates all of it in float32
(the port's second, independently derived differentiable renderer, beside
the entry stream's hand-written backward in ops/cuda_raster.py). With
remat each batch runs under torch.utils.checkpoint, so the backward
recomputes the (pixels, K) matrices instead of storing them for the whole
frame. On a CUDA tensor every op runs on the card; nothing reads the host,
so a CUDA graph can capture a training step on this path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .binning import TILE, TileBins, bin_splats, num_tiles
from .projection import Splats2D

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class RasterOut(NamedTuple):
    color: Optional[torch.Tensor]   # (C, H, W), None if not composited
    depth: Optional[torch.Tensor]   # (H, W) alpha-weighted view depth
    alpha: torch.Tensor             # (H, W) accumulated weight sum
    radii: torch.Tensor             # (N,) int32 screen radius (0 = culled)
    # Entry-stream telemetry (None on the padded-tile path): allocation
    # demand (sum of covered-rect areas) and post-cull entry count.
    # demand > entry_budget means entries were cropped this call.
    entries_total: Optional[torch.Tensor] = None   # 0-d int
    entries_alive: Optional[torch.Tensor] = None   # 0-d int


def pack_splats(splats: Splats2D) -> torch.Tensor:
    """(N, 8 + C): xy(2) conic(3) opacity(1) depth(1) pad(1) color(C)."""
    n = splats.xy.shape[0]
    return torch.cat(
        [splats.xy, splats.conic, splats.opacity[:, None],
         splats.depth[:, None],
         torch.zeros((n, 1), dtype=splats.xy.dtype, device=splats.xy.device),
         splats.color], dim=1)


def _tile_pixel_grid(tile: int, device=None) -> torch.Tensor:
    """(tile * tile, 2) float32 pixel offsets (x, y) of a tile, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(tile, dtype=torch.float32, device=device),
        torch.arange(tile, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)


def tile_alpha(pix: torch.Tensor, p: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(..., P, K) alphas of packed rows p (..., K, 8 + C) at pixels pix
    (..., P, 2) (renderCUDA's rules: 0.99 clamp, zero where power > 0 or
    alpha < 1/255); valid (..., K) masks padding rows."""
    d = pix[..., :, None, :] - p[..., None, :, 0:2]
    power = (-0.5 * (p[..., None, :, 2] * d[..., 0] ** 2
                     + p[..., None, :, 4] * d[..., 1] ** 2)
             - p[..., None, :, 3] * d[..., 0] * d[..., 1])
    alpha = torch.clamp(p[..., None, :, 5] * torch.exp(power), max=ALPHA_MAX)
    drop = (power > 0.0) | (alpha < ALPHA_MIN) | ~valid[..., None, :]
    return torch.where(drop, torch.zeros_like(alpha), alpha)


def transmittance(alpha: torch.Tensor):
    """(t_before, t_after): the exclusive and inclusive products of
    (1 - alpha) along the last axis, as exp of a cumulative sum of
    log1p(-alpha) (alpha <= 0.99 keeps the log finite). JAX sums the same
    logs in 128-wide chunks with a triangular matmul for its MXU."""
    log1m = torch.log1p(-alpha)
    log_t_after = torch.cumsum(log1m, dim=-1)
    return torch.exp(log_t_after - log1m), torch.exp(log_t_after)


def composite_packed(pix: torch.Tensor, p: torch.Tensor,
                     valid: torch.Tensor, bg: torch.Tensor):
    """Composite K depth-ascending packed rows p (..., K, 8 + C) at pixels
    pix (..., P, 2). Returns (color (..., P, C), depth (..., P), alpha
    (..., P), weights (..., P, K))."""
    c = p.shape[-1] - 8
    alpha = tile_alpha(pix, p, valid)
    t_before, t_after = transmittance(alpha)
    include = t_after >= T_EPS
    w = torch.where(include, alpha * t_before, torch.zeros_like(alpha))
    # include is a prefix mask: the final transmittance is t_after at the
    # last included position, the minimum over the included prefix.
    ones = torch.ones_like(t_after)
    t_final = torch.where(include.any(dim=-1),
                          torch.where(include, t_after, ones).amin(dim=-1),
                          ones[..., 0])
    feats = torch.cat([p[..., 8:], p[..., 6:7]], dim=-1)   # colour + depth
    acc = w @ feats
    out_color = acc[..., :c] + t_final[..., None] * bg
    return out_color, acc[..., c], w.sum(dim=-1), w


def composite_tile(pix_xy, xy, conic, color, opac, depth, valid, bg):
    """Composite K depth-ordered splats over P pixels (one tile) with a
    cumulative product for the transmittance. pix_xy (P, 2); xy, conic,
    color, opac, depth (K, ...) gathered, depth ascending; valid (K,) bool;
    bg (C,). Returns (P, C) color, (P,) depth, (P,) alpha, (P, K)
    weights."""
    d = pix_xy[:, None, :] - xy[None, :, :]                   # (P, K, 2)
    power = (-0.5 * (conic[None, :, 0] * d[..., 0] ** 2
                     + conic[None, :, 2] * d[..., 1] ** 2)
             - conic[None, :, 1] * d[..., 0] * d[..., 1])
    alpha = torch.clamp(opac[None, :] * torch.exp(power), max=ALPHA_MAX)
    zero = torch.zeros_like(alpha)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN)
                        | ~valid[None, :], zero, alpha)       # (P, K)
    one_minus = 1.0 - alpha
    t_after = torch.cumprod(one_minus, dim=1)
    include = t_after >= T_EPS
    t_before = t_after / torch.where(one_minus == 0.0,
                                     torch.ones_like(one_minus), one_minus)
    w = torch.where(include, alpha * t_before, zero)          # (P, K)
    ones = torch.ones_like(t_after)
    t_final = torch.where(include.any(dim=1),
                          torch.where(include, t_after, ones).amin(dim=1),
                          ones[:, 0])
    feats = torch.cat([color, depth[:, None]], dim=1)         # (K, C + 1)
    acc = w @ feats
    out_color = acc[:, :-1] + t_final[:, None] * bg[None, :]
    return out_color, acc[:, -1], w.sum(dim=1), w


def tile_origins(tiles_x: int, tiles_y: int, tile: int,
                 device=None) -> torch.Tensor:
    """(T, 2) float32 pixel origin (x, y) of each tile, row-major."""
    tid = torch.arange(tiles_x * tiles_y, dtype=torch.int64, device=device)
    return torch.stack([(tid % tiles_x) * tile,
                        torch.div(tid, tiles_x, rounding_mode="floor")
                        * tile], dim=1).to(torch.float32)


def untile(flat: torch.Tensor, tiles_x: int, tiles_y: int, tile: int,
           width: int, height: int) -> torch.Tensor:
    """(T, tile * tile, ch) per-tile pixels -> (height, width, ch)."""
    ch = flat.shape[-1]
    img = flat.reshape(tiles_y, tiles_x, tile, tile, ch).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, ch)
    return img[:height, :width]


def _composite_batch(packed, pix0, idx, origins, bg):
    """Composite one batch of tiles: idx (B, K) splat indices (-1 pad),
    origins (B, 2). Returns ((B, P, C) color, (B, P) depth, (B, P)
    alpha)."""
    valid = idx >= 0
    rows = packed[torch.clamp(idx, min=0)]                    # (B, K, 8 + C)
    pix = pix0[None] + origins[:, None, :]                    # (B, P, 2)
    out_c, out_d, out_a, _ = composite_packed(pix, rows, valid, bg)
    return out_c, out_d, out_a


def rasterize(
    splats: Splats2D,
    width: int,
    height: int,
    bg: Optional[torch.Tensor] = None,
    tile: int = TILE,
    max_tiles_per_gauss: int = 16,
    max_per_tile: int = 512,
    tile_batch: int = 64,
    bins: Optional[TileBins] = None,
    remat: bool = True,
) -> RasterOut:
    """Rasterize one view on the padded-tile path: colour, depth and alpha
    are differentiable (autograd) in every splat field that reaches the
    compositor and in bg. Tiles run `tile_batch` at a time; remat=True
    checkpoints each batch when autograd is recording, so the backward
    recomputes its (pixels, K) matrices (the RNG state is not stashed:
    nothing here draws random numbers, and stashing it reads the host,
    which a CUDA graph capture refuses)."""
    c = splats.color.shape[1]
    dev = splats.xy.device
    if bg is None:
        bg = torch.zeros((c,), dtype=splats.color.dtype, device=dev)
    tiles_x, tiles_y = num_tiles(width, height, tile)
    if bins is None:
        bins = bin_splats(splats, width, height, tile, max_tiles_per_gauss,
                          max_per_tile)
    idx = bins.tile_lists                                     # (T, K)
    pix0 = _tile_pixel_grid(tile, dev)                        # (P, 2)
    origins = tile_origins(tiles_x, tiles_y, tile, dev)       # (T, 2)
    packed = pack_splats(splats)                              # (N, 8 + C)
    ckpt = remat and torch.is_grad_enabled()
    parts = []
    for b0 in range(0, idx.shape[0], tile_batch):
        args = (packed, pix0, idx[b0:b0 + tile_batch],
                origins[b0:b0 + tile_batch], bg)
        parts.append(checkpoint(_composite_batch, *args, use_reentrant=False,
                                preserve_rng_state=False) if ckpt
                     else _composite_batch(*args))
    out_c, out_d, out_a = (torch.cat(x, dim=0) for x in zip(*parts))
    grid = (tiles_x, tiles_y, tile, width, height)
    color = untile(out_c, *grid).permute(2, 0, 1)
    depth = untile(out_d[..., None], *grid)[..., 0]
    alpha = untile(out_a[..., None], *grid)[..., 0]
    return RasterOut(color=color, depth=depth, alpha=alpha,
                     radii=splats.radius)
