"""FlashSplat-style mask lifting: per-(label, Gaussian) contribution counts.

Counterpart of wheat3dgs_tpu/ops/mask_lift.py (reference:
gaussian_renderer/__init__.py:109-218; FlashSplat, arXiv:2409.08270). For
an int label image M and blending weights w_{p,i} (alpha x transmittance
of Gaussian i at pixel p, exactly the render's composite weights):

    used_count[l, i] = sum_{p : M[p] == l} w_{p,i}

The count is linear in the one-hot label planes and w does not depend on
the Gaussians' colours, so it is the vector-Jacobian product of a render
with per-Gaussian label colours, taken with respect to those colours, with
the label planes as the image's cotangent:

    d/dc[i, l]  sum_p plane_l[p] * (sum_j w_{p,j} c[j, l])
              = sum_p plane_l[p] * w_{p,i}.

`lift_mask` has two paths:
- the entry stream (the default; JAX's "pallas" backend) builds it that
  way, LABELS_PER_PASS label planes per pass through the differentiable
  `rasterize` (its composite_train_fwd, composite_bwd and segsum kernels
  at 1 + LABELS_PER_PASS value rows: depth and the label channels), as the
  JAX package's seg/flashsplat.py::lift_batch8 does;
- the padded-tile path (any of `tile`, `max_tiles_per_gauss`,
  `max_per_tile`, `tile_batch` given; JAX's `lift_mask`) composites each
  batch of tiles with ops/raster.py's `composite_packed` and accumulates
  the (L+1, P) one-hot label matrix times the (P, K) weights of each tile
  into the (L+1, N) counts with a scatter-add over the tile's splat
  indices.

contrib_num, the count of splats with a nonzero blending weight at each
pixel (alpha >= 1/255 before the pixel's stop), comes from the first
pass's training compositor: the weights do not depend on the colours, so
every pass gives the same count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .binning import TILE, bin_splats, num_tiles
from .cuda_raster import rasterize
from .projection import Splats2D
from .raster import (_tile_pixel_grid, composite_packed, pack_splats,
                     tile_origins, untile)

LABELS_PER_PASS = 8


class LiftOut(NamedTuple):
    used_count: torch.Tensor  # (num_obj + 1, N)
    alpha: torch.Tensor       # (H, W)
    # (H, W) int32: contributing splats per pixel (None if not asked for)
    contrib_num: Optional[torch.Tensor]
    # Per-Gaussian projected pixel centre / view depth (the reference
    # flashsplat_render's proj_xy / gs_depth outputs); invisible Gaussians
    # (radius 0) keep their projected values.
    proj_xy: torch.Tensor     # (N, 2)
    gs_depth: torch.Tensor    # (N,)


def lift_planes(splats: Splats2D, planes: torch.Tensor, width: int,
                height: int, entry_budget: int = 0,
                with_contrib: bool = False):
    """(L, H, W) float label planes -> ((L, N) counts, (H, W) alpha): one
    forward + backward pass of `rasterize` per LABELS_PER_PASS planes (the
    last batch zero-padded). with_contrib adds the (H, W) int32
    contrib_num, counted by the first pass."""
    n = splats.xy.shape[0]
    k = LABELS_PER_PASS
    geo = Splats2D(*(t.detach() for t in splats))
    counts, alpha, contrib = [], None, None
    for b0 in range(0, planes.shape[0], k):
        block = planes[b0:b0 + k]
        cot = torch.zeros((k, height, width), dtype=torch.float32,
                          device=planes.device)
        cot[:block.shape[0]] = block
        with torch.enable_grad():
            colors = torch.zeros((n, k), dtype=torch.float32,
                                 device=planes.device, requires_grad=True)
            first = with_contrib and b0 == 0
            out = rasterize(geo._replace(color=colors), width, height,
                            entry_budget=entry_budget, with_contrib=first)
            if first:
                out, contrib = out
            (g,) = torch.autograd.grad(out.color, colors, grad_outputs=cot)
        counts.append(g.T[:block.shape[0]])
        alpha = out.alpha.detach()
    if with_contrib:
        return torch.cat(counts, dim=0), alpha, contrib
    return torch.cat(counts, dim=0), alpha


def lift_mask(splats: Splats2D, gt_mask: torch.Tensor, num_obj: int,
              width: int, height: int, tile: Optional[int] = None,
              max_tiles_per_gauss: Optional[int] = None,
              max_per_tile: Optional[int] = None,
              tile_batch: Optional[int] = None, *, entry_budget: int = 0,
              with_contrib: bool = True) -> LiftOut:
    """gt_mask: (H, W) int labels in [0, num_obj], 0 = background.

    With none of JAX's tile keywords: the entry stream,
    ceil((num_obj + 1) / LABELS_PER_PASS) render passes at entry_budget.
    with_contrib=False leaves contrib_num None, for callers that read only
    the counts: the first pass then runs the compositor's build without
    the count.

    With any of them: JAX's per-tile lift (`lift_mask_tiles`), the others
    at JAX's defaults (tile 16, 16 tiles a splat, 512 a tile, 64 tiles a
    batch); entries past max_per_tile are cropped as JAX crops them, and
    contrib_num is always filled."""
    tiles = (tile, max_tiles_per_gauss, max_per_tile, tile_batch)
    if any(t is not None for t in tiles):
        if entry_budget:
            raise ValueError("lift_mask: entry_budget is the entry "
                             "stream's; the tile keywords select the "
                             "padded-tile path")
        defaults = (TILE, 16, 512, 64)
        return lift_mask_tiles(splats, gt_mask, num_obj, width, height,
                               *(d if t is None else t
                                 for t, d in zip(tiles, defaults)))
    labels = torch.arange(num_obj + 1, device=gt_mask.device)
    planes = (gt_mask.long()[None] == labels[:, None, None]).to(
        torch.float32)
    used, alpha, *contrib = lift_planes(splats, planes, width, height,
                                        entry_budget, with_contrib)
    return LiftOut(used_count=used, alpha=alpha,
                   contrib_num=contrib[0] if contrib else None,
                   proj_xy=splats.xy.detach(), gs_depth=splats.depth.detach())


@torch.no_grad()
def lift_mask_tiles(splats: Splats2D, gt_mask: torch.Tensor, num_obj: int,
                    width: int, height: int, tile: int = TILE,
                    max_tiles_per_gauss: int = 16, max_per_tile: int = 512,
                    tile_batch: int = 64) -> LiftOut:
    """JAX's per-tile lift on the padded-tile path: per batch of
    `tile_batch` tiles, the blending weights w (P, K) of each tile, the
    (L+1, P) @ (P, K) product with the one-hot labels of its pixels
    (pixels outside the image carry no label) scattered into the (L+1, N)
    counts at the tile's splat indices, the weight sum and the count of
    splats with w > 0 per pixel."""
    n = splats.xy.shape[0]
    dev = splats.xy.device
    l1 = num_obj + 1
    tiles_x, tiles_y = num_tiles(width, height, tile)
    t_total = tiles_x * tiles_y
    bins = bin_splats(splats, width, height, tile, max_tiles_per_gauss,
                      max_per_tile)
    # (T, P) per-tile pixel labels, -1 outside the image.
    labels = torch.full((tiles_y * tile, tiles_x * tile), -1,
                        dtype=torch.int64, device=dev)
    labels[:height, :width] = gt_mask.to(device=dev, dtype=torch.int64)
    labels = labels.reshape(tiles_y, tile, tiles_x, tile).permute(
        0, 2, 1, 3).reshape(t_total, tile * tile)
    ids = torch.arange(l1, device=dev)
    idx = bins.tile_lists
    pix0 = _tile_pixel_grid(tile, dev)
    origins = tile_origins(tiles_x, tiles_y, tile, dev)
    bg = torch.zeros((splats.color.shape[1],), dtype=torch.float32,
                     device=dev)
    packed = pack_splats(splats)
    used = torch.zeros((l1, n + 1), dtype=torch.float32, device=dev)
    alphas, cnums = [], []
    for b0 in range(0, t_total, tile_batch):
        tidx = idx[b0:b0 + tile_batch]                        # (B, K)
        pix = pix0[None] + origins[b0:b0 + tile_batch, None, :]
        _, _, out_a, w = composite_packed(
            pix, packed[torch.clamp(tidx, min=0)], tidx >= 0, bg)
        onehot = (labels[b0:b0 + tile_batch, :, None] == ids).to(w.dtype)
        contrib = onehot.transpose(1, 2) @ w                  # (B, L+1, K)
        cols = torch.where(tidx >= 0, tidx.long(),
                           torch.full_like(tidx, n, dtype=torch.int64))
        used.index_add_(1, cols.reshape(-1),
                        contrib.permute(1, 0, 2).reshape(l1, -1))
        alphas.append(out_a)
        cnums.append((w > 0).sum(dim=-1, dtype=torch.int32))
    grid = (tiles_x, tiles_y, tile, width, height)
    return LiftOut(
        used_count=used[:, :n],
        alpha=untile(torch.cat(alphas)[..., None], *grid)[..., 0],
        contrib_num=untile(torch.cat(cnums)[..., None], *grid)[..., 0],
        proj_xy=splats.xy.detach(), gs_depth=splats.depth.detach())


def multi_instance_opt(all_counts: torch.Tensor,
                       gamma: float = 0.0) -> torch.Tensor:
    """FlashSplat global optimal assignment (reference multi_instance_opt,
    run_3d_seg.py:54-72): per label, own count against the rest after a
    column-wise L2 normalisation, with a background bias `gamma`.
    (L+1, N) additive counts -> (L+1, N) bool one-vs-rest labels."""
    total = all_counts.sum(dim=0, keepdim=True)
    own = all_counts
    rest = total - own
    norm = torch.sqrt(own * own + rest * rest)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return (own / norm) > (rest / norm + gamma)
