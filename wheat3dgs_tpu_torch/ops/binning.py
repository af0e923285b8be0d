"""Tile binning: which splats touch which image tile, in depth order.

Counterpart of wheat3dgs_tpu/ops/binning.py, in torch with the same
float32 arithmetic, so rects, counts and lists match the JAX package
exactly. Both of the port's rasterizers use it:
- the entry stream (ops/cuda_raster.py, JAX's "pallas" backend) sizes its
  exact allocation from `capped_rect` (`pick_entry_budget` picks the
  budget rung);
- the padded-tile rasterizer (ops/raster.py::rasterize, JAX's "xla"
  backend) composites the dense per-tile lists of `bin_splats`, whose two
  static caps `count_tiles`, `pick_max_per_tile` and `pick_mtpg` size.

`bin_splats` expands each visible splat into its covered tile rectangle
(at most `max_tiles_per_gauss` slots), sorts the slots by one int64 key
tile * N + depth rank (JAX sorts the (tile, rank) pair, which is unique
for every kept slot, so the order is the same) and scatters each tile's
first `max_per_tile` entries into a dense (tiles, max_per_tile) table.
Everything is integer bookkeeping with fixed shapes and no host read (a
CUDA graph can capture it); gradients flow through the gathers that
consume the table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import Splats2D

TILE = 16  # the padded-tile rasterizer's default; the entry stream uses 32


def num_tiles(width: int, height: int, tile: int = TILE) -> tuple[int, int]:
    return (-(-width // tile), -(-height // tile))


def _trunc_clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    """float -> int32 by truncation (jnp astype), clipped to [0, hi]."""
    return torch.clamp(x.to(torch.int32), 0, hi)


def tile_rect(xy: torch.Tensor, radius: torch.Tensor, tiles_x: int,
              tiles_y: int, tile: int = TILE):
    """Covered tile rectangle per splat (reference CUDA getRect semantics)."""
    rmin_x = _trunc_clip((xy[:, 0] - radius) / tile, tiles_x)
    rmin_y = _trunc_clip((xy[:, 1] - radius) / tile, tiles_y)
    rmax_x = _trunc_clip((xy[:, 0] + radius + tile - 1) / tile, tiles_x)
    rmax_y = _trunc_clip((xy[:, 1] + radius + tile - 1) / tile, tiles_y)
    return rmin_x, rmin_y, rmax_x, rmax_y


def ellipse_aabb(splats: Splats2D):
    """Per-axis half-extents of the exact alpha >= 1/255 level-set ellipse,
    capped at the reference radius (see the JAX docstring for the why)."""
    a, b, c = splats.conic[:, 0], splats.conic[:, 1], splats.conic[:, 2]
    det = a * c - b * b
    q_max = torch.clamp(2.0 * torch.log(
        torch.clamp(splats.opacity, min=1e-12) * 255.0), min=0.0) + 1e-3
    r = splats.radius.to(torch.float32)
    good = det > 1e-12
    safe_det = torch.where(good, det, torch.ones_like(det))
    wx = torch.sqrt(torch.clamp(q_max * c / safe_det, min=0.0))
    wy = torch.sqrt(torch.clamp(q_max * a / safe_det, min=0.0))
    wx = torch.where(good, torch.minimum(wx + 1e-3, r), r)
    wy = torch.where(good, torch.minimum(wy + 1e-3, r), r)
    return wx, wy


def capped_rect(splats: Splats2D, tiles_x: int, tiles_y: int, tile: int,
                max_tiles_per_gauss: int):
    """Covered rect per splat (exact alpha-floor AABB intersected with the
    reference radius rect), center-cropped to <= max_tiles_per_gauss tiles.
    Returns int32 (rmin_x, rmin_y, span_x, span_y, count)."""
    m = max_tiles_per_gauss
    wx, wy = ellipse_aabb(splats)
    r = splats.radius.to(splats.xy.dtype)
    ref_x0, ref_y0, ref_x1, ref_y1 = tile_rect(
        splats.xy, r, tiles_x, tiles_y, tile)
    x, y = splats.xy[:, 0], splats.xy[:, 1]
    rmin_x = torch.maximum(ref_x0, torch.clamp(torch.floor(
        (x - wx) / tile).to(torch.int32), 0, tiles_x))
    rmin_y = torch.maximum(ref_y0, torch.clamp(torch.floor(
        (y - wy) / tile).to(torch.int32), 0, tiles_y))
    rmax_x = torch.minimum(ref_x1, torch.clamp(torch.floor(
        (x + wx) / tile).to(torch.int32) + 1, 0, tiles_x))
    rmax_y = torch.minimum(ref_y1, torch.clamp(torch.floor(
        (y + wy) / tile).to(torch.int32) + 1, 0, tiles_y))
    rmax_x = torch.maximum(rmax_x, rmin_x)
    rmax_y = torch.maximum(rmax_y, rmin_y)
    span_x = rmax_x - rmin_x
    span_y = rmax_y - rmin_y
    area = torch.clamp(span_x * span_y, min=1)
    scale = torch.sqrt(m / area.to(torch.float32))
    new_sx = torch.minimum(torch.maximum(
        torch.floor(span_x * torch.clamp(scale, max=1.0)),
        torch.ones_like(scale)), span_x.to(torch.float32)).to(torch.int32)
    new_sx = torch.clamp(new_sx, max=m)
    new_sy = torch.minimum(torch.clamp(
        m // torch.clamp(new_sx, min=1), min=1), span_y)
    over = span_x * span_y > m
    sx = torch.where(over, new_sx, span_x)
    sy = torch.where(over, new_sy, span_y)
    rx = torch.where(over, rmin_x + torch.div(span_x - sx, 2,
                                              rounding_mode="floor"), rmin_x)
    ry = torch.where(over, rmin_y + torch.div(span_y - sy, 2,
                                              rounding_mode="floor"), rmin_y)
    count = torch.where(splats.radius > 0, sx * sy, torch.zeros_like(sx))
    return rx, ry, sx, sy, count


def pick_entry_budget(total_entries: int, headroom: float = 1.25,
                      floor: int = 1 << 17) -> int:
    """Smallest {1, 1.25, 1.5, 1.75} * 2^k rung >= headroom * the probed
    allocation demand (the entry stream's exact-allocation size)."""
    need = max(float(floor), total_entries * headroom)
    rung = floor
    while rung < need:
        for num in (5, 6, 7):
            q = rung // 4 * num
            if q >= need and q % 128 == 0:
                return q
        rung *= 2
    return rung


class TileBins(NamedTuple):
    tile_lists: torch.Tensor   # (T, K) int32 splat index, -1 padded
    tile_counts: torch.Tensor  # (T,) int32 entries per tile (uncapped)
    depth_order: torch.Tensor  # (N,) int64 stable argsort of depth


def _slot_tiles(splats: Splats2D, tiles_x: int, tiles_y: int, tile: int,
                mtpg: int) -> torch.Tensor:
    """(N, mtpg) int64 tile id of each splat's expansion slots: slot j of
    splat i covers tile (rmin + (j % span_x, j // span_x)); slots past the
    splat's capped count hold the sentinel tiles_x * tiles_y."""
    rmin_x, rmin_y, span_x, _, count = capped_rect(splats, tiles_x, tiles_y,
                                                   tile, mtpg)
    slots = torch.arange(mtpg, dtype=torch.int64, device=splats.xy.device)
    safe_span_x = torch.clamp(span_x, min=1).to(torch.int64)[:, None]
    off_x = slots[None, :] % safe_span_x
    off_y = torch.div(slots[None, :], safe_span_x, rounding_mode="floor")
    tile_id = ((rmin_y.to(torch.int64)[:, None] + off_y) * tiles_x
               + (rmin_x.to(torch.int64)[:, None] + off_x))
    valid = slots[None, :] < count.to(torch.int64)[:, None]
    return torch.where(valid, tile_id,
                       torch.full_like(tile_id, tiles_x * tiles_y))


def count_tiles(splats: Splats2D, width: int, height: int, tile: int = TILE,
                max_tiles_per_gauss: int = 16) -> torch.Tensor:
    """(T,) int32 exact per-tile entry counts without building the lists:
    the occupancy probe that picks the max_per_tile rung."""
    tiles_x, tiles_y = num_tiles(width, height, tile)
    t_total = tiles_x * tiles_y
    tile_id = _slot_tiles(splats, tiles_x, tiles_y, tile,
                          max_tiles_per_gauss).reshape(-1)
    counts = torch.zeros((t_total + 1,), dtype=torch.int32,
                         device=tile_id.device)
    counts.index_add_(0, tile_id, torch.ones_like(tile_id,
                                                  dtype=torch.int32))
    return counts[:t_total]


MAX_PER_TILE_LADDER = (128, 256, 512, 1024, 2048, 4096)
# Capped at 32: long training grows grazing-angle ground splats past 16
# tiles, and cropping them biases their gradients (the JAX notes).
MTPG_LADDER = (4, 8, 16, 32)


def pick_mtpg(p99_area: int, ladder=MTPG_LADDER) -> int:
    """Expansion cap covering the 99th-percentile splat tile footprint
    (larger splats are centre-cropped by capped_rect)."""
    for rung in ladder:
        if rung >= p99_area:
            return rung
    return ladder[-1]


def pick_max_per_tile(max_count: int, headroom: float = 1.3,
                      ladder=MAX_PER_TILE_LADDER) -> int:
    """Smallest ladder rung >= headroom * the observed max tile
    occupancy."""
    need = max_count * headroom
    for rung in ladder:
        if rung >= need:
            return rung
    return ladder[-1]


def bin_splats(splats: Splats2D, width: int, height: int, tile: int = TILE,
               max_tiles_per_gauss: int = 16,
               max_per_tile: int = 512) -> TileBins:
    """Per-tile depth-ordered splat index lists.

    Both caps drop the farthest work: a splat covering more than
    max_tiles_per_gauss tiles keeps a centred window of its rect
    (capped_rect), and a tile with more than max_per_tile entries keeps
    its nearest ones."""
    n = splats.xy.shape[0]
    dev = splats.xy.device
    tiles_x, tiles_y = num_tiles(width, height, tile)
    t_total = tiles_x * tiles_y
    mtpg = max_tiles_per_gauss
    with torch.no_grad():
        tile_id = _slot_tiles(splats, tiles_x, tiles_y, tile, mtpg)
        depth_order = torch.argsort(splats.depth, stable=True)
        rank = torch.empty_like(depth_order)
        rank[depth_order] = torch.arange(n, device=dev)
        # Kept slots have unique (tile, rank) pairs, so this one key sorts
        # them as JAX's two-key sort does; sentinel slots sort last.
        skey, perm = torch.sort((tile_id * n + rank[:, None]).reshape(-1))
        sorted_tile = torch.div(skey, n, rounding_mode="floor")
        sorted_gauss = torch.div(perm, mtpg, rounding_mode="floor").to(
            torch.int32)
        tids = torch.arange(t_total, dtype=torch.int64, device=dev)
        starts = torch.searchsorted(sorted_tile, tids)
        ends = torch.searchsorted(sorted_tile, tids, right=True)
        tile_counts = (ends - starts).to(torch.int32)
        # Entry e lands at (tile, e - starts[tile]); dropped entries go to
        # one slot past the table, sliced off.
        pos = torch.arange(n * mtpg, device=dev) - starts[
            torch.clamp(sorted_tile, max=t_total - 1)]
        ok = (sorted_tile < t_total) & (pos < max_per_tile)
        flat = torch.where(ok, sorted_tile * max_per_tile + pos,
                           torch.full_like(pos, t_total * max_per_tile))
        lists = torch.full((t_total * max_per_tile + 1,), -1,
                           dtype=torch.int32, device=dev)
        lists.scatter_(0, flat, sorted_gauss)
    return TileBins(lists[:-1].reshape(t_total, max_per_tile), tile_counts,
                    depth_order)
