"""The exact-allocation entry-stream rasterizer, forward-only and
differentiable, with its five CUDA kernels.

Counterpart of wheat3dgs_tpu/ops/pallas_raster.py (`_rank_bits`,
`_alloc_entries`, the sorted stream, `rasterize_pallas_fwd`,
`rasterize_pallas`):

- prologue (torch ops, as JAX runs them in XLA): stable depth argsort,
  exclusive cumsum of each splat's capped covered-rect area, the owning
  depth rank of every slot, the demand `total`, and each rank's segment
  [seg_start, seg_end) of the slot array;
- `decode_cull` (kernel, csrc/decode_cull.cu; replaces `_decode_kernel`):
  slot -> (tile, depth rank), exact ellipse/tile cull, int64 sort key
  (tile << rank_bits) | rank and the surviving-entry count;
- one torch sort of the keys (its permutation maps sorted entries back to
  their slots) and a searchsorted of the per-tile bounds;
- `composite_fwd` (kernel, csrc/composite_fwd.cu; replaces
  `_fwd_only_kernel`): front-to-back compositing of [weight sum, depth?,
  colours...] straight into the image, one 16x16 sub-tile a work item,
  over the tile's entries that the sub-tile cull keeps (`fwd_subtile_keep`
  is its plain mirror);
- `composite_train_fwd` (kernel, the same source; replaces `_fwd_kernel`):
  the same image plus, per pixel, the sorted position one past the last
  entry it included (the backward's stop, CUDA's `n_contrib`); at the
  lift's 9 rows it can also count each pixel's included entries (JAX's
  LiftOut.contrib_num), `with_contrib`;
- `composite_bwd` (kernel, csrc/composite_bwd.cu; replaces `_bwd_kernel`):
  the front-to-back replay that writes each entry's (6 + nv) gradient row
  to its pre-sort slot;
- `segsum` (kernel, csrc/segsum.cu; replaces `_segsum_kernel`): each depth
  rank's contiguous slot segment summed into its row of d feat_r.

`rasterize` wraps the last three in one torch.autograd.Function whose
differentiable input is the rank-ordered feature table
[x, y, a, b, c, opacity, depth, colours...]; autograd carries its gradient
through `entry_features` and projection to the parameters.

Each kernel wrapper takes its plain PyTorch version for a tensor on the
CPU, and launches the kernel for a CUDA tensor (or raises); there is no
fallback from one to the other. `launches` counts kernel launches;
`plain_kernels()` routes the five wrappers to their plain versions on
the card's tensors too, for a run held against the kernels.

The TPU schedule knobs (bf16 payload packing, W3_TRI_MODE,
WHEAT3DGS_MOMENT_KERNELS, r_batch, 128-lane chunking) have no counterpart:
the port always composites exact float32, which is the JAX path with
pack_payload=False. Only on request does the backward replay round what
JAX's `_bwd_kernel` rounds on a TPU: `composite_bwd(..., bf16_ops=True)`
(scripts/tpu_numerics.py's `bf16_replay()` routes `rasterize`'s backward
there).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .binning import capped_rect, num_tiles
from .cuda_build import launch as _launch
from .cuda_build import launches, reset_launches  # noqa: F401  (re-exported)
from .projection import Splats2D
from .raster import ALPHA_MAX, ALPHA_MIN, T_EPS, RasterOut

CHUNK = 128          # entry budgets are multiples of this (as in JAX)
FEAT = 16            # JAX's packed feature width: 7 + values <= 16
LOG_T_EPS = math.log(T_EPS)
TILE_PX = 32         # the entry-stream rasterizer's tile side
SUB_PX = 16          # the forward compositors' work item: a 16x16 sub-tile
MAX_SPAN = 1024      # tiles one splat may cover (center-cropped beyond)
PLAIN_TILE_BATCH = 64    # tiles per step of the plain compositor
PLAIN_CHUNK = 128        # entries per step of the plain compositor
COUNT_NV = 9             # value rows of composite_train_fwd's counting build

def default_budget(n: int) -> int:
    """The entry budget of a render at `entry_budget=0`: 16 entries per
    splat slot, 128-aligned, at least 1024 (as in JAX)."""
    return max(1024, -(-16 * n // CHUNK) * CHUNK)


def _rank_bits(t_total: int) -> int:
    return 32 - max(1, math.ceil(math.log2(t_total + 1)))


def key_rank_bits(n: int, t_total: int) -> int:
    """Low key bits holding the depth rank: JAX's own `_rank_bits` (keys
    value-identical to its uint32 keys) while n fits, else enough for n
    (the int64 key then does what JAX's two-key fallback does)."""
    rb = _rank_bits(t_total)
    return rb if n <= (1 << rb) else max(1, (n - 1).bit_length())


class EntryPlan(NamedTuple):
    """The allocation prologue's output: the decode kernel's inputs."""

    owner: torch.Tensor     # (E,) int32 monotone owning depth rank per slot
    total: torch.Tensor     # 0-d int32 allocation demand
    geo_r: torch.Tensor     # (N, 6) f32 rank-ordered [x, y, a, b, c, q_max]
    rect_r: torch.Tensor    # (N, 4) i32 [run start, max(sx, 1), rx, ry]
    order: torch.Tensor     # (N,) int64 depth rank -> splat index
    tiles_x: int
    t_total: int
    rank_bits: int
    # Rank r owns slots [seg_start[r], seg_end[r]) (int32, (N,)): its
    # offset and count clipped to the budget. Consecutive segments touch,
    # so they partition [0, min(total, E)).
    seg_start: torch.Tensor
    seg_end: torch.Tensor


# --- kernel plumbing -----------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _same_cuda_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even) and back to
    float32: an operand of a one-pass bfloat16 MXU product, as JAX's
    `astype(jnp.bfloat16)` rounds it."""
    return x.to(torch.bfloat16).float()


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# --- decode_cull -----------------------------------------------------------


def decode_cull_plain(plan: EntryPlan):
    """Plain PyTorch decode: the elementwise XLA form of
    pallas_raster.py:335-371 (run starts from a running max over the
    positions where the owner changes), with the int64 key."""
    owner, total, geo_r, rect_r = plan.owner, plan.total, plan.geo_r, \
        plan.rect_r
    tiles_x, t_total, tile = plan.tiles_x, plan.t_total, TILE_PX
    e = owner.shape[0]
    dev = owner.device
    idx = torch.arange(e, dtype=torch.int32, device=dev)
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                      owner[:-1]])
    first = torch.cummax(torch.where(owner != prev, idx,
                                     torch.zeros_like(idx)), 0).values
    j = torch.clamp(idx - first, max=1 << 22)
    valid = idx < total
    ow = owner.long()
    sx = rect_r[ow, 1]
    q = torch.floor(j.to(torch.float32)
                    * (1.0 / sx.to(torch.float32))).to(torch.int32)
    r = j - q * sx
    q = q + (r >= sx).to(torch.int32) - (r < 0).to(torch.int32)
    dy = q
    dx = j - q * sx
    txi = rect_r[ow, 2] + dx
    tyi = rect_r[ow, 3] + dy
    tile_id = tyi * tiles_x + txi
    g = geo_r[ow]
    x0 = (txi * tile).to(torch.float32) - g[:, 0]
    x1 = x0 + (tile - 1)
    y0 = (tyi * tile).to(torch.float32) - g[:, 1]
    y1 = y0 + (tile - 1)
    ca, cb, cc = g[:, 2], g[:, 3], g[:, 4]

    def edge(d_fix, lo, hi, c_fix, c_free):
        t = torch.minimum(torch.maximum(-cb * d_fix / c_free, lo), hi)
        return c_fix * d_fix * d_fix + 2.0 * cb * d_fix * t + c_free * t * t

    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    qmin = torch.minimum(
        torch.minimum(edge(x0, y0, y1, ca, cc), edge(x1, y0, y1, ca, cc)),
        torch.minimum(edge(y0, x0, x1, cc, ca), edge(y1, x0, x1, cc, ca)))
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    keep = valid & (qmin <= g[:, 5] + 1e-3)
    tile_out = torch.where(keep, tile_id.long(),
                           torch.full_like(ow, t_total))
    key = (tile_out << plan.rank_bits) | ow
    return key, keep.sum(dtype=torch.int32)


def decode_cull(plan: EntryPlan):
    """The allocation plan (E-slot monotone owners, demand `total`,
    rank-ordered geometry and rects) -> ((E,) int64 keys, 0-d int32
    surviving-entry count)."""
    owner, total, geo_r, rect_r = plan.owner, plan.total, plan.geo_r, \
        plan.rect_r
    if owner.device.type == "cpu":
        return decode_cull_plain(plan)
    if owner.device.type != "cuda":
        raise ValueError(f"decode_cull: unsupported device {owner.device}")
    n = geo_r.shape[0]
    e = owner.shape[0]
    _same_cuda_device(owner, total, geo_r, rect_r)
    _check(owner, "owner", torch.int32, (e,))
    _check(total, "total", torch.int32, ())
    _check(geo_r, "geo_r", torch.float32, (n, 6))
    _check(rect_r, "rect_r", torch.int32, (n, 4))
    if rect_r.data_ptr() % 16:
        raise ValueError("rect_r: must be 16-byte aligned")
    if e >= 1 << 24:
        raise ValueError("entry budget exceeds the exact-f32 offset range")
    key = torch.empty((e,), dtype=torch.int64, device=owner.device)
    alive = torch.empty((), dtype=torch.int32, device=owner.device)
    _launch("decode_cull", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
            (owner.data_ptr(), rect_r.data_ptr(), geo_r.data_ptr(),
             total.data_ptr(), e, plan.tiles_x, TILE_PX, plan.t_total,
             plan.rank_bits, key.data_ptr(), alive.data_ptr()),
            owner.device)
    return key, alive


# --- the compositors' plain versions: shared pieces -------------------------


def _to_tiles(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(C, H, W) image -> (T, C, P) rows of each 32x32 tile's pixels, zero
    beyond the image."""
    c, h, w = x.shape
    tile = TILE_PX
    full = x.new_zeros((c, tiles_y * tile, tiles_x * tile))
    full[:, :h, :w] = x
    return full.reshape(c, tiles_y, tile, tiles_x, tile).permute(
        1, 3, 0, 2, 4).reshape(tiles_x * tiles_y, c, tile * tile)


def _from_tiles(raw: torch.Tensor, tiles_x: int, tiles_y: int, width: int,
                height: int) -> torch.Tensor:
    """Inverse of _to_tiles: (T, C, P) -> (C, H, W), cropped."""
    c = raw.shape[1]
    tile = TILE_PX
    img = raw.reshape(tiles_y, tiles_x, c, tile, tile)
    return img.permute(2, 0, 3, 1, 4).reshape(
        c, tiles_y * tile, tiles_x * tile)[:, :height, :width].contiguous()


def _batch_pixels(tids: torch.Tensor, tiles_x: int):
    """(B, P) float pixel coordinates of the tiles `tids`."""
    tile = TILE_PX
    pix = torch.arange(tile * tile, device=tids.device)
    px = ((tids % tiles_x) * tile).to(torch.float32)[:, None] \
        + (pix % tile).to(torch.float32)
    py = ((tids // tiles_x) * tile).to(torch.float32)[:, None] \
        + (pix // tile).to(torch.float32)
    return px, py


def _chunk_alpha(feat_r, rank, pos, valid, px, py):
    """Entries at sorted positions pos (B, K) against the pixels (B, P) of
    their tiles: the features (B, K, F), dx, dy, exp(power), the raw
    o * exp(power) and alpha (B, P, K) with renderCUDA's clamps (zero where
    power > 0, alpha < 1/255 or pos is outside the tile's segment)."""
    e = rank.shape[0]
    f = feat_r[rank[pos.clamp(max=max(e - 1, 0))]]
    dx = px[:, :, None] - f[:, None, :, 0]
    dy = py[:, :, None] - f[:, None, :, 1]
    power = (-0.5 * (f[:, None, :, 2] * dx * dx
                     + f[:, None, :, 4] * dy * dy)
             - f[:, None, :, 3] * dx * dy)
    ep = torch.exp(power)
    raw = f[:, None, :, 5] * ep
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN)
                        | ~valid[:, None, :], torch.zeros_like(alpha), alpha)
    return f, dx, dy, ep, raw, alpha


def _plain_forward(skeys, starts, ends, feat_r, rank_bits: int, width: int,
                   height: int, with_stop: bool, with_counts: bool,
                   keep: Optional[torch.Tensor] = None,
                   with_contrib: bool = False):
    """The `_fwd_kernel` / `_fwd_only_kernel` maths per tile and per chunk
    of PLAIN_CHUNK entries (log-space transmittance via a cumsum over the
    chunk), PLAIN_TILE_BATCH tiles at a time so it fits on the card at full
    width. With `keep` ((E, 4) bool, fwd_subtile_keep), each pixel walks
    only the entries kept in its sub-tile, as the kernels do. Returns
    (image, stop or None, (visited, weighted) or None), and with
    with_contrib the (H, W) int32 count of the entries each pixel included
    (w > 0, JAX's contrib_num) after them."""
    dev = feat_r.device
    nv = feat_r.shape[1] - 6
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    t_total = tiles_x * tiles_y
    p = TILE_PX * TILE_PX
    e = skeys.shape[0]
    rank = skeys & ((1 << rank_bits) - 1)
    raw = torch.zeros((t_total, 1 + nv, p), dtype=torch.float32, device=dev)
    stop = torch.zeros((t_total, 1, p), dtype=torch.int64, device=dev)
    contrib = torch.zeros((t_total, 1, p), dtype=torch.int64, device=dev)
    visited = torch.zeros((), dtype=torch.int64, device=dev)
    weighted = torch.zeros((), dtype=torch.int64, device=dev)
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    pix = torch.arange(p, device=dev)
    pix_sub = (pix % TILE_PX) // SUB_PX + 2 * ((pix // TILE_PX) // SUB_PX)
    for b0 in range(0, t_total, PLAIN_TILE_BATCH):
        tids = torch.arange(b0, min(b0 + PLAIN_TILE_BATCH, t_total),
                            device=dev)
        s = starts[tids].long()
        en = ends[tids].long()
        longest = int((en - s).max())
        px, py = _batch_pixels(tids, tiles_x)
        log_t = torch.zeros((len(tids), p), dtype=torch.float32, device=dev)
        acc = torch.zeros((len(tids), 1 + nv, p), dtype=torch.float32,
                          device=dev)
        last = s[:, None].expand(len(tids), p).clone()
        n_inc = torch.zeros((len(tids), p), dtype=torch.int64, device=dev)
        for c0 in range(0, longest, PLAIN_CHUNK):
            if not bool((log_t >= LOG_T_EPS).any()):
                break
            pos = s[:, None] + c0 + lane                       # (B, K)
            valid = pos < en[:, None]
            f, _, _, _, _, alpha = _chunk_alpha(feat_r, rank, pos, valid,
                                                px, py)
            walk = valid[:, None, :]                           # (B, 1|P, K)
            if keep is not None:
                # The kernels walk neither culled entries nor pixels
                # outside the image.
                walk = walk & keep[pos.clamp(max=max(e - 1, 0))][
                    :, :, pix_sub].transpose(1, 2) \
                    & ((px < width) & (py < height))[:, :, None]
                alpha = torch.where(walk, alpha, torch.zeros_like(alpha))
            l1m = torch.log1p(-alpha)
            log_t_after = log_t[:, :, None] + torch.cumsum(l1m, dim=2)
            include = log_t_after >= LOG_T_EPS
            w = torch.where(include, alpha * torch.exp(log_t_after - l1m),
                            torch.zeros_like(alpha))
            vals = torch.cat([torch.ones_like(f[:, :, :1]), f[:, :, 6:]],
                             dim=2)                            # (B, K, 1+nv)
            acc += torch.einsum("bpk,bkv->bvp", w, vals)
            if with_stop:
                # w > 0 exactly for included live entries (w >= 1e-4/255).
                last = torch.maximum(last, torch.where(
                    w > 0, pos[:, None, :] + 1, 0).amax(dim=2))
            if with_contrib:
                n_inc += (w > 0).sum(dim=2)
            if with_counts:
                # A walk visits an entry while the pixel is still open
                # before it, i.e. up to and including the stopping entry.
                open_before = (log_t_after - l1m) >= LOG_T_EPS
                visited += (open_before & walk).sum()
                weighted += (w > 0).sum()
            log_t = log_t_after[:, :, -1]
        raw[tids] = acc
        stop[tids, 0] = last
        contrib[tids, 0] = n_inc
    img = _from_tiles(raw, tiles_x, tiles_y, width, height)
    stop_img = (_from_tiles(stop, tiles_x, tiles_y, width, height)[0]
                .to(torch.int32) if with_stop else None)
    counts = (int(visited), int(weighted)) if with_counts else None
    if with_contrib:
        return img, stop_img, counts, _from_tiles(
            contrib, tiles_x, tiles_y, width, height)[0].to(torch.int32)
    return img, stop_img, counts


def _compositor_shapes(name, skeys, starts, ends, feat_r, width, height):
    """Check the inputs every compositor kernel takes; (tiles_x, tiles_y,
    nv)."""
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    n, cols = feat_r.shape
    nv = cols - 6
    if not 0 <= nv <= FEAT - 7:
        raise ValueError(f"{name}: {nv} value columns (max {FEAT - 7})")
    _same_cuda_device(skeys, starts, ends, feat_r)
    _check(skeys, "skeys", torch.int64, (skeys.shape[0],))
    _check(starts, "starts", torch.int32, (tiles_x * tiles_y,))
    _check(ends, "ends", torch.int32, (tiles_x * tiles_y,))
    _check(feat_r, "feat_r", torch.float32, (n, cols))
    if skeys.shape[0] >= 1 << 24:
        raise ValueError(f"{name}: entry budget exceeds the int32 range "
                         "of the stop positions")
    return tiles_x, tiles_y, nv


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


# --- the forward compositors' sub-tile cull -----------------------------------


def _box_keep(f, bx0, bx1, by0, by1):
    """csrc/composite_fwd.cu's box_keep on rows f = [x, y, a, b, c, o]
    against pixel boxes [bx0, bx1] x [by0, by1]: False only where the
    entry's alpha is under ALPHA_MIN at every pixel of the box. The
    minimum of the conic quadratic over the box (decode_cull's exact tile
    test) is compared with 2 ln(o / ALPHA_MIN) + 1e-3, plus a rounding
    allowance of 2^-16 of the quadratic's largest term over the box; an
    entry whose conic is not positive definite (or that is NaN) is kept."""
    x, y, a, b, c, o = (f[..., i] for i in range(6))
    x0, x1, y0, y1 = bx0 - x, bx1 - x, by0 - y, by1 - y

    def edge(d_fix, lo, hi, c_fix, c_free):
        t = torch.minimum(torch.maximum(-b * d_fix / c_free, lo), hi)
        return c_fix * d_fix * d_fix + 2.0 * b * d_fix * t + c_free * t * t

    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    qmin = torch.minimum(
        torch.minimum(edge(x0, y0, y1, a, c), edge(x1, y0, y1, a, c)),
        torch.minimum(edge(y0, x0, x1, c, a), edge(y1, x0, x1, c, a)))
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    dx = torch.maximum(x0.abs(), x1.abs())
    dy = torch.maximum(y0.abs(), y1.abs())
    slack = (a * dx * dx + 2.0 * b.abs() * dx * dy + c * dy * dy) * 2.0 ** -16
    q_max = 2.0 * torch.log(o / ALPHA_MIN)
    definite = (a > 0) & (c > 0) & (a * c > b * b)
    return ~definite | ~(qmin > q_max + 1e-3 + slack)


def fwd_subtile_keep(skeys, starts, ends, feat_r, rank_bits: int,
                     width: int, height: int) -> torch.Tensor:
    """The forward compositors' cull as plain torch: (E, 4) bool, True
    where sorted entry k may reach ALPHA_MIN in sub-tile s of its tile
    (s = column half + 2 * row half, each box clipped to the image). False
    for entries outside their tile's segment (decode_cull's culled slots)
    and sub-tiles outside the image."""
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    t_total = tiles_x * tiles_y
    tile = skeys >> rank_bits
    tc = tile.clamp(max=t_total - 1)
    k = torch.arange(skeys.shape[0], device=skeys.device)
    listed = (tile < t_total) & (k >= starts[tc]) & (k < ends[tc])
    f = feat_r[:, :6][(skeys & ((1 << rank_bits) - 1))]
    sub = torch.arange(4, device=skeys.device)
    bx = ((tile % tiles_x) * TILE_PX)[:, None] + (sub % 2) * SUB_PX
    by = ((tile // tiles_x) * TILE_PX)[:, None] + (sub // 2) * SUB_PX
    bx1 = torch.clamp(bx + SUB_PX, max=width) - 1
    by1 = torch.clamp(by + SUB_PX, max=height) - 1
    keep = _box_keep(f[:, None, :], bx.float(), bx1.float(), by.float(),
                     by1.float())
    return keep & listed[:, None] & (bx < width) & (by < height)


def fwd_block_steps(skeys, starts, ends, feat_r, rank_bits: int, width: int,
                    height: int):
    """The forward compositors' work under their cull, counted with the
    plain walk: (kept, walked, visited) = the (sub-tile, entry) pairs the
    cull keeps; the pairs it tests (every entry of a tile's segment in each
    of its sub-tiles inside the image); and the (pixel, entry) pairs a
    pixel walks among its sub-tile's kept entries while open, up to and
    including its stopping entry (pixels inside the image only, where
    composite_fwd_plain's `visited` also counts the pixels of partial tiles
    beyond it)."""
    keep = fwd_subtile_keep(skeys, starts, ends, feat_r, rank_bits, width,
                            height)
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    sub = torch.arange(4, device=skeys.device)
    t = torch.arange(tiles_x * tiles_y, device=skeys.device)
    n_sub = ((((t % tiles_x) * TILE_PX)[:, None] + (sub % 2) * SUB_PX < width)
             & (((t // tiles_x) * TILE_PX)[:, None] + (sub // 2) * SUB_PX
                < height)).sum(dim=1)
    walked = int((n_sub * (ends - starts).long()).sum())
    _, _, (visited, _) = _plain_forward(skeys, starts, ends, feat_r,
                                        rank_bits, width, height, False, True,
                                        keep)
    return int(keep.sum()), walked, visited


# --- composite_fwd -----------------------------------------------------------


def composite_fwd_plain(skeys, starts, ends, feat_r, rank_bits: int,
                        width: int, height: int, with_counts: bool = False):
    """Plain PyTorch forward-only compositor (`_plain_forward`). Returns
    the (1 + nv, H, W) [weight sum, values...] image; with_counts=True also
    returns (visited, weighted) (pixel, entry) pair counts of a
    front-to-back walk that stops at the transmittance floor (the work the
    kernel has to do)."""
    img, _, counts = _plain_forward(skeys, starts, ends, feat_r, rank_bits,
                                    width, height, False, with_counts)
    return (img, counts) if with_counts else img


def composite_fwd(skeys, starts, ends, feat_r, rank_bits: int, width: int,
                  height: int):
    """(E,) int64 sorted keys, (T,) int32 per-tile segment bounds,
    (N, 6 + nv) float32 rank-ordered [x, y, a, b, c, opacity, values...]
    -> (1 + nv, H, W) float32 [weight sum, values...]."""
    if feat_r.device.type == "cpu":
        return composite_fwd_plain(skeys, starts, ends, feat_r, rank_bits,
                                   width, height)
    _cuda_only("composite_fwd", feat_r)
    tiles_x, tiles_y, nv = _compositor_shapes(
        "composite_fwd", skeys, starts, ends, feat_r, width, height)
    out = torch.empty((1 + nv, height, width), dtype=torch.float32,
                      device=feat_r.device)
    _launch("composite_fwd",
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
            (skeys.data_ptr(), starts.data_ptr(), ends.data_ptr(),
             feat_r.data_ptr(), nv, rank_bits, tiles_x, tiles_y, width,
             height, ALPHA_MIN, ALPHA_MAX, LOG_T_EPS, out.data_ptr()),
            feat_r.device)
    return out


# --- composite_train_fwd ----------------------------------------------------


def composite_train_fwd_plain(skeys, starts, ends, feat_r, rank_bits: int,
                              width: int, height: int,
                              with_contrib: bool = False):
    """Plain PyTorch training compositor: composite_fwd_plain's image and
    the (H, W) int32 stop (one past the sorted position of the last entry
    each pixel included; its tile's segment start if none); with_contrib
    also returns the (H, W) int32 count of the entries each pixel
    included."""
    out = _plain_forward(skeys, starts, ends, feat_r, rank_bits, width,
                         height, True, False, with_contrib=with_contrib)
    return (out[0], out[1], out[3]) if with_contrib else out[:2]


def composite_train_fwd(skeys, starts, ends, feat_r, rank_bits: int,
                        width: int, height: int, with_contrib: bool = False):
    """composite_fwd's inputs -> ((1 + nv, H, W) image, (H, W) int32 stop),
    the backward's residual; with_contrib (the lift, COUNT_NV value rows
    on the card) also the (H, W) int32 count of each pixel's included
    entries."""
    if feat_r.device.type == "cpu":
        return composite_train_fwd_plain(skeys, starts, ends, feat_r,
                                         rank_bits, width, height,
                                         with_contrib)
    _cuda_only("composite_train_fwd", feat_r)
    tiles_x, tiles_y, nv = _compositor_shapes(
        "composite_train_fwd", skeys, starts, ends, feat_r, width, height)
    if with_contrib and nv != COUNT_NV:
        raise ValueError(f"composite_train_fwd: the per-pixel count is "
                         f"built for {COUNT_NV} value rows, not {nv}")
    out = torch.empty((1 + nv, height, width), dtype=torch.float32,
                      device=feat_r.device)
    stop = torch.empty((height, width), dtype=torch.int32,
                       device=feat_r.device)
    args = (skeys.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            feat_r.data_ptr(), nv, rank_bits, tiles_x, tiles_y, width,
            height, ALPHA_MIN, ALPHA_MAX, LOG_T_EPS, out.data_ptr(),
            stop.data_ptr())
    types = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P]
    if not with_contrib:
        _launch("composite_train_fwd", types, args, feat_r.device,
                source="composite_fwd")
        return out, stop
    contrib = torch.empty((height, width), dtype=torch.int32,
                          device=feat_r.device)
    _launch("composite_train_fwd", types + [_P], args + (contrib.data_ptr(),),
            feat_r.device, source="composite_fwd",
            entry="composite_train_fwd_count")
    return out, stop, contrib


# --- composite_bwd -----------------------------------------------------------


def bf16_replay_products(g_v, vals_v, w):
    """The replay's three products over one chunk of K entries of a batch
    of B tiles, as JAX's `_bwd_kernel` computes them on a TPU
    (pallas_raster.py:964-990): each product's operands rounded to
    bfloat16, the products (exact in float32) summed in float32.
    g_v (B, nv, P) the value rows' cotangents, vals_v (B, K, nv) the
    entries' value rows, w (B, P, K) the weights ->
      u_v   (B, P, K)  = sum_v g_v value_v (`u = gmat . ent`),
      terms (B, P, K)  = w u_v rounded to bfloat16, the addends of the
                         prefix (`pu @ tri`, whose 0/1 `tri` is exact),
      d_val (B, K, nv) = sum_p w g_v (`fg = gmat . w`).
    The weight-sum row is not among them: JAX keeps its counterpart, the
    `a2` / T_final route, in float32."""
    g_b = bf16_round(g_v)
    u_v = torch.einsum("bvp,bkv->bpk", g_b, bf16_round(vals_v))
    return (u_v, bf16_round(w * u_v),
            torch.einsum("bpk,bvp->bkv", bf16_round(w), g_b))


def composite_bwd_plain(skeys, perm, starts, ends, feat_r, img, stop, grad,
                        rank_bits: int, width: int, height: int,
                        bf16_ops: bool = False):
    """Plain PyTorch backward replay: the `_bwd_kernel` maths in direct form
    (pallas_raster.py:927-1035), per chunk of PLAIN_CHUNK entries and
    PLAIN_TILE_BATCH tiles at a time. Per pixel, with the weight-sum row
    taken as a value row of ones (which replaces JAX's T_final term):
      A      = sum_rows grad_row * img_row,
      u_k    = sum_rows grad_row * value_k_row,
      dα_k   = T_before_k u_k - (A - sum_{j<=k} w_j u_j) / (1 - α_k),
    zero unless entry k is live, before the pixel's stop and its raw
    o e^power < 0.99; dpow = dα α. Per entry, summed over its tile's pixels:
    d xy = Σ dpow (a dx + b dy, b dx + c dy), d conic = Σ dpow (-dx²/2,
    -dx dy, -dy²/2), d opacity = Σ dα e^power, d value_v = Σ w grad_v.
    Returns (E, 6 + nv) rows at each entry's pre-sort slot (perm), zero for
    entries no pixel reached.

    bf16_ops: u, the prefix and d value_v take JAX's TPU rounding
    (`bf16_replay_products`): the value rows' part of u and of each prefix
    term, and both factors of d value_v, from bfloat16 operands. The
    weight-sum row's part (g_0 in u, w g_0 in the prefix: JAX's float32
    `a2` / T_final route, pallas_raster.py:913-915, 972-976), A, the
    transmittance and the geometry sums stay float32."""
    dev = feat_r.device
    nv = feat_r.shape[1] - 6
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    t_total = tiles_x * tiles_y
    e = skeys.shape[0]
    rank = skeys & ((1 << rank_bits) - 1)
    out = torch.zeros((e, 6 + nv), dtype=torch.float32, device=dev)
    g_t = _to_tiles(grad, tiles_x, tiles_y)                    # (T, 1+nv, P)
    a_t = (g_t * _to_tiles(img, tiles_x, tiles_y)).sum(1)      # (T, P)
    # Pixels outside the image get stop 0: no entry is ever before it.
    stop_t = _to_tiles(stop[None].long(), tiles_x, tiles_y)[:, 0]
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    for b0 in range(0, t_total, PLAIN_TILE_BATCH):
        tids = torch.arange(b0, min(b0 + PLAIN_TILE_BATCH, t_total),
                            device=dev)
        s = starts[tids].long()
        en = ends[tids].long()
        st = stop_t[tids]                                      # (B, P)
        longest = int((st.amax(dim=1) - s).max())
        px, py = _batch_pixels(tids, tiles_x)
        gb = g_t[tids]
        ab = a_t[tids][:, :, None]
        log_t = torch.zeros(st.shape, dtype=torch.float32, device=dev)
        prefix = torch.zeros(st.shape, dtype=torch.float32, device=dev)
        for c0 in range(0, longest, PLAIN_CHUNK):
            pos = s[:, None] + c0 + lane                       # (B, K)
            valid = pos < en[:, None]
            f, dx, dy, ep, raw, alpha = _chunk_alpha(feat_r, rank, pos,
                                                     valid, px, py)
            before = pos[:, None, :] < st[:, :, None]          # (B, P, K)
            alpha = torch.where(before, alpha, torch.zeros_like(alpha))
            l1m = torch.log1p(-alpha)
            log_t_after = log_t[:, :, None] + torch.cumsum(l1m, dim=2)
            t_before = torch.exp(log_t_after - l1m)
            w = alpha * t_before
            if bf16_ops:
                u_v, terms, dval = bf16_replay_products(gb[:, 1:], f[:, :, 6:],
                                                        w)
                g0 = gb[:, 0, :, None]                         # (B, P, 1)
                u = g0 + u_v
                pre = prefix[:, :, None] + torch.cumsum(terms + w * g0,
                                                        dim=2)
            else:
                vals = torch.cat([torch.ones_like(f[:, :, :1]), f[:, :, 6:]],
                                 dim=2)                        # (B, K, 1+nv)
                u = torch.einsum("bvp,bkv->bpk", gb, vals)
                pre = prefix[:, :, None] + torch.cumsum(w * u, dim=2)
            ok = (alpha > 0) & (raw < ALPHA_MAX)
            dalpha = torch.where(ok, t_before * u - (ab - pre) / (1.0 - alpha),
                                 torch.zeros_like(alpha))
            dpow = dalpha * alpha
            ca, cb, cc = (f[:, None, :, 2], f[:, None, :, 3],
                          f[:, None, :, 4])
            geo = torch.stack([
                (dpow * (ca * dx + cb * dy)).sum(1),
                (dpow * (cb * dx + cc * dy)).sum(1),
                (-0.5 * dpow * dx * dx).sum(1),
                (-dpow * dx * dy).sum(1),
                (-0.5 * dpow * dy * dy).sum(1),
                (dalpha * ep).sum(1)], dim=2)                  # (B, K, 6)
            if not bf16_ops:
                dval = torch.einsum("bpk,bvp->bkv", w, gb[:, 1:])  # (B,K,nv)
            rows = torch.cat([geo, dval], dim=2)
            out[perm[pos[valid]]] = rows[valid]
            log_t = log_t_after[:, :, -1]
            prefix = pre[:, :, -1]
    return out


def bwd_warp_steps(skeys, starts, ends, feat_r, stop, rank_bits: int,
                   width: int, height: int):
    """The backward replay's work per warp (one 32-pixel row of a tile),
    counted with the plain replay's alpha: (live, walked) = the (warp,
    entry) steps in which some lane of the warp has a live pair before its
    stop (the steps that run a reduction), and the steps up to the largest
    stop among the warp's pixels."""
    dev = feat_r.device
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    t_total = tiles_x * tiles_y
    rank = skeys & ((1 << rank_bits) - 1)
    # Pixels outside the image get stop 0: no entry is ever before it.
    stop_t = _to_tiles(stop[None].long(), tiles_x, tiles_y)[:, 0]
    lane = torch.arange(PLAIN_CHUNK, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, t_total, PLAIN_TILE_BATCH):
        tids = torch.arange(b0, min(b0 + PLAIN_TILE_BATCH, t_total),
                            device=dev)
        s = starts[tids].long()
        en = ends[tids].long()
        st = stop_t[tids]                                      # (B, P)
        warp_stop = st.reshape(len(tids), TILE_PX, TILE_PX).amax(dim=2)
        walked += (warp_stop - s[:, None]).clamp(min=0).sum()
        longest = int((st.amax(dim=1) - s).max())
        px, py = _batch_pixels(tids, tiles_x)
        for c0 in range(0, longest, PLAIN_CHUNK):
            pos = s[:, None] + c0 + lane                       # (B, K)
            valid = pos < en[:, None]
            alpha = _chunk_alpha(feat_r, rank, pos, valid, px, py)[-1]
            hit = (alpha > 0) & (pos[:, None, :] < st[:, :, None])
            live += hit.reshape(len(tids), TILE_PX, TILE_PX, -1).any(
                dim=2).sum()
    return int(live), int(walked)


def composite_bwd(skeys, perm, starts, ends, feat_r, img, stop, grad,
                  rank_bits: int, width: int, height: int,
                  bf16_ops: bool = False):
    """The training forward's inputs and residuals ((1 + nv, H, W) image,
    (H, W) int32 stop), the (E,) int64 sort permutation and the image's
    cotangent `grad` -> (E, 6 + nv) float32 per-entry gradient rows at the
    entries' pre-sort slots (zero where no pixel reached the entry).
    bf16_ops: the replay's products with JAX's TPU rounding (see
    composite_bwd_plain); on the card the kernel's second build, counted
    as `composite_bwd_bf16`."""
    if feat_r.device.type == "cpu":
        return composite_bwd_plain(skeys, perm, starts, ends, feat_r, img,
                                   stop, grad, rank_bits, width, height,
                                   bf16_ops=bf16_ops)
    _cuda_only("composite_bwd", feat_r)
    tiles_x, tiles_y, nv = _compositor_shapes(
        "composite_bwd", skeys, starts, ends, feat_r, width, height)
    e = skeys.shape[0]
    _same_cuda_device(feat_r, perm, img, stop, grad)
    _check(perm, "perm", torch.int64, (e,))
    _check(img, "img", torch.float32, (1 + nv, height, width))
    _check(stop, "stop", torch.int32, (height, width))
    _check(grad, "grad", torch.float32, (1 + nv, height, width))
    out = torch.zeros((e, 6 + nv), dtype=torch.float32, device=feat_r.device)
    name = "composite_bwd_bf16" if bf16_ops else "composite_bwd"
    _launch(name,
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P,
             _P],
            (skeys.data_ptr(), perm.data_ptr(), starts.data_ptr(),
             ends.data_ptr(), feat_r.data_ptr(), nv, rank_bits, tiles_x,
             tiles_y, width, height, ALPHA_MIN, ALPHA_MAX, img.data_ptr(),
             stop.data_ptr(), grad.data_ptr(), out.data_ptr()),
            feat_r.device, source="composite_bwd")
    return out


# --- segsum ------------------------------------------------------------------


def segsum_plain(vals, seg_start, seg_end):
    """Plain PyTorch segment sum: differences of a float64 running sum of
    the rows at the segment bounds."""
    csum = torch.cat([vals.new_zeros((1, vals.shape[1]), dtype=torch.float64),
                      torch.cumsum(vals.double(), dim=0)])
    return (csum[seg_end.long()] - csum[seg_start.long()]).to(torch.float32)


def segsum(vals, seg_start, seg_end):
    """(E, C) float32 slot rows, (N,) int32 segment bounds -> (N, C) float32
    with row r = sum of vals[seg_start[r]:seg_end[r]]. The kernel takes the
    segments in rank order, none overlapping the next (as alloc_prologue
    makes them)."""
    if vals.device.type == "cpu":
        return segsum_plain(vals, seg_start, seg_end)
    _cuda_only("segsum", vals)
    e, cols = vals.shape
    n = seg_start.shape[0]
    if not 1 <= cols <= FEAT - 1:
        raise ValueError(f"segsum: {cols} columns (max {FEAT - 1})")
    _same_cuda_device(vals, seg_start, seg_end)
    _check(vals, "vals", torch.float32, (e, cols))
    _check(seg_start, "seg_start", torch.int32, (n,))
    _check(seg_end, "seg_end", torch.int32, (n,))
    if vals.data_ptr() % 16:
        raise ValueError("vals: must be 16-byte aligned")
    out = torch.empty((n, cols), dtype=torch.float32, device=vals.device)
    _launch("segsum", [_P, _P, _P, _I, _I, _P],
            (vals.data_ptr(), seg_start.data_ptr(), seg_end.data_ptr(), n,
             cols, out.data_ptr()), vals.device)
    return out


# The rasterizer's five kernel wrappers, each with its `<name>_plain`.
KERNELS = ("decode_cull", "composite_fwd", "composite_train_fwd",
           "composite_bwd", "segsum")


@contextlib.contextmanager
def plain_kernels():
    """Route the five kernel wrappers to their plain versions for the
    duration, on any device (the all-plain reference path)."""
    mod = globals()
    saved = {k: mod[k] for k in KERNELS}
    try:
        for k in KERNELS:
            mod[k] = mod[k + "_plain"]
        yield
    finally:
        mod.update(saved)


# --- the rasterizers -------------------------------------------------------


def alloc_prologue(splats: Splats2D, width: int, height: int,
                   budget: int) -> EntryPlan:
    """Exact-entry allocation (the `_alloc_entries` prologue,
    pallas_raster.py:239-323): each visible splat gets exactly its capped
    covered-rect area of slots, in depth-rank order."""
    n = splats.xy.shape[0]
    dev = splats.xy.device
    tile = TILE_PX
    tiles_x, tiles_y = num_tiles(width, height, tile)
    t_total = tiles_x * tiles_y
    e = budget
    cap = min(MAX_SPAN, 1 << 14)
    if n * cap >= 2 ** 31:
        raise ValueError("int32 allocation-offset overflow")
    if e >= 1 << 24:
        raise ValueError("entry budget exceeds exact-f32 offset range")
    rx, ry, sx, _, count = capped_rect(splats, tiles_x, tiles_y, tile, cap)
    # Alpha floor in conic-quadratic units: alpha = o exp(-q/2) >= 1/255
    # iff q <= 2 log(255 o) (renderCUDA's min-alpha skip, exactly).
    q_max = 2.0 * torch.log(torch.clamp(splats.opacity, min=1e-12) * 255.0)

    order = torch.argsort(splats.depth, stable=True)   # rank -> original
    count_r = count[order].to(torch.int32)
    offs_r = torch.cumsum(count_r, 0, dtype=torch.int32) - count_r
    total = (offs_r[-1] + count_r[-1] if n else
             torch.zeros((), dtype=torch.int32, device=dev))

    # Slot ownership, as JAX's running max of rank marks placed at the
    # offsets of the non-empty ranks (`mark.at[scat].max` + cummax): marks
    # sit at distinct, increasing offsets with increasing ranks, so the
    # running max at slot s is the rank of the last mark at or before s,
    # i.e. the c-th marking rank, c = the count of marks up to s (0 where
    # there is none). Two cumsums and a gather replace the E-scale cummax
    # (torch's cummax with indices took 4.5 ms of a 7.4 ms render on an
    # H100 at E = 1.8M).
    marking = (count_r > 0) & (offs_r < e)
    nth = torch.cumsum(marking, 0, dtype=torch.int32) - 1
    ranks = torch.arange(n, dtype=torch.int32, device=dev)
    marked = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    marked.scatter_(0, torch.where(marking, nth, n).long(), ranks)
    hits = torch.zeros((e + 1,), dtype=torch.int32, device=dev)
    hits.scatter_(0, torch.where(marking, offs_r, e).long(),
                  torch.ones_like(ranks))
    seen = torch.cumsum(hits[:e], 0, dtype=torch.int32)
    owner = torch.where(seen > 0, marked[(seen - 1).clamp(min=0).long()],
                        torch.zeros_like(seen))

    geo_r = torch.stack([splats.xy[:, 0], splats.xy[:, 1],
                         splats.conic[:, 0], splats.conic[:, 1],
                         splats.conic[:, 2], q_max], dim=1)[order]
    rect_r = torch.stack([offs_r, torch.clamp(sx, min=1)[order],
                          rx[order], ry[order]], dim=1)
    # The segments the backward sums over (JAX's N-scale seg_end,
    # pallas_raster.py:312-322): every slot of [offs_r, offs_r + count_r)
    # within the budget belongs to rank r; slots past the demand are culled.
    seg_start = torch.clamp(offs_r, max=e)
    seg_end = torch.clamp(offs_r + count_r, max=e)
    return EntryPlan(owner, total, geo_r.contiguous(), rect_r.contiguous(),
                     order, tiles_x, t_total, key_rank_bits(n, t_total),
                     seg_start, seg_end)


def sorted_stream(keys, t_total: int, rank_bits: int,
                  with_perm: bool = False):
    """Sorted keys and per-tile segment bounds [starts[t], ends[t]); with
    with_perm=True also the sort's (E,) int64 permutation (each sorted
    entry's pre-sort slot)."""
    srt = torch.sort(keys)
    skeys = srt.values
    bounds = torch.arange(t_total + 1, dtype=torch.int64,
                          device=keys.device) << rank_bits
    b = torch.searchsorted(skeys, bounds, out_int32=True)
    out = (skeys, b[:-1].contiguous(), b[1:].contiguous())
    return out + (srt.indices,) if with_perm else out


def entry_features(splats: Splats2D, order, with_color: bool,
                   with_depth: bool) -> torch.Tensor:
    """(N, 6 + nv) rank-ordered compositor rows [x, y, a, b, c, opacity,
    depth?, colours?]."""
    cols = [splats.xy, splats.conic, splats.opacity[:, None]]
    if with_depth:
        cols.append(splats.depth[:, None])
    if with_color:
        cols.append(splats.color)
    return torch.cat(cols, dim=1)[order].contiguous()


def rasterize_fwd(
    splats: Splats2D,
    width: int,
    height: int,
    bg: Optional[torch.Tensor] = None,
    entry_budget: int = 0,
    with_color: bool = True,
    with_depth: bool = True,
) -> RasterOut:
    """Non-differentiable forward rasterization (rasterize_pallas_fwd):
    with_color=False => color is None; with_depth=False => depth is None.
    Returns RasterOut with the entries_total / entries_alive telemetry."""
    c = splats.color.shape[1] if with_color else 0
    if 7 + c + int(with_depth) > FEAT:
        raise ValueError("too many color channels")
    if entry_budget <= 0:
        entry_budget = default_budget(splats.xy.shape[0])
    if entry_budget % CHUNK:
        raise ValueError("entry_budget must be 128-aligned")

    with torch.no_grad():
        plan = alloc_prologue(splats, width, height, int(entry_budget))
        keys, alive = decode_cull(plan)
        skeys, starts, ends = sorted_stream(keys, plan.t_total,
                                            plan.rank_bits)
        feat_r = entry_features(splats, plan.order, with_color, with_depth)
        img = composite_fwd(skeys, starts, ends, feat_r, plan.rank_bits,
                            width, height)
    alpha = img[0]
    vi = 1
    depth = None
    if with_depth:
        depth = img[vi]
        vi += 1
    color = None
    if with_color:
        color = img[vi:vi + c]
        if bg is not None:
            color = color + (1.0 - alpha)[None] * bg[:, None, None]
    return RasterOut(color=color, depth=depth, alpha=alpha,
                     radii=splats.radius, entries_total=plan.total,
                     entries_alive=alive)


class _Composite(torch.autograd.Function):
    """feat_r (N, 6 + nv) -> (1 + nv, H, W) image through the training
    compositor; the backward runs composite_bwd and segsum (JAX's
    custom_vjp `comp`, pallas_raster.py:1385-1523). The residual is the
    image itself plus the per-pixel stop: only the weight-sum, depth and
    colour rows reach a loss, so the 16 packed accumulators and T_final
    that the TPU kernel keeps are not needed. With with_contrib it also
    returns the per-pixel count of included entries (not differentiable)."""

    @staticmethod
    def forward(ctx, feat_r, skeys, perm, starts, ends, seg_start, seg_end,
                rank_bits: int, width: int, height: int,
                with_contrib: bool = False):
        img, stop, *contrib = composite_train_fwd(
            skeys, starts, ends, feat_r, rank_bits, width, height,
            with_contrib)
        ctx.save_for_backward(feat_r, skeys, perm, starts, ends, seg_start,
                              seg_end, img, stop)
        ctx.geometry = (rank_bits, width, height)
        if not with_contrib:
            return img
        ctx.mark_non_differentiable(contrib[0])
        return img, contrib[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad, *_):
        (feat_r, skeys, perm, starts, ends, seg_start, seg_end, img,
         stop) = ctx.saved_tensors
        rank_bits, width, height = ctx.geometry
        d_ent = composite_bwd(skeys, perm, starts, ends, feat_r, img, stop,
                              grad.contiguous(), rank_bits, width, height)
        return (segsum(d_ent, seg_start, seg_end),) + (None,) * 10


def rasterize(
    splats: Splats2D,
    width: int,
    height: int,
    bg: Optional[torch.Tensor] = None,
    entry_budget: int = 0,
    with_contrib: bool = False,
):
    """Differentiable rasterization (rasterize_pallas): colour, depth and
    alpha (the weight sum) are differentiable in every splat field that
    reaches the compositor (xy, conic, opacity, depth, colour) and in bg.
    The prologue, decode_cull and the key sort run without gradient, as
    JAX's stop_gradient does. Returns RasterOut with the entries_total /
    entries_alive telemetry (entries_total > entry_budget: entries were
    cropped); with_contrib (the lift: 8 colour channels) returns
    (RasterOut, (H, W) int32 count of each pixel's included entries)."""
    c = splats.color.shape[1]
    if c > FEAT - 8:
        raise ValueError(f"at most {FEAT - 8} colour channels")
    if entry_budget <= 0:
        entry_budget = default_budget(splats.xy.shape[0])
    if entry_budget % CHUNK:
        raise ValueError("entry_budget must be 128-aligned")

    with torch.no_grad():
        plan = alloc_prologue(splats, width, height, int(entry_budget))
        keys, alive = decode_cull(plan)
        skeys, starts, ends, perm = sorted_stream(
            keys, plan.t_total, plan.rank_bits, with_perm=True)
    feat_r = entry_features(splats, plan.order, True, True)
    res = _Composite.apply(feat_r, skeys, perm, starts, ends, plan.seg_start,
                           plan.seg_end, plan.rank_bits, width, height,
                           with_contrib)
    img, contrib = res if with_contrib else (res, None)
    alpha = img[0]
    color = img[2:2 + c]
    if bg is not None:
        color = color + (1.0 - alpha)[None] * bg[:, None, None]
    out = RasterOut(color=color, depth=img[1], alpha=alpha,
                    radii=splats.radius, entries_total=plan.total,
                    entries_alive=alive)
    return (out, contrib) if with_contrib else out
