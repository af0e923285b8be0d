"""Plain PyTorch projection, SH colour and per-pixel compositing.

The published rasterizer's semantics (diff-gaussian-rasterization's
preprocess and renderCUDA), written per pixel over each tile's splats in
depth order:

- a splat is culled at view depth <= 0.2, for a singular 2D covariance or
  for an empty tile rectangle; its screen radius is ceil(3 sqrt(lambda1));
- the 2D covariance is J W Sigma W^T J^T with the t.x/t.z clamp at
  1.3 tan(fov), plus 0.3 on the diagonal;
- pixel p takes splat s when p's 32-pixel tile lies in s's radius
  rectangle, power = -0.5 (a dx^2 + c dy^2) - b dx dy <= 0 and
  alpha = min(0.99, o e^power) >= 1/255; it stops before the splat that
  would bring its transmittance under 1e-4;
- colour = sum of w c + T_final bg, with c from the SH of the view direction
  (+0.5, clamped at 0).

`render` builds the (tile, splat) pairs, sorts them by tile and depth rank
and composites batches of tiles of similar length, 32 splats in the first
step and twice as many in each next one up to CHUNK, each step on the
tiles that still have an open pixel,
with autograd (each batch checkpointed, so a full-width view fits) or
without it. It also counts the weighted (pixel, splat) pairs: those with
alpha >= 1/255 before the pixel's stop, the work any implementation of
the step has to do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

TILE = 32
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOG_T_EPS = math.log(T_EPS)
NEAR = 0.2
CHUNK = 256              # splats composited per step of a tile batch
FIRST_CHUNK = 32         # the first step's (steps double up to CHUNK)
BATCH_ELEMS = 1 << 24    # tiles x pixels x splats per step (with autograd)
NOGRAD_ELEMS = 1 << 26   # the same without it

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """A pinhole camera; matrices act on column vectors."""

    w2c: torch.Tensor        # (4, 4)
    full_proj: torch.Tensor  # (4, 4) projection @ w2c
    center: torch.Tensor     # (3,)
    tanfovx: float
    tanfovy: float


class Projected(NamedTuple):
    """The visible splats of one view (M of the N given)."""

    index: torch.Tensor      # (M,) int64 rows of the splat table
    xy: torch.Tensor         # (M, 2) pixel centre
    depth: torch.Tensor      # (M,)
    conic: torch.Tensor      # (M, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor    # (M,)
    color: torch.Tensor      # (M, 3)
    rect: torch.Tensor       # (M, 4) int64 tile rectangle x0, y0, x1, y1


class Rendered(NamedTuple):
    image: torch.Tensor      # (3, H, W)
    proj: Projected
    weighted: int            # weighted (pixel, splat) pairs


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) unit (w, x, y, z) quaternions -> (N, 3, 3) rotations."""
    r, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(-1, 3, 3)


def sh_basis(deg: int, d: torch.Tensor) -> torch.Tensor:
    """(M, 3) unit directions -> (M, (deg + 1)^2) real SH basis values."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                SH_C2[4] * (xx - yy)]
    if deg > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy),
                SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=1)


def num_tiles(width: int, height: int):
    return -(-width // TILE), -(-height // TILE)


def project(params: dict, cam: Camera, width: int, height: int,
            sh_degree: int, colors: Optional[torch.Tensor] = None,
            alive: Optional[torch.Tensor] = None) -> Projected:
    """The visible splats of `params` (means, quats, log_scales, sh_dc,
    sh_rest, opacity_logit) in `cam`; colours from the SH at `sh_degree`,
    or the given (N, 3) `colors`; rows where `alive` is False are left
    out."""
    means = params["means"]
    rot_w = cam.w2c[:3, :3]
    p_view = means @ rot_w.T + cam.w2c[:3, 3]
    keep = p_view[:, 2] > NEAR
    if alive is not None:
        keep = keep & alive
    idx = torch.nonzero(keep).squeeze(1)
    means, p_view = means[idx], p_view[idx]
    hom = torch.cat([means, torch.ones_like(means[:, :1])], dim=1)
    p_hom = hom @ cam.full_proj.T
    ndc = p_hom[:, :2] / (p_hom[:, 3:4] + 1e-7)
    q = params["quats"][idx]
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    scales = torch.exp(params["log_scales"][idx])
    m = rotation(q) * scales[:, None, :]                  # R diag(s)
    sigma = m @ m.transpose(1, 2)
    fx = width / (2.0 * cam.tanfovx)
    fy = height / (2.0 * cam.tanfovy)
    tz = p_view[:, 2]
    tx = torch.clamp(p_view[:, 0] / tz, -1.3 * cam.tanfovx,
                     1.3 * cam.tanfovx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -1.3 * cam.tanfovy,
                     1.3 * cam.tanfovy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                       zero, fy / tz, -fy * ty / (tz * tz)],
                      dim=1).reshape(-1, 2, 3)
    t = jac @ rot_w
    cov = t @ sigma @ t.transpose(1, 2)
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    xy = torch.stack([((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
                      ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], dim=1)
    tiles_x, tiles_y = num_tiles(width, height)
    xd = xy.detach()

    def clip(v, hi):
        return torch.clamp(v.to(torch.int64), 0, hi)

    rect = torch.stack([clip((xd[:, 0] - radius) / TILE, tiles_x),
                        clip((xd[:, 1] - radius) / TILE, tiles_y),
                        clip((xd[:, 0] + radius + TILE - 1) / TILE, tiles_x),
                        clip((xd[:, 1] + radius + TILE - 1) / TILE, tiles_y)],
                       dim=1)
    vis = (det.detach() > 0) & (rect[:, 2] > rect[:, 0]) & (
        rect[:, 3] > rect[:, 1])
    sel = torch.nonzero(vis).squeeze(1)
    idx = idx[sel]
    det = det[sel]
    conic = torch.stack([c[sel] / det, -b[sel] / det, a[sel] / det], dim=1)
    opacity = torch.sigmoid(params["opacity_logit"][idx])
    if colors is None:
        k = (sh_degree + 1) ** 2
        coeffs = torch.cat([params["sh_dc"][idx],
                            params["sh_rest"][idx]], dim=1)
        coeffs = coeffs.reshape(len(idx), -1, 3)[:, :k]
        d = means[sel] - cam.center
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        color = torch.clamp(
            torch.einsum("mk,mkc->mc", sh_basis(sh_degree, d), coeffs) + 0.5,
            min=0.0)
    else:
        color = colors[idx]
    return Projected(idx, xy[sel], p_view[sel, 2], conic, opacity, color,
                     rect[sel])


def _pairs(proj: Projected, tiles_x: int):
    """The (tile, splat) pairs sorted by tile and depth rank: (splat of each
    sorted pair, each tile's first pair, each tile's pair count)."""
    m = proj.xy.shape[0]
    dev = proj.xy.device
    rect = proj.rect
    sx = rect[:, 2] - rect[:, 0]
    cnt = sx * (rect[:, 3] - rect[:, 1])
    order = torch.argsort(proj.depth.detach(), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(m, device=dev)
    cnt_o = cnt[order]
    sid = torch.repeat_interleave(order, cnt_o)
    first = torch.cumsum(cnt_o, 0) - cnt_o
    local = torch.arange(sid.shape[0], device=dev) - torch.repeat_interleave(
        first, cnt_o)
    tx = rect[sid, 0] + local % sx[sid]
    ty = rect[sid, 1] + torch.div(local, sx[sid], rounding_mode="floor")
    tile = ty * tiles_x + tx
    key = tile * m + rank[sid]
    sid = sid[torch.argsort(key)]
    return sid, tile


def _composite(feat: torch.Tensor, lists: torch.Tensor, lens: torch.Tensor,
               px: torch.Tensor, py: torch.Tensor, inside: torch.Tensor):
    """Front-to-back compositing of the splat rows `feat` (x, y, a, b, c,
    o, colour...) listed per tile in `lists` ((B, L), -1 padded; `lens`
    long) at the tiles' pixels (B, P), of which those `inside` the image
    count: ((B, P, C) sum of w c, (B, P) log T_final, count of weighted
    pairs). Each step goes on with the tiles that still have a pixel
    inside the image that is open and short of its tile's last splat."""
    b_n, l_n = lists.shape
    p_n = px.shape[1]
    log_t = px.new_zeros((b_n, p_n))       # over every splat: the stop test
    log_t_in = px.new_zeros((b_n, p_n))    # over the included ones
    acc = px.new_zeros((b_n, p_n, feat.shape[1] - 6))
    weighted = torch.zeros((), dtype=torch.int64, device=px.device)
    rows = torch.arange(b_n, device=px.device)
    c0, size = 0, FIRST_CHUNK
    while c0 < l_n:
        if c0:
            going = (((log_t[rows] >= LOG_T_EPS) & inside[rows]).any(1)
                     & (lens[rows] > c0))
            rows = rows[going]
            if rows.numel() == 0:
                break
        idx = lists[rows, c0:c0 + size]
        c0, size = c0 + size, min(2 * size, CHUNK)
        valid = idx >= 0
        f = feat[idx.clamp(min=0)]                          # (R, K, F)
        dx = f[:, None, :, 0] - px[rows][:, :, None]
        dy = f[:, None, :, 1] - py[rows][:, :, None]
        power = (-0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy)
                 - f[:, None, :, 3] * dx * dy)
        ok = (power <= 0.0) & valid[:, None, :] & inside[rows][:, :, None]
        power = torch.where(ok, power, torch.full_like(power, -100.0))
        alpha = torch.clamp(f[:, None, :, 5] * torch.exp(power), max=ALPHA_MAX)
        ok = ok & (alpha >= ALPHA_MIN)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
        l1m = torch.log1p(-alpha)
        cum = log_t[rows][:, :, None] + torch.cumsum(l1m, dim=2)
        inc = cum.detach() >= LOG_T_EPS
        w = torch.where(inc, alpha * torch.exp(cum - l1m),
                        torch.zeros_like(alpha))
        acc = acc.index_add(0, rows, torch.einsum("bpk,bkc->bpc", w,
                                                  f[:, :, 6:]))
        log_t_in = log_t_in.index_add(0, rows, torch.where(
            inc, l1m, torch.zeros_like(l1m)).sum(2))
        log_t = log_t.index_copy(0, rows, cum[:, :, -1])
        weighted = weighted + (inc & ok).sum()
    return acc, log_t_in, weighted


def rasterize(proj: Projected, width: int, height: int,
              bg: Optional[torch.Tensor] = None, grad: bool = False):
    """(3, H, W) image of the projected splats and the weighted-pair
    count. With grad, autograd reaches xy, conic, opacity and colour (each
    tile batch is recomputed in the backward pass)."""
    dev = proj.xy.device
    tiles_x, tiles_y = num_tiles(width, height)
    n_tiles = tiles_x * tiles_y
    n_pix = TILE * TILE
    feat = torch.cat([proj.xy, proj.conic, proj.opacity[:, None],
                      proj.color], dim=1)
    n_col = proj.color.shape[1]
    sid, tile = _pairs(proj, tiles_x)
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.argsort(counts, descending=True)
    lens = counts[by_len].tolist()
    pix = torch.arange(n_pix, device=dev)
    parts, tiles_done = [], []
    weighted = torch.zeros((), dtype=torch.int64, device=dev)
    elems = BATCH_ELEMS if grad else NOGRAD_ELEMS
    i = 0
    while i < n_tiles and lens[i] > 0:
        l_max = lens[i]
        b_n = max(1, elems // (n_pix * min(l_max, CHUNK)))
        tids = by_len[i:i + b_n]
        tids = tids[counts[tids] > 0]
        i += b_n
        j = torch.arange(l_max, device=dev)
        pos = starts[tids][:, None] + j
        lens_b = counts[tids]
        lists = torch.where(j < lens_b[:, None],
                            sid[pos.clamp(max=max(sid.shape[0] - 1, 0))], -1)
        px = ((tids % tiles_x) * TILE)[:, None] + pix % TILE
        py = torch.div(tids, tiles_x, rounding_mode="floor")[:, None] * TILE \
            + torch.div(pix, TILE, rounding_mode="floor")
        inside = (px < width) & (py < height)
        px, py = px.to(torch.float32), py.to(torch.float32)
        if grad:
            acc, log_t, wn = checkpoint(_composite, feat, lists, lens_b, px,
                                        py, inside, use_reentrant=False)
        else:
            with torch.no_grad():
                acc, log_t, wn = _composite(feat, lists, lens_b, px, py,
                                            inside)
        weighted = weighted + wn
        parts.append(torch.cat([acc, torch.exp(log_t)[:, :, None]], dim=2))
        tiles_done.append(tids)
    out = feat.new_zeros((n_tiles, n_pix, n_col + 1))
    out[:, :, n_col] = 1.0
    if parts:
        out = out.index_copy(0, torch.cat(tiles_done), torch.cat(parts))
    img = out.reshape(tiles_y, tiles_x, TILE, TILE, n_col + 1).permute(
        4, 0, 2, 1, 3).reshape(n_col + 1, tiles_y * TILE, tiles_x * TILE)
    img = img[:, :height, :width]
    color = img[:n_col]
    if bg is not None:
        color = color + img[n_col:] * bg[:, None, None]
    return color, int(weighted)


def render(params: dict, cam: Camera, width: int, height: int,
           sh_degree: int, bg: Optional[torch.Tensor] = None,
           colors: Optional[torch.Tensor] = None, grad: bool = False,
           alive: Optional[torch.Tensor] = None) -> Rendered:
    """Project and composite one view (see the module docstring)."""
    proj = project(params, cam, width, height, sh_degree, colors, alive)
    img, weighted = rasterize(proj, width, height, bg, grad)
    return Rendered(img, proj, weighted)
