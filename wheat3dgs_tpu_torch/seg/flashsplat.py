"""FlashSplat lifting and the find-&-match association renders on a
GaussianState (reference: gaussian_renderer flashsplat_render plumbing and
the run_3d_seg.py helpers).

Counterpart of wheat3dgs_tpu/seg/flashsplat.py:
- `lift_view`: one view's (label, Gaussian) contribution counts;
- `lift_batch8`: 8 bit-packed masks of one view lifted in one render
  forward + backward (the VJP of an 8-channel override-colour render);
- `alpha_views`, `match_views_packed`, `predbits_views`: a loop over views
  of alpha-only `render_fwd` renders of a Gaussian subset. The
  association step thresholds each render at alpha > 0.5 and intersects it
  with the view's bit-packed SAM masks on the device; only per-view
  scalars (or the packed prediction bits) go to the host.
The JAX package vmaps / lax.maps over the camera batch; the port loops.
Each function renders with the backend its config names. On "xla" the
renders report no entry demand: the association steps return -1 for its
maximum (JAX returns 0), so callers retry on overflow only on "pallas".
JAX's lift_view always lifts on its padded-tile path; the port's lifts on
the entry stream unless the config is "xla".
"""

from __future__ import annotations

import torch

from ..models.gaussians import GaussianState
from ..ops import mask_lift
from ..ops.projection import project_gaussians
from ..render.pipeline import RasterConfig, render, render_fwd

multi_instance_opt = mask_lift.multi_instance_opt

# Bit i of a packed byte, most significant first (np.packbits order).
_SHIFTS = torch.arange(7, -1, -1, dtype=torch.int32)
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32)


def _project(state: GaussianState, w2c, full_proj, cam_center, tanfovx,
             tanfovy, width, height):
    with torch.no_grad():
        return project_gaussians(
            state.params.means, state.scales(), state.params.quats,
            state.opacity(), w2c, full_proj, cam_center, tanfovx, tanfovy,
            width, height,
            colors=torch.zeros((state.capacity, 1), dtype=torch.float32,
                               device=state.device))


def lift_view(state: GaussianState, w2c, full_proj, cam_center, tanfovx,
              tanfovy, gt_mask, *, num_obj: int, width: int, height: int,
              config: RasterConfig = RasterConfig(),
              with_contrib: bool = True) -> mask_lift.LiftOut:
    """used_count for one view and an (H, W) label image (reference
    opt_label_w_seg inner call, run_3d_seg.py:92-97); with_contrib as in
    mask_lift.lift_mask. An "xla" config lifts per tile with its tile
    fields (contrib_num always filled)."""
    splats = _project(state, w2c, full_proj, cam_center, tanfovx, tanfovy,
                      width, height)
    gt = torch.as_tensor(gt_mask, device=state.device)
    if config.backend == "xla":
        return mask_lift.lift_mask_tiles(
            splats, gt, num_obj, width, height, config.tile,
            config.max_tiles_per_gauss, config.max_per_tile,
            config.tile_batch)
    return mask_lift.lift_mask(splats, gt, num_obj, width, height,
                               entry_budget=config.entry_budget,
                               with_contrib=with_contrib)


def lift_batch8(state: GaussianState, w2c, full_proj, cam_center, tanfovx,
                tanfovy, mask_bits8, *, width: int, height: int,
                config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """FlashSplat-lift 8 masks of one view in one forward + backward pass:
    (8, ceil(H*W/8)) uint8 bit-packed masks (np.packbits order) -> (8, N)
    float32 counts, used_count[m, i] = sum_{p in mask_m} w_{p,i} (the
    gradient of sum(masks * render(override_color=c).color) in c at c = 0;
    see ops/mask_lift.py). On "xla" that gradient is autograd's through
    the padded-tile render, as JAX's."""
    bits = torch.as_tensor(mask_bits8, device=state.device)
    if bits.shape[0] != mask_lift.LABELS_PER_PASS:
        raise ValueError(f"lift_batch8: expected 8 masks, got {bits.shape[0]}")
    planes = _unpack_bits(bits, width * height).reshape(-1, height, width)
    if config.backend == "xla":
        with torch.enable_grad():
            colors = torch.zeros((state.capacity, bits.shape[0]),
                                 dtype=torch.float32, device=state.device,
                                 requires_grad=True)
            out = render(state, w2c, full_proj, cam_center, tanfovx,
                         tanfovy, width, height, 0, override_color=colors,
                         config=config)
            (g,) = torch.autograd.grad(out.color, colors,
                                       grad_outputs=planes)
        return g.T
    splats = _project(state, w2c, full_proj, cam_center, tanfovx, tanfovy,
                      width, height)
    counts, _ = mask_lift.lift_planes(splats, planes, width, height,
                                      entry_budget=config.entry_budget)
    return counts


def _subset_render(state, cam, used_mask, width, height, config):
    return render_fwd(state, *cam, width, height, 0, used_mask=used_mask,
                      config=config, with_color=False, with_depth=False)


def _max_total(totals, dev) -> torch.Tensor:
    """The largest of the renders' entries_total; -1 where they report
    none."""
    if totals[0] is None:
        return torch.full((), -1, dtype=torch.int32, device=dev)
    return torch.stack(totals).max()


def alpha_views(state: GaussianState, w2c, full_proj, cam_center, tanfovx,
                tanfovy, used_mask, *, width: int, height: int,
                config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """(B, H, W) alpha of the `used_mask` subset in each camera of a stacked
    batch (reference flashsplat_render(used_mask=...) alpha,
    run_3d_seg.py:130-134): alpha-only forward renders."""
    used = torch.as_tensor(used_mask, device=state.device)
    cams = (w2c, full_proj, cam_center, tanfovx, tanfovy)
    return torch.stack([
        _subset_render(state, [c[i] for c in cams], used, width, height,
                       config).alpha for i in range(w2c.shape[0])])


def apply_pts_filter(all_counts: torch.Tensor, pts_filter) -> torch.Tensor:
    """Zero the non-background rows of filtered (below-canopy) Gaussians
    (reference opt_label_w_seg tail, run_3d_seg.py:101-105)."""
    keep = ~torch.as_tensor(pts_filter, device=all_counts.device)
    out = all_counts.clone()
    out[1:] *= keep[None, :].to(all_counts.dtype)
    return out


def _pack_bits(pred: torch.Tensor) -> torch.Tensor:
    """(H, W) bool -> (ceil(H*W/8),) uint8 in np.packbits(axis=None) order
    (row-major, first pixel in the most significant bit, zero-padded tail
    byte)."""
    flat = pred.reshape(-1).to(torch.int32)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = _SHIFTS.to(flat.device)
    return (flat.reshape(-1, 8) << shifts).sum(dim=1).to(torch.uint8)


def _unpack_bits(bits: torch.Tensor, n_pix: int) -> torch.Tensor:
    """(..., B8) uint8 -> (..., n_pix) float32 in {0, 1}."""
    shifts = _SHIFTS.to(bits.device)
    u = (bits.to(torch.int32)[..., None] >> shifts) & 1
    return u.reshape(bits.shape[:-1] + (-1,))[..., :n_pix].to(torch.float32)


def _bbox_device(pred: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """(H, W) bool -> (4,) int32 [x0, y0, x1, y1] (meaningless when pred
    is empty: callers gate on the area, as image_ops.get_bbox_from_mask's
    None)."""
    ys = pred.any(dim=1).to(torch.int32)
    xs = pred.any(dim=0).to(torch.int32)
    y0 = torch.argmax(ys)
    y1 = height - 1 - torch.argmax(torch.flip(ys, (0,)))
    x0 = torch.argmax(xs)
    x1 = width - 1 - torch.argmax(torch.flip(xs, (0,)))
    return torch.stack([x0, y0, x1, y1]).to(torch.int32)


def _popcount_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Set bits of a & b along the last axis (a 256-entry table gathered
    per byte): int32."""
    table = _POPCOUNT.to(a.device)
    return table[(a & b).long()].sum(dim=-1, dtype=torch.int32)


@torch.no_grad()
def match_views_packed(state: GaussianState, w2c, full_proj, cam_center,
                       tanfovx, tanfovy, counts, mask_bits, *, width: int,
                       height: int, config: RasterConfig = RasterConfig()):
    """One find-&-match association step over a stacked camera batch.

    counts: (2, N) additive FlashSplat counts of the current candidate;
    mask_bits: (B, M, B8) uint8 bit-packed SAM masks per view, on the
    device. Returns device tensors (used_mask (N,) bool, inter (B, M)
    int32 intersection pixel counts with each mask, pred_area (B,) int32,
    bbox (B, 4) int32, entries_max 0-d int32: the largest entries_total of
    the renders, for overflow detection; -1 on "xla").

    Reference semantics: used_mask = multi_instance_opt row 1
    (run_3d_seg.py:107-114); per view, pred_seg = subset alpha > 0.5 and
    its seg-IoU with every mask (run_3d_seg.py:130-156), finished on the
    host from (inter, pred_area, mask areas)."""
    used = multi_instance_opt(torch.as_tensor(counts, device=state.device))[1]
    cams = (w2c, full_proj, cam_center, tanfovx, tanfovy)
    inter, area, bbox, totals = [], [], [], []
    for i in range(w2c.shape[0]):
        out = _subset_render(state, [c[i] for c in cams], used, width,
                             height, config)
        pred = out.alpha > 0.5
        area.append(pred.sum(dtype=torch.int32))
        bbox.append(_bbox_device(pred, width, height))
        inter.append(_popcount_and(_pack_bits(pred)[None, :], mask_bits[i]))
        totals.append(out.entries_total)
    return (used, torch.stack(inter), torch.stack(area), torch.stack(bbox),
            _max_total(totals, state.device))


@torch.no_grad()
def predbits_views(state: GaussianState, w2c, full_proj, cam_center,
                   tanfovx, tanfovy, used_mask, *, width: int, height: int,
                   config: RasterConfig = RasterConfig()):
    """(B, ceil(H*W/8)) uint8 bit-packed pred-seg (alpha > 0.5) of the
    used_mask subset in every view and the largest entries_total (-1 on
    "xla"): the per-head 2D projection (run_3d_seg.py:351-377) as packed
    bits."""
    used = torch.as_tensor(used_mask, device=state.device)
    cams = (w2c, full_proj, cam_center, tanfovx, tanfovy)
    bits, totals = [], []
    for i in range(w2c.shape[0]):
        out = _subset_render(state, [c[i] for c in cams], used, width,
                             height, config)
        bits.append(_pack_bits(out.alpha > 0.5))
        totals.append(out.entries_total)
    return torch.stack(bits), _max_total(totals, state.device)
