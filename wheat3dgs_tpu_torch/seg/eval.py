"""Depth-resolved 2D projection of 3D instance labels.

Counterpart of wheat3dgs_tpu/seg/eval.py (reference eval_obj_labels,
utils/wheatgs_helper.py:245-271 / eval_wheatgs.py:29-55): one alpha + depth
render per head, then the sequential overlap combine in ascending head
order: alpha > 0.5 claims a pixel, and a head that overlaps pixels already
claimed wins them only if its mean depth over the overlap is smaller. The
JAX lax.map over heads is a Python loop here, on either backend; the
combine stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import GaussianState
from ..render.pipeline import RasterConfig, render_fwd
from . import flashsplat


@torch.no_grad()
def eval_obj_labels(state: GaussianState, obj_labels, w2c, full_proj,
                    cam_center, tanfovx, tanfovy, *, width: int, height: int,
                    config: RasterConfig = RasterConfig(),
                    head_batch: int = 8, with_areas: bool = False,
                    nonempty=None):
    """obj_labels: (L+1, cap) bool membership (row 0 = background, not
    drawn). Returns the (H, W) int32 map of head ids; with_areas=True also
    returns the (L+1,) int32 AMODAL footprint per row (alpha > 0.5 pixels
    of the row rendered alone, before depth resolution), which the
    synthetic-mask generator's visibility gate reads.

    nonempty: the rows' `any()` as a host list, for callers that render
    many views of the same labels; computed here when None (a host read,
    which waits for the device).

    head_batch: JAX's heads per lax.map batch on its XLA backend, a memory
    knob that does not change the result; the port renders one head at a
    time on either backend, so it only checks the value."""
    if head_batch < 1:
        raise ValueError(f"head_batch {head_batch} < 1")
    dev = state.device
    labels = torch.as_tensor(obj_labels, device=dev).to(torch.bool)
    l1 = labels.shape[0]
    pred = torch.zeros((height, width), dtype=torch.int32, device=dev)
    min_depth = torch.ones((height, width), dtype=torch.float32, device=dev)
    areas = torch.zeros((l1,), dtype=torch.int32, device=dev)
    # Empty rows render nothing: skipped (their area is 0).
    if nonempty is None:
        nonempty = labels.any(dim=1).tolist()
    for obj in range(l1):
        if not nonempty[obj] or (obj == 0 and not with_areas):
            continue
        out = render_fwd(state, w2c, full_proj, cam_center, tanfovx,
                         tanfovy, width, height, 0, used_mask=labels[obj],
                         config=config, with_color=False, with_depth=True)
        pix = out.alpha > 0.5
        areas[obj] = pix.sum(dtype=torch.int32)
        if obj == 0:
            continue
        claimed = pred > 0
        overlap = pix & claimed
        n_overlap = overlap.sum()
        denom = n_overlap.clamp(min=1).to(torch.float32)
        old_mean = (min_depth * overlap).sum() / denom
        new_mean = (out.depth * overlap).sum() / denom
        keep_old = (n_overlap > 0) & (old_mean < new_mean)
        pix = torch.where(keep_old, pix & ~claimed, pix)
        pred = torch.where(pix, torch.full_like(pred, obj), pred)
        min_depth = torch.where(pix, out.depth, min_depth)
    if with_areas:
        return pred, areas
    return pred


def labels_from_seg_maps(state: GaussianState, cams, seg_maps, width: int,
                         height: int, config: RasterConfig = RasterConfig(),
                         obj_num=None):
    """Rebuild global per-Gaussian labels from saved per-view 2DSeg maps
    (reference eval_wheatgs.py render_sets :96-117): multi-label
    used_counts summed over the views of the stacked `cams`, then
    multi_instance_opt. Returns numpy (all_counts (L+1, N), all_obj_labels
    (L+1, N) bool)."""
    if obj_num is None:
        obj_num = int(max(int(np.max(m)) for m in seg_maps))
    all_counts = None
    for i in range(cams[0].shape[0]):
        out = flashsplat.lift_view(
            state, *(c[i] for c in cams),
            torch.as_tensor(np.asarray(seg_maps[i], np.int32)),
            num_obj=obj_num, width=width, height=height, config=config,
            with_contrib=False)
        all_counts = (out.used_count if all_counts is None
                      else all_counts + out.used_count)
    labels = flashsplat.multi_instance_opt(all_counts, 0.0)
    return all_counts.cpu().numpy(), labels.cpu().numpy()
