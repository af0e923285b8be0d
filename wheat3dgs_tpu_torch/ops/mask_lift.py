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

The port builds it that way, LABELS_PER_PASS label planes per pass through
the differentiable `rasterize` (its composite_train_fwd, composite_bwd and
segsum kernels at 1 + LABELS_PER_PASS value rows: depth and the label
channels), as the JAX package's seg/flashsplat.py::lift_batch8 does. The
JAX `lift_mask` computes the same counts with a per-tile matmul in its XLA
rasterizer.

contrib_num, the count of splats with a nonzero blending weight at each
pixel (alpha >= 1/255 before the pixel's stop), comes from the first
pass's training compositor: the weights do not depend on the colours, so
every pass gives the same count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda_raster import rasterize
from .projection import Splats2D

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
              width: int, height: int, entry_budget: int = 0,
              with_contrib: bool = True) -> LiftOut:
    """gt_mask: (H, W) int labels in [0, num_obj], 0 = background.
    ceil((num_obj + 1) / LABELS_PER_PASS) render passes. with_contrib=False
    leaves contrib_num None, for callers that read only the counts: the
    first pass then runs the compositor's build without the count."""
    labels = torch.arange(num_obj + 1, device=gt_mask.device)
    planes = (gt_mask.long()[None] == labels[:, None, None]).to(
        torch.float32)
    used, alpha, *contrib = lift_planes(splats, planes, width, height,
                                        entry_budget, with_contrib)
    return LiftOut(used_count=used, alpha=alpha,
                   contrib_num=contrib[0] if contrib else None,
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
