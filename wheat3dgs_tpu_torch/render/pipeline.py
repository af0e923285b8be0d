"""Render API: GaussianState + camera -> images (reference:
gaussian_renderer/__init__.py `render`, :22-106).

Counterpart of wheat3dgs_tpu/render/pipeline.py: `RasterConfig`,
`inference_config`, `RenderOut`, the differentiable `render` (training),
`render_fwd` (no grad) and the exact-allocation branch of `adapt_config`.
The port has one rasterizer, the budgeted entry stream of
ops/cuda_raster.py (the JAX "pallas" backend).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.gaussians import GaussianState
from ..ops import cuda_raster
from ..ops.binning import capped_rect, num_tiles, pick_entry_budget
from ..ops.cuda_raster import MAX_SPAN, TILE_PX, rasterize, rasterize_fwd
from ..ops.projection import project_gaussians


# Entry budget over the probed demand for inference: all entry-stream cost
# scales with the budget, and overflow is reported, not silent.
INFERENCE_HEADROOM = 1.15


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer knobs.

    entry_budget: static size of the exact-allocation entry array (0 = auto
    16 per Gaussian); adapt_config sizes it from the probed demand, and
    renders report entries_total so overflow is detectable.
    pack_payload: accepted for config compatibility with the JAX package.
    Its bf16 payload packing is a TPU sort optimisation; the port always
    composites exact float32 (the JAX path with pack_payload=False).
    """

    entry_budget: int = 0
    pack_payload: Optional[bool] = None


def inference_config(config: RasterConfig = RasterConfig()) -> RasterConfig:
    """The config inference paths render with. The JAX package switches to
    its Pallas backend here; the port has only that path, so the config
    passes through unchanged."""
    return config


class RenderOut(NamedTuple):
    color: Optional[torch.Tensor]   # (3, H, W)
    depth: Optional[torch.Tensor]   # (H, W)
    alpha: torch.Tensor             # (H, W)
    radii: torch.Tensor             # (N,) int32, 0 = invisible
    # entries_total > the configured entry_budget means this render
    # cropped entries.
    entries_total: Optional[torch.Tensor] = None
    entries_alive: Optional[torch.Tensor] = None


def _zero_colors(state: GaussianState) -> torch.Tensor:
    return torch.zeros((state.capacity, 1), dtype=torch.float32,
                       device=state.device)


def render(
    state: GaussianState,
    w2c: torch.Tensor,
    full_proj: torch.Tensor,
    cam_center: torch.Tensor,
    tanfovx,
    tanfovy,
    width: int,
    height: int,
    sh_degree: int,
    bg: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    used_mask: Optional[torch.Tensor] = None,
    ndc_offset: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
) -> RenderOut:
    """Differentiable render of one view: colour, depth and alpha carry
    autograd to the state's parameters, `override_color`, `bg` and
    `ndc_offset` (the viewspace-gradient hook, ops/projection.py).

    used_mask: optional (N,) bool — render only this subset (the reference
    slices tensors, gaussian_renderer/__init__.py:154-156; masking opacity
    to 0 is equivalent and keeps shapes fixed).
    """
    opacity = state.opacity()
    if used_mask is not None:
        opacity = torch.where(used_mask, opacity, torch.zeros_like(opacity))
    splats = project_gaussians(
        state.params.means, state.scales(), state.params.quats, opacity,
        w2c, full_proj, cam_center, tanfovx, tanfovy, width, height,
        sh=None if override_color is not None else state.sh(),
        sh_degree=sh_degree, colors=override_color,
        scale_modifier=scale_modifier, ndc_offset=ndc_offset)
    out = rasterize(splats, width, height, bg,
                    entry_budget=config.entry_budget)
    return RenderOut(color=out.color, depth=out.depth, alpha=out.alpha,
                     radii=out.radii, entries_total=out.entries_total,
                     entries_alive=out.entries_alive)


@torch.no_grad()
def render_fwd(
    state: GaussianState,
    w2c: torch.Tensor,
    full_proj: torch.Tensor,
    cam_center: torch.Tensor,
    tanfovx,
    tanfovy,
    width: int,
    height: int,
    sh_degree: int,
    bg: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    used_mask: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    with_color: bool = True,
    with_depth: bool = True,
) -> RenderOut:
    """Non-differentiable render (inference/seg/eval/360 paths).

    used_mask: optional (N,) bool — render only this subset (opacity masked
    to 0, which keeps shapes fixed). with_color / with_depth=False return
    None for that field and drop it from the compositor's values.
    """
    opacity = state.opacity()
    if used_mask is not None:
        opacity = torch.where(used_mask, opacity, torch.zeros_like(opacity))
    need_sh = with_color and override_color is None
    splats = project_gaussians(
        state.params.means, state.scales(), state.params.quats, opacity,
        w2c, full_proj, cam_center, tanfovx, tanfovy, width, height,
        sh=state.sh() if need_sh else None,
        sh_degree=sh_degree if need_sh else 0,
        colors=(override_color if override_color is not None else
                (None if need_sh else _zero_colors(state))),
        scale_modifier=scale_modifier)
    out = rasterize_fwd(splats, width, height, bg,
                        entry_budget=config.entry_budget,
                        with_color=with_color, with_depth=with_depth)
    return RenderOut(color=out.color, depth=out.depth, alpha=out.alpha,
                     radii=out.radii, entries_total=out.entries_total,
                     entries_alive=out.entries_alive)


@torch.no_grad()
def subset_stream(state: GaussianState, cam, used_mask: torch.Tensor,
                  width: int, height: int, budget: int, with_depth: bool):
    """The compositor's inputs for render_fwd's alpha-only (with_depth:
    alpha and depth) render of the subset `used_mask` (opacity masked to 0
    off it) at `budget`, raised to twice the demand when the demand exceeds
    it, as the segmentation ladder reruns such a render. Returns
    (composite_fwd's arguments, the EntryPlan, the alive-entry count, the
    budget used)."""
    opacity = torch.where(used_mask, state.opacity(),
                          torch.zeros_like(state.params.opacity_logit))
    splats = project_gaussians(
        state.params.means, state.scales(), state.params.quats, opacity,
        *cam, width, height, colors=_zero_colors(state))
    plan = cuda_raster.alloc_prologue(splats, width, height, budget)
    if int(plan.total) > budget:
        budget = (int(plan.total) * 2 + 127) // 128 * 128
        plan = cuda_raster.alloc_prologue(splats, width, height, budget)
    key, alive = cuda_raster.decode_cull(plan)
    skeys, starts, ends = cuda_raster.sorted_stream(key, plan.t_total,
                                                    plan.rank_bits)
    feat = cuda_raster.entry_features(splats, plan.order, False, with_depth)
    return ((skeys, starts, ends, feat, plan.rank_bits, width, height), plan,
            int(alive), budget)


@torch.no_grad()
def entry_demand_probe(state: GaussianState, w2c, full_proj, cam_center,
                       tanfovx, tanfovy, *, width: int,
                       height: int) -> torch.Tensor:
    """Allocation demand (sum of capped covered-rect areas) for one view
    (wheat3dgs_tpu/training.py::entry_demand_probe); drives the entry
    budget."""
    splats = project_gaussians(
        state.params.means, state.scales(), state.params.quats,
        state.opacity(), w2c, full_proj, cam_center, tanfovx, tanfovy,
        width, height, colors=_zero_colors(state))
    tiles_x, tiles_y = num_tiles(width, height, TILE_PX)
    _, _, _, _, count = capped_rect(splats, tiles_x, tiles_y, TILE_PX,
                                    min(MAX_SPAN, 1 << 14))
    return count.sum()


def adapt_config(state: GaussianState, cam, width: int, height: int,
                 config: RasterConfig = RasterConfig(),
                 cams=None) -> RasterConfig:
    """Size the entry budget from the MAX allocation demand over `cams` (a
    list of camera tuples; defaults to just `cam`), so no view of the set
    crops entries."""
    demand = max(
        int(entry_demand_probe(state, *c_, width=width, height=height))
        for c_ in (cams if cams is not None else [cam]))
    return dataclasses.replace(
        config,
        entry_budget=max(config.entry_budget,
                         pick_entry_budget(demand,
                                           headroom=INFERENCE_HEADROOM)))
