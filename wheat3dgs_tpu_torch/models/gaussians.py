"""Gaussian scene state: fixed-capacity tensors with an `alive` mask, Adam
moments and densification statistics.

Counterpart of wheat3dgs_tpu/models/gaussians.py (field map to the
reference GaussianModel, scene/gaussian_model.py:51-61: means <- _xyz,
sh_dc <- _features_dc, sh_rest <- _features_rest, log_scales <- _scaling,
quats <- _rotation, opacity_logit <- _opacity, instance_id <-
_which_object, grad_accum/denom <- xyz_gradient_accum/denom, max_radii2d
<- max_radii2D). Activations match: exp / sigmoid / normalized quats.

Densify/prune keep the capacity fixed (masked scatters into free slots)
and return a state of new tensors, never writing their input; capacity
only grows by `grow_capacity`. `assign_` copies such a result back into
an existing state's own tensors, so that whatever holds their addresses
(the training loop's captured CUDA graph) reads the new rows: the
training step reads the leaves from the state it is given each time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist
from ..utils.general import inverse_sigmoid, quat_to_rotmat
from ..utils.sh import rgb_to_sh
from .optim import AdamState, adam_init

PARAM_FIELDS = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                "opacity_logit")
STAT_FIELDS = ("grad_accum", "denom", "max_radii2d")


@dataclasses.dataclass
class GaussianParams:
    """Optimized parameters, float32. Leading dim = capacity C."""

    means: torch.Tensor          # (C, 3)
    quats: torch.Tensor          # (C, 4) unnormalized (w, x, y, z)
    log_scales: torch.Tensor     # (C, 3)
    # SH coefficients in flat coefficient-major storage [k0_rgb, k1_rgb, ..]
    sh_dc: torch.Tensor          # (C, 3)
    sh_rest: torch.Tensor        # (C, 3*(K-1))
    opacity_logit: torch.Tensor  # (C,)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor          # (C,) bool
    instance_id: torch.Tensor    # (C,) int32 wheat-head id, 0 = unassigned
    adam: AdamState              # moments keyed like PARAM_FIELDS
    grad_accum: torch.Tensor     # (C,) float32 accumulated |viewspace grad|
    denom: torch.Tensor          # (C,) float32 visibility counts
    max_radii2d: torch.Tensor    # (C,) float32 max screen radius seen

    @property
    def capacity(self) -> int:
        return self.params.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.means.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def opacity(self) -> torch.Tensor:
        """Activated opacity, zero for dead slots (dead slots never render)."""
        return torch.where(self.alive,
                           torch.sigmoid(self.params.opacity_logit),
                           torch.zeros_like(self.params.opacity_logit))

    def scales(self) -> torch.Tensor:
        return torch.exp(self.params.log_scales)

    def sh(self) -> torch.Tensor:
        """Flat (C, 3K) coefficients ([k0_rgb, k1_rgb, ...])."""
        return torch.cat([self.params.sh_dc, self.params.sh_rest], dim=1)


def map_tensors(fn: Callable[..., torch.Tensor],
                *states: GaussianState) -> GaussianState:
    """A state whose every tensor is fn(the states' tensors at that place):
    the port's jax.tree.map over GaussianStates (e.g. x[p] of a stacked
    state, or torch.stack of several). The Adam step count is an int
    outside the tensors; the states must agree on it."""
    steps = {s.adam.step for s in states}
    if len(steps) != 1:
        raise ValueError(f"states at different Adam steps {sorted(steps)}")

    def each(get):
        return fn(*[get(s) for s in states])

    return GaussianState(
        params=GaussianParams(**{
            f: each(lambda s, f=f: getattr(s.params, f))
            for f in PARAM_FIELDS}),
        alive=each(lambda s: s.alive),
        instance_id=each(lambda s: s.instance_id),
        adam=AdamState(
            mu={k: each(lambda s, k=k: s.adam.mu[k])
                for k in states[0].adam.mu},
            nu={k: each(lambda s, k=k: s.adam.nu[k])
                for k in states[0].adam.nu},
            step=steps.pop()),
        **{f: each(lambda s, f=f: getattr(s, f)) for f in STAT_FIELDS})


def assign_(dst: GaussianState, src: GaussianState) -> GaussianState:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst`, in place (the addresses of dst's tensors stay); returns dst.
    Both states have one capacity and one Adam step."""
    map_tensors(lambda d, s: d.copy_(s), dst, src)
    return dst


def _round_capacity(n: int) -> int:
    """Power-of-two up to 32k, then 32k steps (the JAX package's rule, so
    both packages pad a loaded model to the same capacity)."""
    cap = 1024
    while cap < n and cap < 32768:
        cap *= 2
    if cap >= n:
        return cap
    return -(-n // 32768) * 32768


def _zeros(cap: int, dev) -> torch.Tensor:
    return torch.zeros((cap,), dtype=torch.float32, device=dev)


def init_state(params: GaussianParams, instance_id=None,
               capacity: Optional[int] = None) -> GaussianState:
    """Pad n live Gaussians to `capacity` slots (default
    _round_capacity(1.25 n)); dead slots get the identity quaternion, fresh
    Adam moments and zero statistics."""
    n = params.means.shape[0]
    cap = capacity or _round_capacity(int(n * 1.25))
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")
    dev = params.means.device

    def pad(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[:n] = x
        return out

    padded = GaussianParams(**{f: pad(getattr(params, f))
                               for f in PARAM_FIELDS})
    padded.quats[n:, 0] = 1.0
    alive = torch.arange(cap, device=dev) < n
    inst = torch.zeros((cap,), dtype=torch.int32, device=dev)
    if instance_id is not None:
        inst[:n] = torch.as_tensor(np.asarray(instance_id, np.int32),
                                   device=dev)
    return GaussianState(params=padded, alive=alive, instance_id=inst,
                         adam=adam_init(padded.as_dict()),
                         grad_accum=_zeros(cap, dev), denom=_zeros(cap, dev),
                         max_radii2d=_zeros(cap, dev))


def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int,
                    capacity: Optional[int] = None,
                    device="cuda") -> GaussianState:
    """Initialize from a COLMAP point cloud (reference create_from_pcd,
    scene/gaussian_model.py:138-165): SH DC from the colours, isotropic
    scales sqrt(mean 3-NN squared distance), identity rotations, opacity
    0.1."""
    from .. import resolve_device

    dev = resolve_device(device)
    n = points.shape[0]
    k = (sh_degree + 1) ** 2
    dist2 = torch.clamp(torch.as_tensor(knn_mean_sq_dist(points)),
                        min=1e-7).to(dev)
    quats = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    quats[:, 0] = 1.0
    params = GaussianParams(
        means=torch.as_tensor(np.asarray(points, np.float32), device=dev),
        quats=quats,
        log_scales=torch.log(torch.sqrt(dist2))[:, None].expand(n, 3)
        .contiguous(),
        sh_dc=torch.as_tensor(rgb_to_sh(np.asarray(colors, np.float32)),
                              dtype=torch.float32, device=dev),
        sh_rest=torch.zeros((n, 3 * (k - 1)), dtype=torch.float32,
                            device=dev),
        opacity_logit=torch.full((n,), float(inverse_sigmoid(0.1)),
                                 dtype=torch.float32, device=dev))
    return init_state(params, capacity=capacity)


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Re-pad every per-Gaussian tensor (params, moments, masks, stats) with
    zeros to a larger capacity."""
    cap = state.capacity
    if new_capacity <= cap:
        raise ValueError(f"new capacity {new_capacity} <= {cap}")

    def pad(x):
        out = torch.zeros((new_capacity,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        out[:cap] = x
        return out

    return map_tensors(pad, state)


# ---------------------------------------------------------------------------
# Densification (reference scene/gaussian_model.py:399-459)
# ---------------------------------------------------------------------------


@torch.no_grad()
def add_densification_stats(state: GaussianState, ndc_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianState:
    """Accumulate screen-space gradient norms of visible Gaussians
    (reference :461-463; visibility = radii > 0), in place."""
    visible = radii > 0
    gnorm = torch.linalg.vector_norm(ndc_grad[:, :2], dim=-1)
    state.grad_accum += torch.where(visible, gnorm, torch.zeros_like(gnorm))
    state.denom += visible.to(torch.float32)
    torch.maximum(state.max_radii2d,
                  torch.where(visible, radii.to(torch.float32),
                              torch.zeros_like(state.max_radii2d)),
                  out=state.max_radii2d)
    return state


def _scatter_rows(dst: torch.Tensor, targets: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst with src row i written at slot targets[i]; targets == capacity
    are dropped (JAX's .at[].set(mode="drop"))."""
    cap = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])          # row `cap` collects the drops
    ext[targets] = src
    return ext[:cap]


@torch.no_grad()
def densify_masks(state: GaussianState, grad_threshold: float,
                  min_opacity: float, extent: float, max_screen_size: float,
                  percent_dense: float = 0.01) -> dict:
    """densify_and_prune's per-splat decisions, before anything moves:
    `stat` (grad_accum / denom, 0 where never seen) and the (C,) bool masks
    `prune_opacity`, `prune` (with the world-size prune where
    max_screen_size > 0), `hot`, `clone` and `split`."""
    p = state.params
    alive = state.alive
    stat = torch.where(state.denom > 0,
                       state.grad_accum / torch.clamp(state.denom, min=1.0),
                       torch.zeros_like(state.denom))
    max_scale = torch.exp(p.log_scales).max(dim=1).values
    opacity = torch.sigmoid(p.opacity_logit)

    prune_op = (opacity < min_opacity) & alive
    prune = prune_op
    if max_screen_size > 0:
        prune = prune | ((max_scale > 0.1 * extent) & alive)

    hot = (stat >= grad_threshold) & alive & ~prune
    clone = hot & (max_scale <= percent_dense * extent)
    split = hot & (max_scale > percent_dense * extent)
    return {"stat": stat, "prune_opacity": prune_op, "prune": prune,
            "hot": hot, "clone": clone, "split": split}


@torch.no_grad()
def densify_and_prune(
    state: GaussianState,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float = 0.01,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
):
    """Clone small high-grad Gaussians, split big ones, prune transparent /
    oversized ones, as masked scatters at fixed capacity
    (densify_and_prune, scene/gaussian_model.py:441-459; the JAX
    function's rules, including the reference's never-firing
    screen-radius prune, which stays absent).

    The split samples N(0, scale) offsets from `noise` ((2, C, 3) standard
    normal draws; tests pass JAX's) or, when None, from `generator`.
    Returns (new_state, info) with 0-d tensor counts; `n_dropped` counts
    requests beyond the free capacity (the caller should grow_capacity).
    """
    cap = state.capacity
    dev = state.device
    p = state.params
    alive = state.alive
    m = densify_masks(state, grad_threshold, min_opacity, extent,
                      max_screen_size, percent_dense)
    prune_op, prune, clone, split = (m["prune_opacity"], m["prune"],
                                     m["clone"], m["split"])
    scales = torch.exp(p.log_scales)
    alive_after = alive & ~prune & ~split
    free = ~alive_after

    idx = torch.arange(cap, device=dev)
    free_slot = torch.sort(torch.where(free, idx, cap)).values
    n_free = free.sum()
    clone_rank = torch.cumsum(clone, 0) - 1
    n_clone = clone.sum()
    split_rank = torch.cumsum(split, 0) - 1
    n_split = split.sum()

    def slot_of(rank, valid):
        ok = valid & (rank < n_free)
        r = torch.where(ok, rank, torch.full_like(rank, cap - 1))
        s = free_slot[torch.clamp(r, max=cap - 1)]
        return torch.where(ok, s, torch.full_like(s, cap))

    clone_t = slot_of(clone_rank, clone)
    split_base = n_clone + 2 * split_rank
    split_t0 = slot_of(split_base, split)
    split_t1 = slot_of(split_base + 1, split)

    # Clones: verbatim copies.
    new = {f: _scatter_rows(v, clone_t, v) for f, v in p.as_dict().items()}
    # Splits: 2 samples ~ N(0, scales) rotated into the world frame.
    if noise is None:
        noise = torch.randn((2, cap, 3), generator=generator, device=dev)
    noise = noise.to(device=dev, dtype=torch.float32)
    rot = quat_to_rotmat(p.quats)
    offsets = torch.einsum("nij,snj->sni", rot, noise * scales[None])
    split_scales = torch.log(scales / (0.8 * 2.0))
    for s, targets in ((0, split_t0), (1, split_t1)):
        src = dict(p.as_dict(), means=p.means + offsets[s],
                   log_scales=split_scales)
        new = {f: _scatter_rows(new[f], targets, src[f]) for f in new}

    new_alive = alive_after
    inst = state.instance_id
    dead_or_new = ~alive_after
    for targets in (clone_t, split_t0, split_t1):
        ok = targets < cap
        new_alive = _scatter_rows(new_alive, targets, ok)
        inst = _scatter_rows(inst, targets, torch.where(
            ok, state.instance_id, torch.zeros_like(state.instance_id)))
        dead_or_new = _scatter_rows(dead_or_new, targets,
                                    torch.ones_like(ok))

    def clear(x):
        keep = (~dead_or_new).reshape((cap,) + (1,) * (x.dim() - 1))
        return torch.where(keep, x, torch.zeros_like(x))

    adam = AdamState(mu={k: clear(v) for k, v in state.adam.mu.items()},
                     nu={k: clear(v) for k, v in state.adam.nu.items()},
                     step=state.adam.step)
    n_requested = n_clone + 2 * n_split
    info = {"n_clone": n_clone, "n_split": n_split,
            "n_pruned": prune.sum(), "n_pruned_opacity": prune_op.sum(),
            "n_dropped": torch.clamp(n_requested - n_free, min=0),
            "n_alive": new_alive.sum()}
    out = GaussianState(params=GaussianParams(**new), alive=new_alive,
                        instance_id=inst, adam=adam,
                        **{f: _zeros(cap, dev) for f in STAT_FIELDS})
    return out, info


@torch.no_grad()
def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacity to <= 0.01 and zero its Adam moments (reference
    reset_opacity + replace_tensor_to_optimizer,
    scene/gaussian_model.py:234-237,339-360), in place."""
    p = state.params
    p.opacity_logit = inverse_sigmoid(torch.clamp(
        torch.sigmoid(p.opacity_logit), max=0.01))
    state.adam.mu["opacity_logit"].zero_()
    state.adam.nu["opacity_logit"].zero_()
    return state


def prune_mask(state: GaussianState, kill: torch.Tensor) -> GaussianState:
    """Kill an arbitrary mask of Gaussians (the seg pipeline's per-head
    extraction, reference prune_points(during_training=False))."""
    return dataclasses.replace(state, alive=state.alive & ~kill)


# ---------------------------------------------------------------------------
# numpy carriers (tests, checkpoints)
# ---------------------------------------------------------------------------


class NumpyState(NamedTuple):
    params: Dict[str, np.ndarray]
    alive: np.ndarray
    instance_id: np.ndarray
    adam: dict                   # {"mu": {...}, "nu": {...}, "step": int}
    grad_accum: np.ndarray
    denom: np.ndarray
    max_radii2d: np.ndarray


def state_from_numpy(params: Dict[str, np.ndarray], alive=None,
                     instance_id=None, device="cuda", adam=None,
                     grad_accum=None, denom=None,
                     max_radii2d=None) -> GaussianState:
    """The port's state from numpy arrays, kept at their given capacity:
    GaussianParams' fields (`means`, `quats`, `log_scales`, `sh_dc`,
    `sh_rest`, `opacity_logit`); alive (default all slots); instance_id
    (default 0); adam {"mu": {field: array}, "nu": {...}, "step": int}
    (default fresh); the densification stats (default 0)."""
    from .. import resolve_device

    dev = resolve_device(device)

    def t(a, dtype=np.float32):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    p = GaussianParams(**{f: t(params[f]) for f in PARAM_FIELDS})
    c = p.means.shape[0]
    alive_t = (torch.ones((c,), dtype=torch.bool, device=dev)
               if alive is None else t(alive, bool))
    inst = (torch.zeros((c,), dtype=torch.int32, device=dev)
            if instance_id is None else t(instance_id, np.int32))
    opt = (adam_init(p.as_dict()) if adam is None else
           AdamState(mu={f: t(adam["mu"][f]) for f in PARAM_FIELDS},
                     nu={f: t(adam["nu"][f]) for f in PARAM_FIELDS},
                     step=int(adam["step"])))
    stats = {f: _zeros(c, dev) if v is None else t(v)
             for f, v in zip(STAT_FIELDS, (grad_accum, denom, max_radii2d))}
    return GaussianState(params=p, alive=alive_t, instance_id=inst,
                         adam=opt, **stats)


def state_to_numpy(state: GaussianState) -> NumpyState:
    """Inverse of state_from_numpy; the first three items are (params dict,
    alive, instance_id)."""
    def h(x):
        return x.detach().cpu().numpy()

    return NumpyState(
        params={f: h(v) for f, v in state.params.as_dict().items()},
        alive=h(state.alive), instance_id=h(state.instance_id),
        adam={"mu": {k: h(v) for k, v in state.adam.mu.items()},
              "nu": {k: h(v) for k, v in state.adam.nu.items()},
              "step": int(state.adam.step)},
        **{f: h(getattr(state, f)) for f in STAT_FIELDS})
