"""Device meshes for scale-out: plots x views, and the Gaussian axis.

Counterpart of wheat3dgs_tpu/parallel/mesh.py, with its names, signatures
and checks. The reference trains one plot per SLURM job
(run_wheat_3dgs.sh:7,23-28); the JAX package trains P plots x B views in
one program over a `Mesh(("plot", "view"))`, or shards the capacity axis
over `("view", "gauss")`.

On one card, scale-out means several plots trained by one process
(`training.multi_plot_step`), so a mesh here is an array of torch.device
with JAX's axis names and `.shape` dict, and placement is `.to(device)`.
Over one distinct device (the same device may fill every cell) every
function computes what JAX's computes: the plot and view axes are batch
axes of the step, and the gauss-sharded trainer is `train_step_views` on
the whole state, which JAX's own test holds its sharded run equal to.

A mesh over more than one distinct device raises NotImplementedError: the
multi-card mesh (plot groups on several cards, the view axis with an NCCL
all-reduce of the gradients, the gauss axis with an all-gather) is ROADMAP
item A10 and waits for a machine with more than one card. Nothing here
runs a multi-device mesh on one device instead.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import OptimizationParams
from ..models import gaussians as G
from ..render.pipeline import RasterConfig
from ..training import multi_plot_step, train_step_views


class Mesh:
    """An n-d array of devices with named axes (jax.sharding.Mesh's
    `devices`, `axis_names` and `shape`)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        distinct = {torch.device(d) for d in devices.flat}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over {len(distinct)} distinct devices "
                f"({sorted(map(str, distinct))}): the multi-card mesh is "
                "ROADMAP item A10 (plot groups on several cards, the view "
                "axis with an NCCL gradient all-reduce, the gauss axis with "
                "an all-gather); meshes over one device run here")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device every cell names."""
        return torch.device(self.devices.flat[0])


def _device_list(devices: Optional[Sequence]) -> list:
    """The given devices, or every visible CUDA card (raises without one,
    as jax.devices() lists the default backend's devices)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(devices: list, rows: int, cols: int, axes) -> Mesh:
    if rows * cols != len(devices):
        raise ValueError(f"{rows}x{cols} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(rows, cols), axes)


def make_mesh(n_plots: int = 1, n_views: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = _device_list(devices)
    if n_views is None:
        n_views = len(devices) // n_plots
    return _mesh(devices, n_plots, n_views, ("plot", "view"))


def _tree_map(fn, tree):
    """fn on every tensor of a GaussianState, tuple, list or dict tree;
    other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, G.GaussianState):
        return G.map_tensors(fn, tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _place(mesh: Mesh, tree, spec: tuple):
    """Every tensor of `tree` on the mesh's device; its leading dims, one
    per axis name in `spec`, must divide by those axes' sizes (as a
    NamedSharding over them requires)."""

    def put(x):
        for dim, axis in enumerate(spec):
            if x.shape[dim] % mesh.shape[axis]:
                raise ValueError(
                    f"dimension {dim} of size {x.shape[dim]} does not "
                    f"divide the {axis} axis ({mesh.shape[axis]})")
        return x.to(mesh.device)

    return _tree_map(put, tree)


def shard_states(mesh: Mesh, states: G.GaussianState) -> G.GaussianState:
    """states: leading P dim on every tensor -> P over 'plot', replicated
    over 'view'."""
    return _place(mesh, states, ("plot",))


def shard_plot(mesh: Mesh, tree):
    """(P, ...) tensors over 'plot' only (replicated across 'view')."""
    return _place(mesh, tree, ("plot",))


def shard_views(mesh: Mesh, tree):
    """(P, B, ...) camera/image tensors over ('plot', 'view')."""
    return _place(mesh, tree, ("plot", "view"))


def replicate(mesh: Mesh, tree):
    return _place(mesh, tree, ())


def stack_states(states: Sequence[G.GaussianState]) -> G.GaussianState:
    """Stack per-plot states (equal capacity and Adam step) into
    leading-P tensors."""
    return G.map_tensors(lambda *xs: torch.stack(xs), *states)


def build_multi_plot_trainer(mesh: Mesh, sh_degree: int, width: int,
                             height: int, opt: OptimizationParams,
                             config: RasterConfig = RasterConfig()):
    """The (states, cams, gt_images, bg, scalars) -> (states, metrics)
    step for P plots x B views (training.multi_plot_step)."""
    return multi_plot_step(sh_degree, width, height, opt, config)


# ---------------------------------------------------------------------------
# Gaussian-axis (capacity) sharding
# ---------------------------------------------------------------------------


def make_gauss_mesh(n_view: int = 1, n_gauss: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    devices = _device_list(devices)
    if n_gauss is None:
        n_gauss = len(devices) // n_view
    return _mesh(devices, n_view, n_gauss, ("view", "gauss"))


def shard_state_gauss(mesh: Mesh, state: G.GaussianState) -> G.GaussianState:
    """The capacity axis of every per-Gaussian tensor over 'gauss' (the
    Adam step count, an int, stays as it is); the capacity must divide the
    axis."""
    return _place(mesh, state, ("gauss",))


def build_gauss_sharded_trainer(mesh: Mesh, sh_degree: int, width: int,
                                height: int, opt: OptimizationParams,
                                config: RasterConfig = RasterConfig()):
    """(state, cams, gt_images, bg, scalars) -> (state, metrics) over a
    ('view', 'gauss') mesh of one device: train_step_views on the whole
    state."""
    return functools.partial(train_step_views, sh_degree=sh_degree,
                             width=width, height=height, opt=opt,
                             config=config)
