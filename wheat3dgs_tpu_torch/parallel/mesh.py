"""Device meshes for scale-out: plots x views, and the Gaussian axis.

Counterpart of wheat3dgs_tpu/parallel/mesh.py, with its names, signatures
and checks. The reference trains one plot per SLURM job
(run_wheat_3dgs.sh:7,23-28); the JAX package trains P plots x B views in
one program over a `Mesh(("plot", "view"))`, or shards the capacity axis
over `("view", "gauss")`.

A mesh is an array of torch.device with JAX's axis names and `.shape`
dict, in one of two kinds:

- Over one process (no `ranks`): every cell names one device (the same
  device may fill every cell) and placement is `.to(device)`. Every
  function computes what JAX's computes: the plot and view axes are batch
  axes of the step (`training.multi_plot_step`), and the gauss-sharded
  trainer is `train_step_views` on the whole state, which JAX's own test
  holds its sharded run equal to. A mesh over more than one distinct
  device without a process group raises NotImplementedError: nothing runs
  a multi-device mesh on one device instead.
- Over the ranks of a torch.distributed process group (`ranks` from
  `init_ranks`, one process per cell, rank r at cell r in row-major
  order): each rank holds and computes its own cell's share and the
  collectives carry what JAX's shardings carry.
  - plot x view (`build_multi_plot_trainer`): a rank holds its plot
    group's plots, replicated over its view group, and renders its share
    of the B views; the parameter and `ndc_offset` gradients of its share
    of the view-mean loss and the loss, L1 and MSE sums are all-reduced
    (SUM) over the view group, radii and entries_total take MAX, before
    Adam (`training.train_step_views(reduce=...)`), so the states stay
    replicated and the statistic is JAX's |sum of views| / B^2.
  - view x gauss (`build_gauss_sharded_trainer`): a rank owns
    capacity / n_gauss rows of every per-Gaussian tensor. It projects its
    rows into its view row's B_v views; the projected rows are
    all-gathered over the gauss group; rank g of the group renders views
    g, g + n_gauss, ...; the rows' cotangents are reduce-scattered back to
    their owners, which run the projection's backward, sum over the view
    group, and run Adam and the statistics on their rows
    (`train_step_views(reduce=GaussRows(mesh))`).
    `densify_gauss` gathers the shards and runs JAX's global
    densify_and_prune (its free-slot allocation spans every shard) on
    each rank, then keeps the rank's rows.
  The backend, init address, world size and rank are the caller's
  (`init_ranks`); nothing is read from the environment and nothing picks
  a backend. Under gloo a rank's device is the CPU unless the caller
  names one: gloo reduces host tensors, so a collective on CUDA tensors
  is staged through the host explicitly (`Ranks.staged`). Under NCCL rank
  r's device is cuda:<r>; NCCL needs a card per rank on a host, and
  `init_ranks` refuses more ranks than cards.
  Both trainers return a `training.MultiPlotStep` carrying their reduce.
  Over NCCL its step, collectives included, is replayed from a CUDA graph
  (`Ranks.captured`; every group's communicator is set up when the mesh
  is made, before any capture). A staged step reads the host, so over
  gloo the steps run eagerly. The host-side collectives of the densify
  (`densify_gauss`) and of apps/train_multi's schedule stay outside the
  step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import OptimizationParams
from ..models import gaussians as G
from ..ops.projection import Splats2D, project_gaussians
from ..render.pipeline import RasterConfig, rasterize_config
from ..training import (grads_of, multi_plot_step, render_views,
                        train_step_views)

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in an initialised process group: the backend,
    world size, rank and the device its tensors live on."""
    backend: str
    world_size: int
    rank: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Collectives on this rank's tensors go through host copies (gloo
        with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def captured(self) -> bool:
        """A training step over these ranks is replayed from a CUDA graph:
        under NCCL (collectives on device tensors, which a graph can
        capture). Under gloo the step runs eagerly: staged collectives
        read the host, and a CPU rank has no graph."""
        return self.backend == "nccl"


def init_ranks(backend: str, init_method: str, world_size: int, rank: int,
               device=None) -> Ranks:
    """torch.distributed.init_process_group with everything given: the
    backend ("gloo" or "nccl"), the init address (e.g. "tcp://localhost:
    <port>" or "file://<path>"), the world size and this process's rank.
    The rank's device: under gloo `device` or the CPU; under NCCL
    cuda:<rank>, which must exist on this host (the ranks of one host;
    NCCL refuses two ranks on one card)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    if backend == "gloo":
        dev = torch.device("cpu") if device is None else resolve_device(
            device)
    else:
        resolve_device("cuda")
        n_cards = torch.cuda.device_count()
        if rank >= n_cards:
            raise RuntimeError(
                f"NCCL rank {rank} needs card {rank}, but this host has "
                f"{n_cards}: NCCL runs one rank per card (two ranks on one "
                "card are refused); rehearse more ranks with gloo")
        dev = torch.device("cuda", rank)
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"an NCCL rank's device is {dev}, not {device}")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return Ranks(backend, world_size, rank, dev)


class Mesh:
    """An n-d array of devices with named axes (jax.sharding.Mesh's
    `devices`, `axis_names` and `shape`). Without `ranks` every cell must
    name one device; with `ranks` the cells are the process group's ranks
    in row-major order (their devices gathered from every rank) and this
    process is the cell at `coords`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[Ranks] = None):
        distinct = {torch.device(d) for d in devices.flat}
        if ranks is None and len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over {len(distinct)} distinct devices "
                f"({sorted(map(str, distinct))}) without a process group: "
                "pass ranks=init_ranks(...), one process per cell (ROADMAP "
                "A10); meshes over one device run in one process")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self._groups = {}
        if ranks is not None:
            if devices.size != ranks.world_size:
                raise ValueError(f"a {devices.shape} mesh over a world of "
                                 f"{ranks.world_size} ranks")
            grid = np.arange(ranks.world_size).reshape(devices.shape)
            self.coords = tuple(int(c[0]) for c in
                                np.nonzero(grid == ranks.rank))
            # Every rank creates every group, in one order (new_group is
            # collective); a rank keeps those it belongs to.
            for axis, name in enumerate(self.axis_names):
                lines = np.moveaxis(grid, axis, -1).reshape(
                    -1, grid.shape[axis])
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if ranks.rank in line:
                        self._groups[name] = g
            if ranks.backend == "nccl":
                # NCCL sets a group's communicator up at its first
                # collective, which a capture must not record.
                for g in self._groups.values():
                    dist.all_reduce(torch.zeros(1, device=ranks.device),
                                    group=g)
                torch.cuda.synchronize(ranks.device)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """This process's device: the one device every cell names, or this
        rank's."""
        if self.ranks is not None:
            return self.ranks.device
        return torch.device(self.devices.flat[0])

    def index(self, axis: str) -> int:
        """This rank's index along `axis` (0 over one process)."""
        if self.ranks is None:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def split(self, axis: str) -> int:
        """How many parts a dimension sharded over `axis` is cut into in
        this process: the axis's size over ranks, 1 over one process."""
        return 1 if self.ranks is None else self.shape[axis]

    def collectives(self, axis: str) -> "AxisCollectives":
        """The collectives over `axis` (the ranks that share every other
        coordinate with this one)."""
        return AxisCollectives(self._groups[axis], self.shape[axis],
                               self.index(axis), self.ranks.staged)


class AxisCollectives:
    """Collectives over one mesh axis's process group, each a few flat
    buffers. With `staged`, every buffer is copied to the host, reduced
    there and copied back (gloo's collectives take host tensors)."""

    def __init__(self, group, size: int, index: int, staged: bool):
        self.group, self.size, self.index = group, size, index
        self.staged = staged

    def _run(self, fn, t: torch.Tensor, out: torch.Tensor = None):
        """fn(out, t), in place where out is None; staged through host
        copies."""
        out = t if out is None else out
        if not self.staged:
            fn(out, t)
            return out
        h_in = t.cpu()
        h_out = h_in if out is t else out.cpu()
        fn(h_out, h_in)
        return out.copy_(h_out)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        return self._run(lambda o, i: dist.all_reduce(i, op=op,
                                                      group=self.group), t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, ...) on each rank -> (size * n, ...) in rank order."""
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        return self._run(lambda o, i: dist.all_gather_into_tensor(
            o, i.contiguous(), group=self.group), t, out)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """(size * n, ...) on each rank -> the sum over ranks of rows
        [index * n, (index + 1) * n)."""
        out = t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        return self._run(lambda o, i: dist.reduce_scatter_tensor(
            o, i.contiguous(), group=self.group), t, out)


class ViewReduce:
    """train_step_views' `reduce` over a view axis of `size` ranks with
    equal shares: each rank renders its views of the whole state
    (training.render_views, training.grads_of); one flat SUM for the
    gradients and the metric sums, one flat MAX for radii and
    entries_total."""

    render_views = staticmethod(render_views)
    grads = staticmethod(grads_of)

    def __init__(self, coll: AxisCollectives):
        self.coll = coll
        self.groups = (coll.group,)

    def total(self, b: int) -> int:
        return b * self.coll.size

    def alive_(self, n: torch.Tensor) -> torch.Tensor:
        """The state is replicated over the view group: its own count."""
        return n

    def sum_(self, grads, scalars):
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [s.reshape(1) for s in scalars])
        self.coll.all_reduce_(flat)
        out, at = [], 0
        for t in list(grads) + list(scalars):
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out[:len(grads)], out[len(grads):]

    def max_(self, radii: torch.Tensor, entries: torch.Tensor):
        flat = torch.cat([radii.reshape(-1).to(torch.int32),
                          entries.reshape(1).to(torch.int32)])
        self.coll.all_reduce_(flat, dist.ReduceOp.MAX)
        return (flat[:-1].reshape(radii.shape).to(radii.dtype),
                flat[-1].to(entries.dtype))


def _device_list(devices: Optional[Sequence],
                 ranks: Optional[Ranks] = None) -> list:
    """The given devices, every rank's device (gathered from the process
    group), or every visible CUDA card (raises without one, as
    jax.devices() lists the default backend's devices)."""
    if ranks is not None:
        if devices is not None:
            raise ValueError("a mesh over ranks takes each rank's device")
        names = [None] * ranks.world_size
        dist.all_gather_object(names, str(ranks.device))
        return [torch.device(d) for d in names]
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(devices: list, rows: int, cols: int, axes,
          ranks: Optional[Ranks]) -> Mesh:
    if rows * cols != len(devices):
        raise ValueError(f"{rows}x{cols} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(rows, cols), axes, ranks)


def make_mesh(n_plots: int = 1, n_views: Optional[int] = None,
              devices: Optional[Sequence] = None,
              ranks: Optional[Ranks] = None) -> Mesh:
    devices = _device_list(devices, ranks)
    if n_views is None:
        n_views = len(devices) // n_plots
    return _mesh(devices, n_plots, n_views, ("plot", "view"), ranks)


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
    """Every tensor of `tree` on this process's device; its leading dims,
    one per axis name in `spec`, must divide by those axes' sizes (as a
    NamedSharding over them requires). Over ranks each such dim is cut
    into the axis's parts and this rank keeps its own."""

    def put(x):
        for dim, axis in enumerate(spec):
            if x.shape[dim] % mesh.shape[axis]:
                raise ValueError(
                    f"dimension {dim} of size {x.shape[dim]} does not "
                    f"divide the {axis} axis ({mesh.shape[axis]})")
            part = x.shape[dim] // mesh.split(axis)
            x = x.narrow(dim, mesh.index(axis) * part, part)
        return x.contiguous().to(mesh.device)

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
    step for P plots x B views (training.multi_plot_step). Over ranks it
    takes this rank's shard_states / shard_views / shard_plot parts and
    returns its plots' (P / n_plots,) metrics, each the whole view
    group's; the step is replayed from a CUDA graph where the ranks allow
    it (`Ranks.captured`)."""
    if mesh.ranks is None:
        return multi_plot_step(sh_degree, width, height, opt, config)
    return multi_plot_step(sh_degree, width, height, opt, config,
                           reduce=ViewReduce(mesh.collectives("view")),
                           capture=mesh.ranks.captured)


# ---------------------------------------------------------------------------
# Gaussian-axis (capacity) sharding
# ---------------------------------------------------------------------------


def make_gauss_mesh(n_view: int = 1, n_gauss: Optional[int] = None,
                    devices: Optional[Sequence] = None,
                    ranks: Optional[Ranks] = None) -> Mesh:
    devices = _device_list(devices, ranks)
    if n_gauss is None:
        n_gauss = len(devices) // n_view
    return _mesh(devices, n_view, n_gauss, ("view", "gauss"), ranks)


def shard_state_gauss(mesh: Mesh, state: G.GaussianState) -> G.GaussianState:
    """The capacity axis of every per-Gaussian tensor over 'gauss' (the
    Adam step count, an int, stays as it is); the capacity must divide the
    axis. Over ranks, this rank's rows."""
    return _place(mesh, state, ("gauss",))


def shard_view_batch(mesh: Mesh, tree):
    """(B, ...) camera/image tensors over a gauss mesh's 'view' axis (JAX:
    a NamedSharding over P("view"))."""
    return _place(mesh, tree, ("view",))


# The projected row's float columns: xy, depth, conic, colour, opacity.
_ROW = (("xy", 2), ("depth", 0), ("conic", 3), ("color", 3),
        ("opacity", 0))


def _pack_rows(s: Splats2D) -> torch.Tensor:
    return torch.cat([getattr(s, k).reshape(s.xy.shape[0], -1)
                      for k, _ in _ROW], dim=1)


def _unpack_rows(rows: torch.Tensor, radius: torch.Tensor) -> Splats2D:
    out, at = {}, 0
    for k, w in _ROW:
        out[k] = rows[:, at] if w == 0 else rows[:, at:at + w]
        at += max(w, 1)
    return Splats2D(radius=radius, **out)


class GaussRows:
    """train_step_views' `reduce` over a ('view', 'gauss') mesh of ranks:
    the state is this rank's rows. render_views projects them into every
    view of the batch, all-gathers the projected rows over the gauss group
    and rasterizes views gauss.index, gauss.index + n_gauss, ...; grads
    takes the rows' cotangents of this rank's share of the loss,
    reduce-scatters them back to their owners (a rank that renders no
    view sends zeros) and runs the projection's backward on this rank's
    rows. sum_ adds the gradients over the view group and the metric sums
    over both groups; max_ takes radii over the view group and
    entries_total over both."""

    def __init__(self, mesh: Mesh):
        self.gauss = mesh.collectives("gauss")
        self.views = mesh.collectives("view")
        self.groups = (self.gauss.group, self.views.group)
        self._rows = self._full = None

    def total(self, b: int) -> int:
        return b * self.views.size

    def render_views(self, view, cams, b, *, width, height, sh_degree, bg,
                     ndc_offset, config):
        # Activated per view, as render() does, so that the gradients of
        # the log-scales and opacity logits are summed over the views in
        # one process's order.
        projected = [project_gaussians(
            view.params.means, view.scales(), view.params.quats,
            view.opacity(), *(a[j] for a in cams), width, height,
            sh=view.sh(), sh_degree=sh_degree, ndc_offset=ndc_offset)
            for j in range(b)]
        rows = torch.stack([_pack_rows(s) for s in projected])
        radius = torch.stack([s.radius for s in projected])
        g, f = self.gauss.size, rows.shape[-1]
        # (n_gauss * b, cap / n_gauss, F) gathered -> (b, cap, F).
        full = self.gauss.all_gather(rows.detach()).reshape(
            g, b, -1, f).transpose(0, 1).reshape(b, -1, f).requires_grad_(
            True)
        full_radius = self.gauss.all_gather(radius.to(torch.int32)).reshape(
            g, b, -1).transpose(0, 1).reshape(b, -1)
        self._rows, self._full = rows, full
        outs = [(j, rasterize_config(_unpack_rows(full[j], full_radius[j]),
                                     width, height, bg, config))
                for j in range(self.gauss.index, b, g)]
        return outs, radius.amax(0)

    def grads(self, loss, inputs):
        rows, full = self._rows, self._full
        self._rows = self._full = None
        b, f = full.shape[0], full.shape[-1]
        cot = (torch.autograd.grad(loss, full)[0] if loss.requires_grad
               else torch.zeros_like(full))
        # (b, cap, F) -> rows-first, so each owner's rows are contiguous.
        cot = self.gauss.reduce_scatter(cot.reshape(
            b, self.gauss.size, -1, f).transpose(0, 1).reshape(-1, f))
        grads = torch.autograd.grad(rows, inputs,
                                    grad_outputs=cot.reshape(rows.shape),
                                    allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for x, g in zip(inputs, grads)]

    def sum_(self, grads, scalars):
        grads, scalars = ViewReduce(self.views).sum_(grads, scalars)
        flat = torch.stack(scalars)
        self.gauss.all_reduce_(flat)
        return grads, list(flat)

    def max_(self, radii, entries):
        radii, entries = ViewReduce(self.views).max_(radii, entries)
        flat = entries.reshape(1).to(torch.int32)
        self.gauss.all_reduce_(flat, dist.ReduceOp.MAX)
        return radii, flat[0].to(entries.dtype)

    def alive_(self, n: torch.Tensor) -> torch.Tensor:
        """This rank's alive rows summed over the gauss group."""
        flat = n.reshape(1).clone()
        self.gauss.all_reduce_(flat)
        return flat[0]


class OneStateStep:
    """A multi-plot step over one state with no plot axis: (state, cams,
    gt_images, bg, scalars) -> (state, metrics) as train_step_views takes
    and returns them, through a training.MultiPlotStep (`.step`, its
    `.graph`) on views of a one-plot stack."""

    def __init__(self, step):
        self.step = step
        self.graph = step.graph

    def __call__(self, state, cams, gt_images, bg, scalars):
        _, m = self.step(G.map_tensors(lambda x: x[None], state),
                         tuple(a[None] for a in cams), gt_images[None], bg,
                         scalars[None])
        return state, {k: v[0] for k, v in m.items()}


def build_gauss_sharded_trainer(mesh: Mesh, sh_degree: int, width: int,
                                height: int, opt: OptimizationParams,
                                config: RasterConfig = RasterConfig()):
    """(state, cams, gt_images, bg, scalars) -> (state, metrics) over a
    ('view', 'gauss') mesh: train_step_views, over one device on the whole
    state, over ranks on this rank's shard_state_gauss rows and its view
    row's shard_view_batch views (GaussRows), with the metrics of the
    whole step (n_alive summed over the gauss group inside the step): a
    OneStateStep, replayed from a CUDA graph where the ranks allow it
    (`Ranks.captured`)."""
    if mesh.ranks is None:
        return functools.partial(train_step_views, sh_degree=sh_degree,
                                 width=width, height=height, opt=opt,
                                 config=config)
    return OneStateStep(multi_plot_step(
        sh_degree, width, height, opt, config, reduce=GaussRows(mesh),
        capture=mesh.ranks.captured))


def densify_gauss(mesh: Mesh, state: G.GaussianState, **kw):
    """densify_and_prune of a gauss-sharded state over ranks: the shards
    are gathered over the gauss axis, every rank runs JAX's global
    densify_and_prune (clones and splits land in free slots of any shard)
    on the whole state with the same `noise` or `generator` draws, and
    keeps its rows. Returns (this rank's rows, info)."""
    coll = mesh.collectives("gauss")

    def gather(x):
        if x.dtype == torch.bool:
            return coll.all_gather(x.to(torch.uint8)).bool()
        return coll.all_gather(x)

    whole = G.map_tensors(gather, state)
    new, info = G.densify_and_prune(whole, **kw)
    rows = state.capacity
    lo = coll.index * rows
    return G.map_tensors(lambda x: x[lo:lo + rows].contiguous(), new), info
