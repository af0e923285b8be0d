"""Trainer.step_block replayed from a CUDA graph, on the card.

Marked `gpu`; each test skips itself when no CUDA device is present. This
file imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_train_graph.py

On a scene of the port's generator (320x240, 10 train views, ~3,600
splats), from the same state and views:
- two blocks of K steps (the first captures its step after one eager
  warm-up step and replays the rest, the second replays every step) equal
  2K eager Trainer.step calls bit for bit: every parameter, moment and
  statistic, and the metrics;
- the kernels' launch counters count every replay: K launches of each
  training kernel per block, and the graph's captures and replays add up;
- a densify/prune, an opacity reset and a budget raise between two blocks
  each cause a recapture, and the block after each still equals its eager
  steps (a replay of the stale graph would train the old tensors).
"""

import dataclasses

import pytest
import torch

from wheat3dgs_tpu_torch import config as cfg
from wheat3dgs_tpu_torch.models import gaussians as G
from wheat3dgs_tpu_torch.ops import cuda_build
from wheat3dgs_tpu_torch.training import LAST_METRICS, Trainer

K = 8
TRAIN_KERNELS = ("decode_cull", "composite_train_fwd", "composite_bwd",
                 "segsum")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    dev = _card()
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene
    from wheat3dgs_tpu_torch.scene import Scene

    out = str(tmp_path_factory.mktemp("graph") / "scene")
    make_synthetic_colmap_scene(out, width=320, height=240, n_cams=10,
                                n_heads=4, pts_per_head=400, ground_pts=2000,
                                with_masks=False, device=dev)
    return Scene(cfg.ModelParams(source_path=out), device=dev)


def _clone(state):
    return G.state_from_numpy(**G.state_to_numpy(state)._asdict(),
                              device=state.device)


def _pair(scene):
    """Two trainers on copies of the scene's state at SH degree 3, with the
    entry budget probed once on view 0 and then fixed (the watchdog reads
    a block's telemetry at other steps than single steps do)."""
    opt = dataclasses.replace(cfg.OptimizationParams(),
                              densify_from_iter=10 ** 6)
    w, h = scene.image_size
    pair = []
    for _ in range(2):
        tr = Trainer(_clone(scene.gaussians), opt, scene.cameras_extent,
                     sh_degree=3, seed=1, adaptive_occupancy=False)
        tr._refresh_occupancy(scene.cam_arrays("train", 0), w, h)
        tr.active_sh_degree = 3
        pair.append(tr)
    return pair


def _views(block: int, n_views: int):
    g = torch.Generator().manual_seed(block)
    return torch.randint(0, n_views, (K,), generator=g).tolist()


def _eager(trainer, it0, vis, scene, gts):
    w, h = scene.image_size
    for j, v in enumerate(vis):
        m = trainer.step(it0 + j, scene.cam_arrays("train", v), gts[v], w, h)
    return m


def _assert_equal(graphed, eager, metrics_g, metrics_e, where):
    a, b = graphed.state, eager.state
    for f in G.PARAM_FIELDS:
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), \
            (where, f)
        assert torch.equal(a.adam.mu[f], b.adam.mu[f]), (where, f"mu.{f}")
        assert torch.equal(a.adam.nu[f], b.adam.nu[f]), (where, f"nu.{f}")
    for f in G.STAT_FIELDS + ("alive",):
        assert torch.equal(getattr(a, f), getattr(b, f)), (where, f)
    for k in LAST_METRICS:
        assert torch.equal(metrics_g[k], metrics_e[k]), (where, k)
    assert a.adam.step == b.adam.step


@pytest.mark.gpu
def test_replayed_blocks_equal_eager_steps_and_count_launches(scene):
    graphed, eager = _pair(scene)
    stacks = scene.cam_stack("train")
    gts = torch.as_tensor(scene.data.train.images, device=stacks[0].device)
    w, h = scene.image_size
    it = 1
    for block in range(2):
        vis = _views(block, gts.shape[0])
        cuda_build.reset_launches()
        mg = graphed.step_block(it, vis, stacks, gts, w, h, n_steps=K)
        torch.cuda.synchronize()
        counted = dict(cuda_build.launches)
        me = _eager(eager, it, vis, scene, gts)
        torch.cuda.synchronize()
        _assert_equal(graphed, eager, mg, me, f"block {block}")
        assert int(mg["entries_total"]) >= int(me["entries_total"])
        for k in TRAIN_KERNELS:
            assert counted[k] == K, (block, k, counted[k])
        assert counted["composite_fwd"] == 0
        it += K
    g = graphed.graph
    assert g.captures == 1 and g.replays == 2 * K - 1
    assert g.per_replay == {k: 1 for k in TRAIN_KERNELS}


@pytest.mark.gpu
def test_stale_graph_is_recaptured(scene):
    graphed, eager = _pair(scene)
    stacks = scene.cam_stack("train")
    gts = torch.as_tensor(scene.data.train.images, device=stacks[0].device)
    w, h = scene.image_size
    events = {
        "densify_and_prune": lambda tr: setattr(
            tr, "state", G.densify_and_prune(
                tr.state, 2e-5, 0.005, tr.extent, 0.0, 0.01,
                generator=tr.generator)[0]),
        "reset_opacity": lambda tr: setattr(
            tr, "state", G.reset_opacity(tr.state)),
        "budget": lambda tr: setattr(tr, "config", dataclasses.replace(
            tr.config, entry_budget=tr.config.entry_budget + 4096)),
    }
    it = 1
    vis = _views(0, gts.shape[0])
    mg = graphed.step_block(it, vis, stacks, gts, w, h, n_steps=K)
    me = _eager(eager, it, vis, scene, gts)
    _assert_equal(graphed, eager, mg, me, "first block")
    for i, (name, event) in enumerate(events.items()):
        for tr in (graphed, eager):
            event(tr)
        it += K
        captures = graphed.graph.captures
        vis = _views(i + 1, gts.shape[0])
        mg = graphed.step_block(it, vis, stacks, gts, w, h, n_steps=K)
        me = _eager(eager, it, vis, scene, gts)
        torch.cuda.synchronize()
        assert graphed.graph.captures == captures + 1, name
        _assert_equal(graphed, eager, mg, me, name)


@pytest.mark.gpu
def test_multi_plot_step_replays_equal_eager_steps(scene):
    """training.multi_plot_step at P = 2 plots (two copies of the scene's
    state, one of them reset) x B = 2 views: its first call runs eagerly
    and captures, later calls replay; every call equals each plot's
    train_step_views run eagerly, bit for bit, and counts P x B launches of
    each training kernel. An opacity reset of the stacked state (new
    tensors) makes the next call recapture."""
    from wheat3dgs_tpu_torch import training as T
    from wheat3dgs_tpu_torch.parallel.mesh import stack_states

    dev = _card()
    w, h = scene.image_size
    opt = cfg.OptimizationParams()
    plots = [_clone(scene.gaussians), G.reset_opacity(
        _clone(scene.gaussians))]
    singles = [_clone(p) for p in plots]
    states = stack_states([_clone(p) for p in plots])
    stacks = scene.cam_stack("train")
    gts = torch.as_tensor(scene.data.train.images, device=dev)
    bg = torch.zeros(3, device=dev)
    extents = [scene.cameras_extent, 2.0 * scene.cameras_extent]
    step = T.multi_plot_step(3, w, h, opt)
    for call in range(4):
        if call == 3:
            states = G.reset_opacity(states)
            singles = [G.reset_opacity(s) for s in singles]
        vi = torch.tensor([[call, call + 3], [call + 5, call + 1]],
                          device=dev)
        rows = torch.arange(2, device=dev)[:, None]
        cams = tuple(torch.stack([a, a])[rows, vi] for a in stacks)
        gsel = torch.stack([gts, gts])[rows, vi]
        scalars = T.plot_scalars(call + 1, states.adam.step + 1, opt,
                                 extents).to(dev)
        cuda_build.reset_launches()
        states, m = step(states, cams, gsel, bg, scalars)
        torch.cuda.synchronize()
        counted = dict(cuda_build.launches)
        states.adam.step += 1
        for p in range(2):
            _, mp = T.train_step_views(
                singles[p], tuple(c[p] for c in cams), gsel[p], bg,
                scalars[p], sh_degree=3, width=w, height=h, opt=opt)
            singles[p].adam.step += 1
            mine = G.map_tensors(lambda x: x[p], states)
            for x, y in zip(T.state_tensors(mine),
                            T.state_tensors(singles[p])):
                assert torch.equal(x, y), (call, p)
            for k in T.PLOT_METRICS:
                assert torch.equal(m[k][p], mp[k].to(m[k].dtype)), \
                    (call, p, k)
        for k in TRAIN_KERNELS:
            assert counted[k] == 4, (call, k, counted[k])
    assert step.graph.captures == 2 and step.graph.replays == 2
