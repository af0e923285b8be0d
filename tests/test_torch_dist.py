"""The port's meshes over the ranks of a torch.distributed process group
(parallel/mesh.py over `init_ranks`), rehearsed on the CPU with gloo, held
to the port's one-process step and to the JAX package's sharded trainers.

Each case spawns its ranks with torch.multiprocessing (start method
`spawn`, a `file://` init in tmp_path); every rank builds the same seeded
problem, runs the one-process step of the port on the whole of it (held
to JAX in tests/test_torch_parallel.py) and the mesh's step on its own
share, compares its share and writes its state and metrics. Each rank is
joined with its own timeout, so a hung rank fails its test. The test's
own process then runs JAX's build_multi_plot_trainer /
build_gauss_sharded_trainer on the same inputs over the conftest's host
devices (as JAX's tests/test_parallel.py does, on its XLA backend with
32-pixel tiles and caps that crop nothing) and holds the ranks' gathered
result to it.

Tolerances, both for the ranks against the one-process port and for
their gathered result against JAX: JAX's tests/test_parallel.py (:81-85,
:134-145), the loss (and L1, PSNR) within rtol 1e-5 and every parameter
within atol 1e-5; each Adam moment and grad_accum within 1e-4 of its max
|value| (MOMENT_REL); alive, n_alive, denom and the screen radii exactly
(and entries_total against the port; JAX's XLA backend reports none).

- plot x view: 2 plots x 2 views over 4 ranks (the view axis all-reduces
  the gradients before Adam) and 2 plots x 1 view over 2 ranks, three
  steps each, against training.multi_plot_step and JAX's
  build_multi_plot_trainer over a 2x2 / 2x1 mesh;
- view x gauss: 1 x 2 and 2 x 2 ranks, three steps with a densify (JAX's
  split noise passed in) and an opacity reset after the second, against
  training.train_step_views on the whole state and JAX's
  build_gauss_sharded_trainer over a 1x2 / 2x2 mesh;
- apps/train_multi over 4 ranks (2 plots x 2 views) against the app in
  one process: its log and PLYs;
- the checks: an unknown backend, a rank outside the world, an NCCL rank
  without its own card;
- when a step over ranks is replayed from a CUDA graph, decided from the
  `Ranks` alone (no process group): staged gloo on CUDA tensors and gloo
  on the CPU run eagerly, NCCL is captured;
- a world of one gloo rank in the test's own process, for each trainer:
  its training.MultiPlotStep (the reduce's collectives are the identity
  over one rank) bit for bit the one-process step through a densify (and
  an opacity reset) after the second of three steps: every state tensor
  and every metric `torch.equal`;
- on a card (`gpu`; `python -m pytest --noconftest -q -m gpu
  tests/test_torch_dist.py`): a world of one NCCL rank, each trainer's
  steps replayed from a CUDA graph bit for bit its own eager steps
  (`training_graph.eager_steps`) and the one-process steps.
"""

import functools
import json
import os
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch import training_graph as TGR
from wheat3dgs_tpu_torch.config import OptimizationParams
from wheat3dgs_tpu_torch.io.synthetic import _ring_cameras, cam_args
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.parallel import mesh as TM
from wheat3dgs_tpu_torch.utils import graphics

W, H = 32, 24
N, CAP = 160, 256
SH = 1
STEPS = 3
JOIN_TIMEOUT = 60.0
LOSS_RTOL = 1e-5
ATOL = 1e-5
MOMENT_REL = 1e-4
BG_PLOTS = (0.1, 0.2, 0.3)
METRICS = ("loss", "l1", "psnr", "n_alive", "entries_total")
DENSIFY = dict(grad_threshold=1e-5, min_opacity=0.005, extent=1.0,
               max_screen_size=0.0)


def _plot(seed: int, n_views: int):
    """One seeded plot: a state from random points (SH 1, capacity CAP)
    with random rotations and axis scales, n_views ring cameras and noisy
    grey images. (create_from_pcd's splats are isotropic: their rotation's
    true gradient is 0, Adam turns its float noise into full steps of
    either sign, and a split offsets the children along those rotations,
    so the step after a densify is not reproducible even between two of
    JAX's own meshes.)"""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (N, 2)),
                          rng.uniform(0.0, 0.4, (N, 1))], 1)
    state = TG.create_from_pcd(pts.astype(np.float32),
                               rng.uniform(0, 1, (N, 3)).astype(np.float32),
                               SH, capacity=CAP, device="cpu")
    quats = rng.standard_normal((N, 4))
    state.params.quats[:N] = torch.as_tensor(
        quats / np.linalg.norm(quats, axis=1, keepdims=True),
        dtype=torch.float32)
    state.params.log_scales[:N] += torch.as_tensor(
        rng.uniform(-0.5, 0.5, (N, 3)), dtype=torch.float32)
    fx = graphics.fov2focal(0.9, W)
    fovx, fovy = graphics.focal2fov(fx, W), graphics.focal2fov(fx, H)
    proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    cams = [cam_args(q, t, proj, fovx, fovy, "cpu")
            for q, t in _ring_cameras(n_views, 2.2, 40.0 + 5 * seed)]
    stack = tuple(torch.stack([c[i] for c in cams]) for i in range(5))
    gts = torch.as_tensor(np.clip(0.3 + 0.05 * rng.standard_normal(
        (n_views, 3, H, W)), 0, 1).astype(np.float32))
    return state, stack, gts


def _close(name, got, ref, exact=False):
    got, ref = got.detach().float(), ref.detach().float()
    if exact:
        assert torch.equal(got, ref), name
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)


def _close_rel(name, got, ref, rel):
    """|got - ref| within rel of ref's max |value| (which must be > 0)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(got - ref).max()
    assert err <= rel * scale, f"{name}: {err} > {rel} x {scale}"


def _hold_state(got: TG.GaussianState, ref: TG.GaussianState):
    for f in TG.PARAM_FIELDS:
        _close(f, getattr(got.params, f), getattr(ref.params, f))
        _close_rel("mu " + f, got.adam.mu[f], ref.adam.mu[f], MOMENT_REL)
        _close_rel("nu " + f, got.adam.nu[f], ref.adam.nu[f], MOMENT_REL)
    _close_rel("grad_accum", got.grad_accum, ref.grad_accum, MOMENT_REL)
    for f in ("alive", "denom", "max_radii2d"):
        _close(f, getattr(got, f), getattr(ref, f), exact=True)
    assert got.adam.step == ref.adam.step


def _save(out_dir: str, rank: int, st: TG.GaussianState, ms: list):
    """This rank's state and each step's metrics into out_dir/rank<r>.npz
    for the test's process to hold to JAX."""
    arrs = {f"p_{f}": getattr(st.params, f).numpy() for f in TG.PARAM_FIELDS}
    for f in TG.PARAM_FIELDS:
        arrs[f"mu_{f}"] = st.adam.mu[f].numpy()
        arrs[f"nu_{f}"] = st.adam.nu[f].numpy()
    for f in ("alive", "grad_accum", "denom", "max_radii2d"):
        arrs[f] = getattr(st, f).numpy()
    for k in METRICS:
        arrs[f"m_{k}"] = np.array([float(m[k].reshape(-1)[0]) for m in ms])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrs)


def _load(tmp_path, ranks, axis=0) -> dict:
    """The saved arrays of `ranks`, each state array concatenated over
    them along the capacity axis (the metrics are the first rank's)."""
    parts = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in ranks]
    return {k: (parts[0][k] if k.startswith("m_") else
                np.concatenate([p[k] for p in parts], axis))
            for k in parts[0]}


def _hold_to_jax(got: dict, jst, jms: list, where: str):
    """The ranks' gathered state and metrics (`_load`) against JAX's."""
    # (JAX's XLA backend reports no entries_total: -1.)
    for k in ("loss", "l1", "psnr", "n_alive"):
        want = np.array([float(np.asarray(m[k])) for m in jms])
        if k == "n_alive":
            np.testing.assert_array_equal(got[f"m_{k}"], want, where + k)
        else:
            np.testing.assert_allclose(got[f"m_{k}"], want, rtol=LOSS_RTOL,
                                       err_msg=where + k)
    for f in TG.PARAM_FIELDS:
        np.testing.assert_allclose(got[f"p_{f}"],
                                   np.asarray(getattr(jst.params, f)),
                                   rtol=0, atol=ATOL, err_msg=where + f)
    for f in ("alive", "denom", "max_radii2d"):
        np.testing.assert_array_equal(
            got[f].astype(np.float32),
            np.asarray(getattr(jst, f)).astype(np.float32), where + f)
    for f in TG.PARAM_FIELDS:
        for m in ("mu", "nu"):
            _close_rel(f"{where}{m} {f}", got[f"{m}_{f}"],
                       getattr(getattr(jst.adam, m), f), MOMENT_REL)
    _close_rel(where + "grad_accum", got["grad_accum"], jst.grad_accum,
               MOMENT_REL)


def _jax_state(st: TG.GaussianState):
    """The JAX package's GaussianState of the port's (one plot)."""
    import jax.numpy as jnp
    from wheat3dgs_tpu.models import gaussians as JG
    from wheat3dgs_tpu.models.optim import AdamState

    def params(get):
        return JG.GaussianParams(**{f: jnp.asarray(get(f).numpy())
                                    for f in TG.PARAM_FIELDS})

    def f32(x):
        return jnp.asarray(x.numpy().astype(np.float32))

    return JG.GaussianState(
        params=params(lambda f: getattr(st.params, f)),
        adam=AdamState(mu=params(lambda f: st.adam.mu[f]),
                       nu=params(lambda f: st.adam.nu[f]),
                       step=jnp.int32(st.adam.step)),
        alive=jnp.asarray(st.alive.numpy()),
        instance_id=jnp.asarray(st.instance_id.numpy().astype(np.int32)),
        grad_accum=f32(st.grad_accum), denom=f32(st.denom),
        max_radii2d=f32(st.max_radii2d))


def _jax_config():
    from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig

    return JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=512,
                   backend="xla")


def _jax_split_noise():
    """JAX's densify draw at PRNGKey(0), passed to the port's densify."""
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, CAP, 3),
                                        jnp.float32))


def _rank(fn, rank, world, init, out_dir, args):
    """A spawned rank: fn(rank, world, init, out_dir, *args)'s result, or
    its traceback, into out_dir/rank<r>.json."""
    torch.set_num_threads(1)
    try:
        res = {"ok": True, **fn(rank, world, init, out_dir, *args)}
    except Exception:
        res = {"ok": False, "error": traceback.format_exc()}
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn(fn, world: int, tmp_path, *args) -> list:
    """Run fn on `world` gloo ranks; every rank must finish within
    JOIN_TIMEOUT of its join and report ok."""
    ctx = mp.get_context("spawn")
    init = "file://" + str(tmp_path / "init")
    procs = [ctx.Process(target=_rank, args=(fn, r, world, init,
                                             str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    hung = []
    for r, p in enumerate(procs):
        p.join(JOIN_TIMEOUT)
        if p.is_alive():
            hung.append(r)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} of {world} did not finish"
    out = []
    for r, p in enumerate(procs):
        path = tmp_path / f"rank{r}.json"
        assert path.exists(), f"rank {r} exited {p.exitcode} without result"
        res = json.loads(path.read_text())
        assert res["ok"], f"rank {r}:\n{res.get('error')}"
        assert p.exitcode == 0
        out.append(res)
    return out


def _multi_plot(rank, world, init, out_dir, n_plots: int,
                n_views: int) -> dict:
    """2 plots x B views: the mesh's step on this rank's share against
    training.multi_plot_step on the whole, STEPS steps."""
    ranks = TM.init_ranks("gloo", init, world, rank)
    opt = OptimizationParams()
    plots = [_plot(p, n_views) for p in range(n_plots)]
    states = TM.stack_states([p[0] for p in plots])
    cams = tuple(torch.stack([p[1][i] for p in plots]) for i in range(5))
    gts = torch.stack([p[2] for p in plots])
    bg = torch.tensor(BG_PLOTS)
    extents = [1.0 + 0.5 * p for p in range(n_plots)]

    mesh = TM.make_mesh(n_plots, n_views, ranks=ranks)
    assert mesh.shape == {"plot": n_plots, "view": n_views}
    assert list(mesh.devices.flat) == [torch.device("cpu")] * ranks.world_size
    step = TM.build_multi_plot_trainer(mesh, SH, W, H, opt)
    mine = TM.shard_states(mesh, TG.map_tensors(torch.clone, states))
    my_cams, my_gts = TM.shard_views(mesh, (cams, gts))
    assert my_gts.shape[:2] == (1, 1)

    ref_step = TT.multi_plot_step(SH, W, H, opt)
    ref = TG.map_tensors(torch.clone, states)
    ms = []
    for it in range(1, STEPS + 1):
        scalars = TT.plot_scalars(it, ref.adam.step + 1, opt, extents)
        ref, ref_m = ref_step(ref, cams, gts, bg, scalars)
        ref.adam.step += 1
        mine, m = step(mine, my_cams, my_gts, bg,
                       TM.shard_plot(mesh, scalars))
        mine.adam.step += 1
        ms.append(m)
        p = mesh.index("plot")
        np.testing.assert_allclose(m["loss"].numpy(),
                                   ref_m["loss"][p:p + 1].numpy(),
                                   rtol=LOSS_RTOL)
        for k in ("l1", "psnr"):
            np.testing.assert_allclose(m[k].numpy(),
                                       ref_m[k][p:p + 1].numpy(),
                                       rtol=LOSS_RTOL)
        for k in ("n_alive", "entries_total"):
            assert torch.equal(m[k], ref_m[k][p:p + 1]), k
    _hold_state(mine, TM.shard_states(mesh, ref))
    _save(out_dir, rank, TG.map_tensors(lambda x: x[0], mine), ms)
    return {"loss": float(m["loss"][0]), "coords": list(mesh.coords)}


def _gauss(rank, world, init, out_dir, n_view: int, n_gauss: int,
           noise) -> dict:
    """The capacity axis over n_gauss ranks (x n_view view rows): STEPS
    steps with a densify and an opacity reset after the second, against
    train_step_views on the whole state."""
    ranks = TM.init_ranks("gloo", init, world, rank)
    opt = OptimizationParams()
    state, cams, gts = _plot(3, 2)
    bg = torch.zeros(3)
    noise = torch.as_tensor(noise)

    mesh = TM.make_gauss_mesh(n_view, n_gauss, ranks=ranks)
    assert mesh.shape == {"view": n_view, "gauss": n_gauss}
    step = TM.build_gauss_sharded_trainer(mesh, SH, W, H, opt)
    mine = TM.shard_state_gauss(mesh, TG.map_tensors(torch.clone, state))
    assert mine.capacity == CAP // n_gauss
    my_cams, my_gts = TM.shard_view_batch(mesh, (cams, gts))

    ref = TG.map_tensors(torch.clone, state)
    ms = []
    for it in range(1, STEPS + 1):
        row = TT.step_scalars(it, ref.adam.step + 1, 1, opt, 1.0)[0]
        ref, ref_m = TT.train_step_views(ref, cams, gts, bg, row,
                                         sh_degree=SH, width=W, height=H,
                                         opt=opt)
        ref.adam.step += 1
        mine, m = step(mine, my_cams, my_gts, bg, row)
        mine.adam.step += 1
        ms.append(m)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=LOSS_RTOL)
        for k in ("l1", "psnr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=LOSS_RTOL)
        for k in ("n_alive", "entries_total"):
            assert int(m[k]) == int(ref_m[k]), k
        if it == 2:
            ref, ref_info = TG.densify_and_prune(ref, noise=noise, **DENSIFY)
            mine, info = TM.densify_gauss(mesh, mine, noise=noise,
                                          **DENSIFY)
            assert {k: int(v) for k, v in info.items()} == {
                k: int(v) for k, v in ref_info.items()}
            assert int(info["n_clone"]) + int(info["n_split"]) > 0
            ref, mine = TG.reset_opacity(ref), TG.reset_opacity(mine)
    _hold_state(mine, TM.shard_state_gauss(mesh, ref))
    _save(out_dir, rank, mine, ms)
    return {"loss": float(m["loss"]), "n_alive": int(m["n_alive"])}


def _jax_multi_plot(n_plots: int, n_views: int):
    """JAX's build_multi_plot_trainer over a n_plots x n_views mesh of
    host devices on _multi_plot's inputs: the final states and each
    step's metrics."""
    import jax
    import jax.numpy as jnp
    from wheat3dgs_tpu.config import OptimizationParams as JOpt
    from wheat3dgs_tpu.parallel import mesh as JM

    plots = [_plot(p, n_views) for p in range(n_plots)]
    mesh = JM.make_mesh(n_plots, n_views,
                        devices=jax.devices()[:n_plots * n_views])
    step = JM.build_multi_plot_trainer(mesh, SH, W, H, JOpt(), _jax_config())
    states = JM.shard_states(mesh, JM.stack_states(
        [_jax_state(p[0]) for p in plots]))
    args = JM.shard_views(mesh, tuple(
        jnp.asarray(np.stack([p[1][i].numpy() for p in plots]))
        for i in range(5)) + (jnp.asarray(np.stack(
            [p[2].numpy() for p in plots])),))
    extents = jnp.asarray([1.0 + 0.5 * p for p in range(n_plots)],
                          jnp.float32)
    ms = []
    for it in range(1, STEPS + 1):
        states, m = step(states, *args, jnp.asarray(BG_PLOTS, jnp.float32),
                         jnp.int32(it), extents)
        ms.append(jax.tree.map(np.asarray, m))
    assert len(ms[-1]["loss"]) == n_plots
    return states, ms


@pytest.mark.parametrize("n_plots,n_views", [(2, 2), (2, 1)])
def test_multi_plot_step_over_ranks(tmp_path, n_plots, n_views):
    import jax

    out = _spawn(_multi_plot, n_plots * n_views, tmp_path, n_plots, n_views)
    # The ranks of one plot group hold one replicated plot.
    losses = [r["loss"] for r in out]
    for r in out:
        same = [o["loss"] for o in out if o["coords"][0] == r["coords"][0]]
        assert len(set(same)) == 1
    assert len(set(losses)) == n_plots
    jst, jms = _jax_multi_plot(n_plots, n_views)
    for p in range(n_plots):
        # Plot p as its view group's first rank holds it.
        _hold_to_jax(_load(tmp_path, [p * n_views]),
                     jax.tree.map(lambda x: x[p], jst),
                     [{k: v[p] for k, v in m.items()} for m in jms],
                     f"plot {p}: ")


def _jax_gauss(n_view: int, n_gauss: int):
    """JAX's build_gauss_sharded_trainer over a n_view x n_gauss mesh of
    host devices on _gauss's inputs, with its densify and opacity reset
    after the second step: the final state and each step's metrics."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from wheat3dgs_tpu.config import OptimizationParams as JOpt
    from wheat3dgs_tpu.models import gaussians as JG
    from wheat3dgs_tpu.parallel import mesh as JM

    state, cams, gts = _plot(3, 2)
    mesh = JM.make_gauss_mesh(n_view, n_gauss,
                              devices=jax.devices()[:n_view * n_gauss])
    step = JM.build_gauss_sharded_trainer(mesh, SH, W, H, JOpt(),
                                          _jax_config())

    def put(t):
        return jax.device_put(jnp.asarray(t.numpy()), NamedSharding(
            mesh, PartitionSpec("view")))

    st = JM.shard_state_gauss(mesh, _jax_state(state))
    args = [put(a) for a in cams] + [put(gts)]
    densify = jax.jit(JG.densify_and_prune, static_argnums=(5,))
    ms = []
    for it in range(1, STEPS + 1):
        st, m = step(st, *args, jnp.zeros(3, jnp.float32), jnp.int32(it))
        ms.append(jax.tree.map(np.asarray, m))
        if it == 2:
            st, _ = densify(st, jax.random.PRNGKey(0),
                            DENSIFY["grad_threshold"], DENSIFY["min_opacity"],
                            jnp.float32(DENSIFY["extent"]),
                            DENSIFY["max_screen_size"])
            st = JG.reset_opacity(st)
    return st, ms


@pytest.mark.parametrize("n_view,n_gauss", [(1, 2), (2, 2)])
def test_gauss_sharded_steps_over_ranks(tmp_path, n_view, n_gauss):
    out = _spawn(_gauss, n_view * n_gauss, tmp_path, n_view, n_gauss,
                 _jax_split_noise())
    assert len({(r["loss"], r["n_alive"]) for r in out}) == 1
    jst, jms = _jax_gauss(n_view, n_gauss)
    # View row 0's gauss ranks hold the whole state, in row order.
    _hold_to_jax(_load(tmp_path, range(n_gauss)), jst, jms, "")


APP_FLAGS = ["--iterations", "30", "--densify_from_iter", "5",
             "--densification_interval", "10", "--opacity_reset_interval",
             "25", "--densify_grad_threshold", "0.00002", "--sh_degree",
             "1", "--quiet"]


def _app(rank, world, init, out_dir, argv) -> dict:
    from wheat3dgs_tpu_torch.apps import train_multi as TA

    TA.main(argv + ["--dist_backend", "gloo", "--dist_init", init,
                    "--world_size", str(world), "--rank", str(rank),
                    "--device", "cpu"])
    return {}


@pytest.fixture(scope="module")
def two_plots(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    base = tmp_path_factory.mktemp("dist_plots")
    for p in (461, 462):
        make_synthetic_colmap_scene(
            str(base / f"plot_{p}"), plot_id=p, seed=p, width=32, height=24,
            n_cams=6, n_heads=1, pts_per_head=40, ground_pts=160,
            with_masks=False, device="cpu")
    return base


def test_train_multi_app_over_ranks(two_plots, tmp_path):
    """apps/train_multi over 2 plots x 2 views on 4 gloo ranks against one
    process:
    rank 0's metrics_multi.jsonl (every plot's loss and PSNR within rtol
    1e-5, n_alive exactly, through densifies, a capacity doubling and an
    opacity reset) and each plot's PLY (means within atol 1e-5)."""
    from wheat3dgs_tpu_torch.apps import train_multi as TA
    from wheat3dgs_tpu_torch.models.serialization import load_ply

    views = 2
    argv = ["--source_base", str(two_plots), "--views_per_step",
            str(views)] + APP_FLAGS
    torch.set_num_threads(1)
    TA.main(argv + ["--model_base", str(tmp_path / "one"), "--device",
                    "cpu"])
    (tmp_path / "ranks").mkdir()
    _spawn(_app, 2 * views, tmp_path / "ranks",
           argv + ["--model_base", str(tmp_path / "dist")])

    def log(name):
        with open(tmp_path / name / "metrics_multi.jsonl") as f:
            return [json.loads(ln) for ln in f]

    one, dist = log("one"), log("dist")
    assert [r["iter"] for r in dist] == [r["iter"] for r in one] == [30]
    for a, b in zip(dist, one):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["psnr"], b["psnr"], rtol=LOSS_RTOL)
        assert a["n_alive"] == b["n_alive"]
    for p in (461, 462):
        ply = os.path.join("plot_%d" % p, "point_cloud", "iteration_30",
                           "point_cloud.ply")
        got, _ = load_ply(str(tmp_path / "dist" / ply), device="cpu")
        ref, _ = load_ply(str(tmp_path / "one" / ply), device="cpu")
        _close(f"plot {p} means", got.params.means, ref.params.means)
        _close(f"plot {p} alive", got.alive, ref.alive, exact=True)


def test_init_ranks_checks(monkeypatch, tmp_path):
    init = "file://" + str(tmp_path / "init")
    with pytest.raises(ValueError, match="backend"):
        TM.init_ranks("mpi", init, 2, 0)
    with pytest.raises(ValueError, match="rank 2 of a world of 2"):
        TM.init_ranks("gloo", init, 2, 2)
    # NCCL: one rank per card, on a host with one card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        TM.init_ranks("nccl", init, 2, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend,device,staged,captured", [
    ("gloo", "cpu", False, False), ("gloo", "cuda", True, False),
    ("nccl", "cuda", False, True)])
def test_capture_decision(monkeypatch, backend, device, staged, captured):
    """Ranks values alone decide: a staged reduce (gloo on CUDA tensors)
    and a CPU rank run the step eagerly, NCCL replays it from a graph.
    The step built with that decision goes through its StepGraph only
    when captured (here on CPU tensors, where a StepGraph runs eagerly
    too)."""
    ranks = TM.Ranks(backend, 2, 1, torch.device(device))
    assert (ranks.staged, ranks.captured) == (staged, captured)
    runs = []
    real = TGR.StepGraph.run

    def run(self, step, n, key, dev):
        runs.append(n)
        return real(self, step, n, key, dev)

    monkeypatch.setattr(TGR.StepGraph, "run", run)
    state, cams, gts = _plot(0, 1)
    step = TT.multi_plot_step(SH, W, H, OptimizationParams(),
                              capture=ranks.captured)
    states = TM.stack_states([state])
    row = TT.plot_scalars(1, 1, OptimizationParams(), [1.0])
    states, m = step(states, tuple(a[None] for a in cams), gts[None],
                     torch.zeros(3), row)
    assert runs == ([1] if captured else [])
    assert torch.isfinite(m["loss"]).all()


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, destroyed after."""
    ranks = TM.init_ranks("gloo", "file://" + str(tmp_path / "init1"), 1, 0)
    try:
        yield ranks
    finally:
        torch.distributed.destroy_process_group()


def _equal_states(got: TG.GaussianState, ref: TG.GaussianState, where=""):
    for i, (a, b) in enumerate(zip(TT.state_tensors(got),
                                   TT.state_tensors(ref))):
        assert a.shape == b.shape and torch.equal(a, b), f"{where}tensor {i}"
    assert got.adam.step == ref.adam.step


def _noise(cap: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, cap, 3)), dtype=torch.float32)


def _densify_stack(states: TG.GaussianState) -> TG.GaussianState:
    """densify_and_prune of every plot of a stack (one split noise), then
    the opacity reset: new tensors, so a captured step recaptures."""
    noise = _noise(states.alive.shape[1]).to(states.alive.device)
    plots = [TG.densify_and_prune(TG.map_tensors(lambda x: x[p], states),
                                  noise=noise, **DENSIFY)[0]
             for p in range(states.alive.shape[0])]
    return TG.reset_opacity(TM.stack_states(plots))


def _plot_view_steps(ranks, dev: str):
    """STEPS steps of build_multi_plot_trainer over a 1x1 mesh of `ranks`
    (2 plots x 2 views) and of the one-process multi_plot_step from the
    same states, a densify after the second: (mesh's states, metrics,
    step), (one process's states, metrics)."""
    opt = OptimizationParams()
    plots = [_plot(p, 2) for p in range(2)]
    states = TG.map_tensors(lambda x: x.to(dev),
                            TM.stack_states([p[0] for p in plots]))
    cams = tuple(torch.stack([p[1][i] for p in plots]).to(dev)
                 for i in range(5))
    gts = torch.stack([p[2] for p in plots]).to(dev)
    bg = torch.tensor(BG_PLOTS, device=dev)
    mesh = TM.make_mesh(1, 1, ranks=ranks)
    step = TM.build_multi_plot_trainer(mesh, SH, W, H, opt)
    out = []
    for make in (lambda: step, lambda: TT.multi_plot_step(SH, W, H, opt)):
        run, st, ms = make(), TG.map_tensors(torch.clone, states), []
        for it in range(1, STEPS + 1):
            row = TT.plot_scalars(it, st.adam.step + 1, opt,
                                  [1.0, 1.5]).to(dev)
            st, m = run(st, cams, gts, bg, row)
            st.adam.step += 1
            ms.append(m)
            if it == 2:
                st = _densify_stack(st)
        out.append((st, ms))
    return out[0] + (step,), out[1]


def _view_gauss_steps(ranks, dev: str):
    """As _plot_view_steps for build_gauss_sharded_trainer over a 1x1
    (view, gauss) mesh, densified through densify_gauss, against
    train_step_views on the whole state and densify_and_prune."""
    opt = OptimizationParams()
    state, cams, gts = _plot(3, 2)
    state = TG.map_tensors(lambda x: x.to(dev), state)
    cams = tuple(a.to(dev) for a in cams)
    gts, bg = gts.to(dev), torch.zeros(3, device=dev)
    mesh = TM.make_gauss_mesh(1, 1, ranks=ranks)
    step = TM.build_gauss_sharded_trainer(mesh, SH, W, H, opt)
    noise = _noise(CAP).to(dev)
    out = []
    for run, densify in (
            (step, lambda st: TM.densify_gauss(mesh, st, noise=noise,
                                               **DENSIFY)[0]),
            (functools.partial(TT.train_step_views, sh_degree=SH, width=W,
                               height=H, opt=opt),
             lambda st: TG.densify_and_prune(st, noise=noise,
                                             **DENSIFY)[0])):
        st, ms = TG.map_tensors(torch.clone, state), []
        for it in range(1, STEPS + 1):
            row = TT.step_scalars(it, st.adam.step + 1, 1, opt,
                                  1.0)[0].to(dev)
            st, m = run(st, cams, gts, bg, row)
            st.adam.step += 1
            ms.append(m)
            if it == 2:
                st = TG.reset_opacity(densify(st))
        out.append((st, ms))
    return out[0] + (step,), out[1]


TRAINERS = {"plot_view": _plot_view_steps, "view_gauss": _view_gauss_steps}


def _hold_bitwise(mine, ref):
    (st, ms, _), (ref_st, ref_ms) = mine, ref
    _equal_states(st, ref_st)
    for i, (m, r) in enumerate(zip(ms, ref_ms)):
        for k in METRICS:
            got, want = m[k], r[k]
            assert got.dtype == want.dtype and torch.equal(
                got.reshape(-1), want.reshape(-1)), f"step {i + 1} {k}"


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_world_of_one_gloo_rank_equals_one_process(world_of_one, trainer):
    """Over one gloo rank on the CPU each trainer is a MultiPlotStep
    carrying its reduce, run eagerly (the decision of Ranks.captured), and
    bit for bit the one-process step through a densify: the identity
    collectives and the reduce's other route (GaussRows' gathered rows,
    ViewReduce's flat buffers) change no bit."""
    mine, ref = TRAINERS[trainer](world_of_one, "cpu")
    step = mine[2] if trainer == "plot_view" else mine[2].step
    assert isinstance(step, TT.MultiPlotStep)
    assert step.capture is False and step.reduce is not None
    assert step.graph.captures == 0
    _hold_bitwise(mine, ref)


@pytest.mark.gpu
def test_nccl_world_of_one_replays_equal_eager(tmp_path):
    """A world of one NCCL rank on the card: each trainer's steps replayed
    from a CUDA graph (two captures, the second after the densify) bit for
    bit the same steps under eager_steps() and the one-process steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ranks = TM.init_ranks("nccl", "file://" + str(tmp_path / "init"), 1, 0)
    try:
        assert ranks.captured
        for name, steps in sorted(TRAINERS.items()):
            mine, ref = steps(ranks, "cuda")
            graph = mine[2].graph
            assert (graph.captures, graph.replays) == (2, 1), name
            with TGR.eager_steps():
                eager, _ = steps(ranks, "cuda")
            _hold_bitwise(mine, eager[:2])
            _hold_bitwise(mine, ref)
    finally:
        torch.distributed.destroy_process_group()
