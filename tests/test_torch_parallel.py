"""The port's view and plot batches (training.train_step_views,
training.multi_plot_step) and parallel/mesh.py against the JAX package's,
on the CPU.

The JAX side runs its XLA backend with 32-pixel tiles (the port's tile)
and caps that crop nothing, as tests/test_torch_training.py does; the port
runs its kernels' plain versions. Tolerances are that file's: the loss,
L1 and PSNR within rel 1e-4; Adam moments and the accumulated viewspace
gradient within 2% of each field's max |value| (float32 sums in another
order through projection, SH and SSIM); the visibility counts and screen
radii exactly.

- train_step_views at B = 2: the statistics accumulate |sum of the views'
  viewspace gradients| / B^2 (JAX divides the mean loss's gradient by B
  once more), which the 2% bound on grad_accum pins: a view mean would be
  twice JAX's.
- The B-view loss is the mean of the single-view losses (JAX's
  tests/test_parallel.py::test_view_batched_step_matches_mean_of_views),
  and B = 1 is train_step exactly.
- multi_plot_step at P = 2, B = 2 against JAX's, and exactly against P
  separate train_step_views calls (each plot with its own extent).
- The mesh functions' shapes and checks on meshes over one device; a mesh
  over two distinct devices raises.
- The gauss-sharded trainer over 3 steps with a densify (JAX's split noise
  passed in) and an opacity reset: exactly the port's train_step_views,
  and JAX's run within the bounds above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_block import _stacks
from test_torch_training import FIELDS, H, W, _close, _port_state, _scene
from wheat3dgs_tpu import training as JT
from wheat3dgs_tpu.config import OptimizationParams as JOpt
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.parallel import mesh as JM
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch.config import OptimizationParams as TOpt
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.parallel import mesh as TM

JCONF = JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=512,
                backend="xla")
BG = np.array([0.1, 0.2, 0.3], np.float32)
CPUS = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: tiny tensors, where torch's thread pool only
    adds barrier waits on a machine loaded by parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _row(extent=2.0, it=1, t=1):
    return TT.step_scalars(it, t, 1, TOpt(), extent)[0]


def _hold_to_jax(jst, tst, jm, tm, where=""):
    """The port's state and metrics against JAX's, with the bounds above."""
    for k in ("loss", "l1", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), \
            where + k
    for f in FIELDS:
        _close(getattr(jst.adam.mu, f), tst.adam.mu[f], 0.02,
               f"{where}mu.{f}")
        _close(getattr(jst.adam.nu, f), tst.adam.nu[f], 0.02,
               f"{where}nu.{f}")
    _close(jst.grad_accum, tst.grad_accum, 0.02, where + "grad_accum")
    np.testing.assert_array_equal(tst.denom.numpy(), np.asarray(jst.denom))
    np.testing.assert_array_equal(tst.max_radii2d.numpy(),
                                  np.asarray(jst.max_radii2d))


def _assert_states_equal(a, b):
    for x, y in zip(TT.state_tensors(a), TT.state_tensors(b)):
        assert torch.equal(x, y)
    assert a.adam.step == b.adam.step


def test_train_step_views_matches_jax():
    _, jst, _ = _scene()
    tst = _port_state(jst)       # before JAX donates jst
    stacks, gts = _stacks(n_views=2)
    jnew, jm = JT.train_step_views(
        jst, *_j(stacks), jnp.asarray(gts), jnp.asarray(BG), jnp.int32(1),
        sh_degree=1, width=W, height=H, opt=JOpt(), config=JCONF,
        extent=2.0)
    tnew, tm = TT.train_step_views(
        tst, _t(stacks), torch.tensor(gts), torch.tensor(BG), _row(),
        sh_degree=1, width=W, height=H, opt=TOpt())
    _hold_to_jax(jnew, tnew, jm, tm)
    assert int(tm["n_alive"]) == int(jm["n_alive"]) == 40
    assert int(tnew.denom.max()) == 1 and float(tnew.grad_accum.max()) > 0


def test_view_batched_loss_is_mean_of_views():
    _, jst, _ = _scene()
    stacks, gts = _stacks(n_views=2)
    singles = []
    for v in range(2):
        _, m = TT.train_step(_port_state(jst), _t(a[v] for a in stacks),
                             torch.tensor(gts[v]), torch.tensor(BG), _row(),
                             sh_degree=1, width=W, height=H, opt=TOpt())
        singles.append(float(m["loss"]))
    _, mb = TT.train_step_views(_port_state(jst), _t(stacks),
                                torch.tensor(gts), torch.tensor(BG), _row(),
                                sh_degree=1, width=W, height=H, opt=TOpt())
    assert singles[0] != singles[1]
    assert float(mb["loss"]) == pytest.approx(np.mean(singles), rel=1e-6)


def test_one_view_batch_is_train_step():
    _, jst, _ = _scene()
    stacks, gts = _stacks(n_views=1)
    a, ma = TT.train_step(_port_state(jst), _t(x[0] for x in stacks),
                          torch.tensor(gts[0]), torch.tensor(BG), _row(),
                          sh_degree=1, width=W, height=H, opt=TOpt())
    b, mb = TT.train_step_views(_port_state(jst), _t(stacks),
                                torch.tensor(gts), torch.tensor(BG), _row(),
                                sh_degree=1, width=W, height=H, opt=TOpt())
    _assert_states_equal(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def _plots():
    """Two plots of equal capacity, their (P, B) views and images."""
    jsts = [_scene(seed=5)[1], _scene(n=30, seed=6)[1]]
    stacks, gts = _stacks(n_views=4)
    cams = tuple(np.stack([a[[0, 1]], a[[2, 3]]]) for a in stacks)
    gts = np.stack([gts[[0, 1]], gts[[3, 2]]])
    return jsts, cams, gts


def test_multi_plot_step_matches_jax_and_single_plots():
    jsts, cams, gts = _plots()
    extents = [2.0, 3.0]
    tsts = [_port_state(s) for s in jsts]
    singles = [_port_state(s) for s in jsts]
    jstates = JM.stack_states(jsts)
    jnew, jm = JT.multi_plot_step(1, W, H, JOpt(), JCONF)(
        jstates, *_j(cams), jnp.asarray(gts), jnp.asarray(BG), jnp.int32(1),
        jnp.asarray(extents, jnp.float32))
    step = TT.multi_plot_step(1, W, H, TOpt())
    scalars = TT.plot_scalars(1, 1, TOpt(), extents)
    tnew, tm = step(TM.stack_states(tsts), _t(cams), torch.tensor(gts),
                    torch.tensor(BG), scalars)
    assert tnew.params.means.shape == (2, 64, 3)
    assert step.graph.captures == 0          # eager on the CPU
    for p in range(2):
        mine = TG.map_tensors(lambda x: x[p], tnew)
        _hold_to_jax(jax.tree.map(lambda x: x[p], jnew), mine,
                     {k: v[p] for k, v in jm.items()},
                     {k: v[p] for k, v in tm.items()}, f"plot {p} ")
        alone, ma = TT.train_step_views(
            singles[p], tuple(torch.tensor(a[p]) for a in cams),
            torch.tensor(gts[p]), torch.tensor(BG), scalars[p],
            sh_degree=1, width=W, height=H, opt=TOpt())
        _assert_states_equal(mine, alone)
        for k in TT.PLOT_METRICS:
            assert torch.equal(tm[k][p], ma[k].to(tm[k].dtype)), k
    assert tm["n_alive"].tolist() == [40, 30]


def test_mesh_shapes_and_checks():
    assert TM.make_mesh(n_plots=2, n_views=4, devices=CPUS).shape == \
        dict(JM.make_mesh(n_plots=2, n_views=4).shape) == \
        {"plot": 2, "view": 4}
    assert TM.make_mesh(n_plots=2, devices=CPUS).shape == {"plot": 2,
                                                           "view": 4}
    assert TM.make_gauss_mesh(n_view=2, devices=CPUS).shape == \
        dict(JM.make_gauss_mesh(n_view=2).shape) == {"view": 2, "gauss": 4}
    with pytest.raises(ValueError, match="3x3 != 8 devices"):
        TM.make_mesh(3, 3, devices=CPUS)
    mesh = TM.make_mesh(2, 2, devices=CPUS[:4])
    states = TM.stack_states([_port_state(_scene(seed=s)[1])
                              for s in (5, 6)])
    assert states.alive.shape == (2, 64)
    assert TM.shard_states(mesh, states).params.means.device.type == "cpu"
    cams = TM.shard_views(mesh, (torch.zeros(2, 4, 4, 4), torch.zeros(2, 4)))
    assert isinstance(cams, tuple) and cams[0].shape == (2, 4, 4, 4)
    with pytest.raises(ValueError, match="view axis"):
        TM.shard_views(mesh, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="plot axis"):
        TM.shard_plot(mesh, torch.zeros(3, 5))
    assert TM.replicate(mesh, {"bg": torch.zeros(3)})["bg"].shape == (3,)
    one = _port_state(_scene()[1])
    gauss = TM.make_gauss_mesh(n_view=2, n_gauss=4, devices=CPUS)
    assert TM.shard_state_gauss(gauss, one).capacity == 64
    with pytest.raises(ValueError, match="gauss axis"):
        TM.shard_state_gauss(TM.make_gauss_mesh(1, 3, CPUS[:3]), one)
    with pytest.raises(ValueError, match="different Adam steps"):
        TM.stack_states([one, dataclasses.replace(
            one, adam=dataclasses.replace(one.adam, step=3))])


def test_mesh_over_two_devices_raises():
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(NotImplementedError, match="A10"):
        TM.make_mesh(1, 2, devices=two)
    with pytest.raises(NotImplementedError, match="A10"):
        TM.make_gauss_mesh(1, 2, devices=[torch.device("cpu"), two[0]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_mesh()


def _gauss_run(step, state, cams, gts, densify):
    for it in (1, 2, 3):
        state, m = step(state, cams, gts, it)
        if it == 2:
            state = densify(state)
    return state, m


def test_gauss_sharded_trainer_matches_views_and_jax():
    """JAX's test_gauss_axis_sharded_training_matches_unsharded on the
    port: steps 1-3, densify and opacity reset after step 2."""
    _, jst, _ = _scene(n=48, cap=64, seed=9)
    stacks, _ = _stacks(n_views=2)
    gts = np.stack([np.full((3, H, W), 0.35, np.float32),
                    np.full((3, H, W), 0.25, np.float32)])
    key = jax.random.PRNGKey(0)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (2, 64, 3),
                                                      jnp.float32)))
    dkw = dict(grad_threshold=1e-5, min_opacity=0.005, extent=1.0,
               max_screen_size=0.0)

    def port_densify(st):
        st, _ = TG.densify_and_prune(st, noise=noise, **dkw)
        return TG.reset_opacity(st)

    def port_step(fn):
        def step(st, cams, g, it):
            st, m = fn(st, cams, g, torch.tensor(np.zeros(3, np.float32)),
                       TT.step_scalars(it, st.adam.step + 1, 1, TOpt(),
                                       1.0)[0])
            st.adam.step += 1
            return st, m
        return step

    mesh = TM.make_gauss_mesh(n_view=2, n_gauss=4, devices=CPUS)
    sharded = TM.build_gauss_sharded_trainer(mesh, 1, W, H, TOpt())
    plain = dict(sh_degree=1, width=W, height=H, opt=TOpt())
    runs = []
    for fn, put in ((sharded, lambda s: TM.shard_state_gauss(mesh, s)),
                    (lambda *a: TT.train_step_views(*a, **plain),
                     lambda s: s)):
        runs.append(_gauss_run(port_step(fn), put(_port_state(jst)),
                               _t(stacks), torch.tensor(gts), port_densify))
    (s_sh, m_sh), (s_ref, m_ref) = runs
    _assert_states_equal(s_sh, s_ref)
    for k in m_ref:
        assert torch.equal(m_sh[k], m_ref[k]), k

    def jax_step(st, cams, g, it):
        return JT.train_step_views(st, *cams, g, jnp.zeros(3, jnp.float32),
                                   jnp.int32(it), sh_degree=1, width=W,
                                   height=H, opt=JOpt(), config=JCONF)

    def jax_densify(st):
        st, _ = JG.densify_and_prune(st, key, 1e-5, 0.005, 1.0, 0.0)
        return JG.reset_opacity(st)

    j_st, j_m = _gauss_run(jax_step, jst, _j(stacks), jnp.asarray(gts),
                           jax_densify)
    np.testing.assert_array_equal(s_ref.alive.numpy(),
                                  np.asarray(j_st.alive))
    assert int(s_ref.alive.sum()) != 48          # the densify changed it
    assert float(m_ref["loss"]) == pytest.approx(float(j_m["loss"]),
                                                 rel=1e-4)
    _close(j_st.params.means, s_ref.params.means, 1e-4, "means")
    _close(j_st.params.opacity_logit, s_ref.params.opacity_logit, 1e-4,
           "opacity_logit")
