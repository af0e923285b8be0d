"""Blocks of training steps (wheat3dgs_tpu_torch.training.Trainer.step_block,
apps/train_vanilla's block schedule) against K single steps and against the
JAX package, on the CPU, where step_block runs its step K times eagerly.

- step_block(K=4) with distinct view picks, ending on a densify iteration,
  equals four Trainer.step calls exactly: every parameter, moment and
  statistic, the last loss, and the block's maximum entries_total.
- The port's step_block against JAX's Trainer.step_block (its XLA backend
  with tile=32, the port's tile, and caps that crop nothing), from the
  same numpy state and views: the loss within rel 1e-4; moments and
  densification statistics within 2% of each field's max |value| (float32
  sums in another order through projection, SH and SSIM, over 4 steps);
  visibility counts exactly.
- Both CLIs' training() with Trainer.step / step_block replaced by stubs
  that record (iteration, K, views): the same sequence for the default
  flags, test/save/checkpoint iterations inside a block and a random
  background (all K = 1); across an SH multiple the same steps and views,
  with the port's blocks ending at the densify and log iteration 1100,
  which JAX's miss (they end at 1049 and 1099). With --debug_from D
  the sequences agree up to D and the per-step views over the whole run;
  from D + 1 on the port runs single steps (anomaly detection cannot run
  inside a captured step; JAX's jax_debug_nans runs inside its scan).
- Trainer(adaptive_occupancy=False) never probes (JAX's, on the model of
  tests/test_model.py:177-215); Trainer(overflow_check_every=1) raises the
  budget on the step after an overflow exactly as JAX's watchdog does on
  the same telemetry (the model of tests/test_pallas.py:241-290; JAX's
  Pallas step is replaced by the port's telemetry, since it runs only in
  interpret mode here).
- --profile writes a torch.profiler trace of the 20 steps from iteration
  200, and the JAX CLI's TensorBoard tags are written.
- The key of step_block's CUDA graph changes with every event that makes
  a captured step stale: densify/prune, capacity growth, opacity reset,
  a checkpoint load, a budget raise and an SH step; not with a block.
- Trainer.maybe_densify at an unchanged capacity writes densify_and_prune's
  result (bit-equal to the function run on a copy with the same generator
  state) into the state's own tensors: the graph's key holds and
  `densify_in_place` counts it; with growth the key changes and the
  counter stands. The state handed to densify_and_prune is never written
  afterwards (the benchmark's densify check reads it after the run).
"""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import FIELDS, H, W, _close, _port_state, _scene
from wheat3dgs_tpu import testing
from wheat3dgs_tpu import config as jcfg
from wheat3dgs_tpu import training as JT
from wheat3dgs_tpu.apps import train_vanilla as JV
from wheat3dgs_tpu.config import OptimizationParams as JOpt
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu_torch import config as tcfg
from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch.apps import train_vanilla as TV
from wheat3dgs_tpu_torch.config import OptimizationParams as TOpt
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.models import serialization as TS
from wheat3dgs_tpu_torch.utils import trace

EYES = [(0.0, 0.0, -4.0), (1.0, 0.0, -3.8), (-1.0, 0.5, -3.8),
        (0.0, -1.0, -3.8)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run tiny tensors, where torch's
    thread pool only adds barrier waits, and on a machine loaded by
    parallel test workers those waits multiply the run time (the CLI test
    under five busy cores: 36 s with one thread, 313 s with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacks(n_views=4, seed=7):
    """Four look-at views of the origin and a random image each: numpy
    camera stacks (w2c, full_proj, cam_center, tanfovx, tanfovy) and
    (V, 3, H, W) images."""
    cams = [testing.look_at_camera(width=W, height=H, eye=e)
            for e in EYES[:n_views]]
    stacks = (np.stack([c.w2c for c in cams]),
              np.stack([c.full_proj for c in cams]),
              np.stack([c.cam_center for c in cams]),
              np.array([c.tanfovx for c in cams], np.float32),
              np.array([c.tanfovy for c in cams], np.float32))
    gts = np.random.default_rng(seed).random((n_views, 3, H, W)).astype(
        np.float32)
    return stacks, gts


def _torch_stacks(stacks, gts):
    return tuple(torch.tensor(a) for a in stacks), torch.tensor(gts)


def _states_equal(a: TG.GaussianState, b: TG.GaussianState):
    for f in FIELDS:
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), f
        assert torch.equal(a.adam.mu[f], b.adam.mu[f]), f"mu.{f}"
        assert torch.equal(a.adam.nu[f], b.adam.nu[f]), f"nu.{f}"
    for f in TG.STAT_FIELDS + ("alive",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.adam.step == b.adam.step


def test_step_block_equals_steps():
    """Iterations 97-100 as one block and as four steps; 100 is a densify
    iteration, so the block's densify runs after its last step, as the
    steps' does after the fourth."""
    _, jst, _ = _scene()
    stacks, gts = _torch_stacks(*_stacks())
    opt = dataclasses.replace(TOpt(), densify_from_iter=50,
                              densification_interval=100,
                              densify_grad_threshold=1e-7)
    views = [0, 2, 1, 3]
    seq = TT.Trainer(_port_state(jst), opt, 2.0, sh_degree=1, seed=4)
    blk = TT.Trainer(_port_state(jst), opt, 2.0, sh_degree=1, seed=4)
    entries = []
    for j, v in enumerate(views):
        m_seq = seq.step(97 + j, tuple(a[v] for a in stacks), gts[v], W, H)
        entries.append(int(m_seq["entries_total"]))
    m_blk = blk.step_block(97, views, stacks, gts, W, H, n_steps=4)

    assert len(set(entries)) > 1          # the views differ in demand
    assert int(m_blk["entries_total"]) == max(entries)
    for k in TT.LAST_METRICS:
        assert torch.equal(m_blk[k], m_seq[k]), k
    assert blk.state.adam.step == 4
    assert int(blk.state.num_alive) != 40    # the densify event ran
    _states_equal(seq.state, blk.state)
    assert blk.config == seq.config
    assert blk.active_sh_degree == seq.active_sh_degree == 0


def test_step_block_matches_jax():
    _, jst, _ = _scene()
    stacks, gts = _stacks()
    views = [0, 2, 1, 3]
    ttr = TT.Trainer(_port_state(jst),   # before JAX donates jst
                     dataclasses.replace(TOpt(), densify_from_iter=1000),
                     2.0, sh_degree=1)
    opt = dataclasses.replace(JOpt(), densify_from_iter=1000)
    jconf = JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=512,
                    backend="xla")
    jtr = JT.Trainer(jst, opt, 2.0, sh_degree=1, config=jconf,
                     adaptive_occupancy=False)
    jtr.active_sh_degree = ttr.active_sh_degree = 1
    jm = jtr.step_block(1, views, tuple(jnp.asarray(a) for a in stacks),
                        jnp.asarray(gts), W, H, n_steps=4)
    tm = ttr.step_block(1, views, *_torch_stacks(stacks, gts), W, H,
                        n_steps=4)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert int(tm["n_alive"]) == int(jm["n_alive"]) == 40
    assert ttr.state.adam.step == int(jtr.state.adam.step) == 4
    js, ts = jtr.state, ttr.state
    for f in FIELDS:
        _close(getattr(js.adam.mu, f), ts.adam.mu[f], 0.02, f"mu.{f}")
        _close(getattr(js.adam.nu, f), ts.adam.nu[f], 0.02, f"nu.{f}")
    _close(js.grad_accum, ts.grad_accum, 0.02, "grad_accum")
    _close(js.max_radii2d, ts.max_radii2d, 0.02, "max_radii2d")
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))


# --- the CLI's block schedule ----------------------------------------------


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("torch_block") / "scene")
    make_synthetic_colmap_scene(out, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=300,
                                device="cpu")
    return out


METRICS = {"loss": 0.5, "l1": 0.4, "psnr": 10.0, "n_alive": 100,
           "entries_total": 0}


def _record_schedule(monkeypatch, trainer_cls, calls, train_w2c):
    """Replace the Trainer's step and step_block with stubs that record
    (iteration, K, views); a step's view is found from its camera."""

    def step(self, it, cam, gt, w, h):
        hits = [i for i in range(len(train_w2c))
                if np.array_equal(train_w2c[i], np.asarray(cam[0]))]
        assert len(hits) == 1
        calls.append((it, 1, hits))
        return dict(METRICS)

    def step_block(self, it0, vis, stacks, gt, w, h, n_steps):
        calls.append((it0, n_steps, [int(v) for v in vis]))
        return dict(METRICS)

    monkeypatch.setattr(trainer_cls, "step", step)
    monkeypatch.setattr(trainer_cls, "step_block", step_block)


def _schedules(monkeypatch, tmp_path, scene_dir, iterations, tests=(),
               saves=(), ckpts=(), debug_from=-1, random_background=False):
    """The (iteration, K, views) sequences of the JAX CLI's and the port's
    training() on the scene."""
    from wheat3dgs_tpu_torch.scene import Scene

    w2c = Scene(tcfg.ModelParams(source_path=scene_dir), load_images=False,
                device="cpu").cam_stack("train")[0].numpy()
    out = []
    for pkg, trainer_cls, cli, cfg, opt in (
            ("jax", JT.Trainer, JV, jcfg, JOpt()),
            ("port", TT.Trainer, TV, tcfg, TOpt())):
        calls = []
        _record_schedule(monkeypatch, trainer_cls, calls, w2c)
        monkeypatch.setattr(cli, "evaluate_test", lambda *a: 20.0)
        model = cfg.ModelParams(source_path=scene_dir,
                                model_path=str(tmp_path / pkg))
        opt = dataclasses.replace(opt, iterations=iterations,
                                  random_background=random_background)
        args = (set(tests), set(saves), set(ckpts), None)
        if pkg == "jax":
            JV.training(model, opt, jcfg.PipelineParams(), *args,
                        quiet=True, debug_from=debug_from)
        else:
            TV.training(model, opt, *args, quiet=True,
                        debug_from=debug_from, device="cpu")
        out.append(calls)
    return out


def _per_step(calls):
    return [(it + j, v) for it, _, vis in calls for j, v in enumerate(vis)]


@pytest.mark.parametrize("case", ["default", "events_inside", "sh_multiple",
                                  "random_background"])
def test_cli_block_schedule_matches_jax(case, tiny_scene, tmp_path,
                                        monkeypatch):
    kw = {"default": dict(iterations=260, tests=(7000, 30000),
                          saves=(7000, 15000)),
          "events_inside": dict(iterations=200, tests=(1, 37, 150),
                                saves=(77,), ckpts=(123,)),
          "sh_multiple": dict(iterations=1100),
          "random_background": dict(iterations=60,
                                    random_background=True)}[case]
    jax_calls, port_calls = _schedules(monkeypatch, tmp_path, tiny_scene,
                                       **kw)
    if case == "sh_multiple":
        # The same steps and views, but JAX's blocks from the SH step at
        # 1000 end at 1049 and 1099, one short of the densify and log at
        # 1100, which no block ends at; the port runs 1000 alone and ends
        # a block at 1100.
        assert _per_step(port_calls) == _per_step(jax_calls)
        j_ends = [it + k - 1 for it, k, _ in jax_calls]
        p_ends = [it + k - 1 for it, k, _ in port_calls]
        assert 1049 in j_ends and 1099 in j_ends
        assert (1000, 1) in [c[:2] for c in port_calls]
        assert 1050 in p_ends and 1100 in p_ends and 1099 not in p_ends
        assert [c for c in port_calls if c[0] < 1000] == [
            c for c in jax_calls if c[0] < 1000]
    else:
        assert port_calls == jax_calls
    its = [it for it, _, _ in port_calls]
    assert _per_step(port_calls)[-1][0] == kw["iterations"]
    if case == "random_background":
        assert all(k == 1 for _, k, _ in port_calls)
    else:
        assert max(k for _, k, _ in port_calls) == TV.BLOCK_SPAN + 1
    if case == "events_inside":
        for e in (1, 37, 77, 123, 150):
            assert e + 1 in its            # each event ends a block
    if case == "sh_multiple":
        assert 1000 in its                 # the SH step starts a block


def test_cli_debug_from_runs_single_steps(tiny_scene, tmp_path,
                                          monkeypatch):
    jax_calls, port_calls = _schedules(monkeypatch, tmp_path, tiny_scene,
                                       iterations=150, debug_from=70)
    assert [c for c in port_calls if c[0] <= 70] == \
        [c for c in jax_calls if c[0] <= 70]
    assert _per_step(port_calls) == _per_step(jax_calls)
    assert all(k == 1 for it, k, _ in port_calls if it > 70)
    assert any(k > 1 for it, k, _ in jax_calls if it > 70)


# --- the Trainer's watchdog arguments ----------------------------------------


def test_trainer_without_adaptive_occupancy_matches_jax():
    """The model of tests/test_model.py:177-215: without adaptive
    occupancy neither Trainer probes or watches, the configs stay as
    given, and the block's loss agrees."""
    cam = testing.look_at_camera(width=48, height=32)
    g = testing.random_gaussians(n=25, seed=3, spread=0.6)
    from wheat3dgs_tpu.models import gaussians as JG
    from wheat3dgs_tpu.ops.reference_raster import rasterize_naive

    s = testing.project_scene(g, cam, use_colors=True)
    gt = np.clip(np.asarray(rasterize_naive(s, 48, 32)["color"]), 0, 1)
    jst = JG.create_from_pcd(g["means3d"], g["colors"], sh_degree=1,
                             capacity=32)
    opt = dict(iterations=8, densify_from_iter=1000,
               opacity_reset_interval=10_000)
    jconf = JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=512,
                    backend="xla")
    jtr = JT.Trainer(jst, JOpt(**opt), 1.0, sh_degree=1, config=jconf,
                     adaptive_occupancy=False)
    ttr = TT.Trainer(_port_state(jst), TOpt(**opt), 1.0, sh_degree=1,
                     adaptive_occupancy=False)
    stacks = (cam.w2c[None], cam.full_proj[None], cam.cam_center[None],
              np.float32([cam.tanfovx]), np.float32([cam.tanfovy]))
    jm = jtr.step_block(1, [0] * 4, tuple(jnp.asarray(a) for a in stacks),
                        jnp.asarray(gt)[None], 48, 32, n_steps=4)
    tm = ttr.step_block(1, [0] * 4, tuple(torch.tensor(a) for a in stacks),
                        torch.tensor(gt)[None], 48, 32, n_steps=4)
    tm2 = ttr.step(5, tuple(torch.tensor(a[0]) for a in stacks),
                   torch.tensor(gt), 48, 32)
    jm2 = jtr.step(5, tuple(jnp.asarray(a[0]) for a in stacks),
                   jnp.asarray(gt), 48, 32)
    for t, j in ((tm, jm), (tm2, jm2)):
        assert float(t["loss"]) == pytest.approx(float(j["loss"]), rel=1e-4)
    assert jtr.config == jconf and ttr.config == TT.RasterConfig()
    assert jtr._pending_overflow is None and ttr._pending_overflow is None
    assert jtr._occupancy_due and ttr._occupancy_due   # never probed


def test_trainer_overflow_check_every_step_matches_jax(monkeypatch):
    """The model of tests/test_pallas.py:241-290 with
    overflow_check_every=1: the port's steps run for real; JAX's Trainer
    (its Pallas branch) sees the same telemetry through a stub of its
    step, and both raise the budget on the same steps to the same rung."""
    from wheat3dgs_tpu.models import gaussians as JG
    from wheat3dgs_tpu.ops.binning import pick_entry_budget as j_pick
    from wheat3dgs_tpu_torch.ops.binning import pick_entry_budget as t_pick

    monkeypatch.setattr(JT, "pick_entry_budget",
                        functools.partial(j_pick, floor=512))
    monkeypatch.setattr(TT, "pick_entry_budget",
                        functools.partial(t_pick, floor=512))
    cam = testing.look_at_camera(width=64, height=64)
    g = testing.random_gaussians(n=40, seed=11, spread=0.7)
    jst = JG.create_from_pcd(g["means3d"], g["colors"], sh_degree=1,
                             capacity=64)
    opt = dict(iterations=10, densify_from_iter=1000, densify_until_iter=0,
               opacity_reset_interval=10_000)
    ttr = TT.Trainer(_port_state(jst), TOpt(**opt), 1.0, sh_degree=1,
                     overflow_check_every=1)
    jtr = JT.Trainer(jst, JOpt(**opt), 1.0, sh_degree=1,
                     config=JConfig(backend="pallas"),
                     overflow_check_every=1)
    telemetry = []

    def jax_step(state, *a, **k):
        return state, {"entries_total": jnp.int32(telemetry[-1])}

    monkeypatch.setattr(JT, "train_step", jax_step)
    tcam = (torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
            torch.tensor(cam.cam_center), torch.tensor(cam.tanfovx),
            torch.tensor(cam.tanfovy))
    jcam = (jnp.asarray(cam.w2c), jnp.asarray(cam.full_proj),
            jnp.asarray(cam.cam_center), jnp.float32(cam.tanfovx),
            jnp.float32(cam.tanfovy))
    gt = np.zeros((3, 64, 64), np.float32)
    seen = []
    for it in (1, 2, 3, 4):
        if it == 2:   # the population outgrows its rung mid-interval
            for tr in (ttr, jtr):
                tr.config = dataclasses.replace(tr.config, entry_budget=128)
        m = ttr.step(it, tcam, torch.tensor(gt), 64, 64)
        telemetry.append(int(m["entries_total"]))
        jtr.step(it, jcam, jnp.asarray(gt), 64, 64)
        seen.append((ttr.config.entry_budget, ttr.overflow_events,
                     ttr._occupancy_due))
        assert seen[-1] == (jtr.config.entry_budget, jtr.overflow_events,
                            jtr._occupancy_due), it
    assert telemetry[1] > 128
    assert [s[1] for s in seen] == [0, 1, 1, 1]
    assert seen[1][2] and not seen[2][2]
    assert seen[2][0] >= telemetry[1]


# --- --profile and TensorBoard ----------------------------------------------


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """32x24, 160 points: the profile test runs 221 real steps."""
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("torch_profile") / "scene")
    make_synthetic_colmap_scene(out, width=32, height=24, n_heads=1,
                                pts_per_head=30, ground_pts=100,
                                with_masks=False, device="cpu")
    return out


def test_cli_profile_trace_and_tensorboard(small_scene, tmp_path):
    model_dir = str(tmp_path / "model")
    trainer, _ = TV.main(["-s", small_scene, "-m", model_dir, "--device",
                          "cpu", "--iterations", "221", "--test_iterations",
                          "221", "--save_iterations", "221", "--profile",
                          "--densify_from_iter", "10_000", "--quiet"])
    trace = json.load(open(os.path.join(model_dir, "profile",
                                        "trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("autograd" in str(n) or "aten::" in str(n) for n in names)
    assert "w3dgs/train.eager_step" in names      # the program's spans
    assert trainer.state.adam.step == 221
    try:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
        import torch.utils.tensorboard  # noqa: F401
    except Exception:
        pytest.skip("torch.utils.tensorboard does not import here")
    acc = EventAccumulator(model_dir)
    acc.Reload()
    tags = acc.Tags()["scalars"]
    for tag in ("train_loss_patches/total_loss", "train/psnr",
                "total_points", "iter_time", "test/psnr"):
        assert tag in tags, tag
    assert [e.step for e in acc.Scalars("train/psnr")] == [100, 200, 221]
    assert [e.step for e in acc.Scalars("test/psnr")] == [221]


# --- the graph's key -------------------------------------------------------


def test_graph_key_changes_with_every_stale_event(tmp_path):
    _, jst, _ = _scene()
    stacks, gts = _torch_stacks(*_stacks())
    opt = dataclasses.replace(TOpt(), densify_from_iter=10_000)
    tr = TT.Trainer(_port_state(jst), opt, 2.0, sh_degree=1)
    tr.step_block(1, [0, 1, 2], stacks, gts, W, H, n_steps=3)

    def key():
        return tr._graph_key(stacks, gts, W, H)

    k0 = key()
    tr.step_block(4, [3, 1], stacks, gts, W, H, n_steps=2)
    assert key() == k0                       # in-place updates only
    events = {
        "densify_and_prune": lambda: setattr(tr, "state", TG.densify_and_prune(
            tr.state, 1e-9, 0.005, 2.0, 0.0, 0.01,
            generator=tr.generator)[0]),
        "grow_capacity": lambda: setattr(tr, "state", TG.grow_capacity(
            tr.state, 128)),
        "reset_opacity": lambda: setattr(tr, "state", TG.reset_opacity(
            tr.state)),
        "load_checkpoint": lambda: (
            TS.save_checkpoint(tr.state, 5, str(tmp_path / "c.npz")),
            setattr(tr, "state", TS.load_checkpoint(
                str(tmp_path / "c.npz"), device="cpu")[0])),
        "budget": lambda: setattr(tr, "config", dataclasses.replace(
            tr.config, entry_budget=tr.config.entry_budget + 128)),
        "sh_degree": lambda: setattr(tr, "active_sh_degree", 1),
    }
    for name, event in events.items():
        before = key()
        event()
        assert key() != before, name


# --- a densify in place ----------------------------------------------------


def _densify_trainer(threshold: float):
    """A Trainer on 40 splats in 64 slots after a block of steps (96-99),
    densifying at every 100th iteration from 50 on."""
    _, jst, _ = _scene()
    stacks, gts = _torch_stacks(*_stacks())
    opt = dataclasses.replace(TOpt(), densify_from_iter=50,
                              densification_interval=100,
                              densify_grad_threshold=threshold)
    tr = TT.Trainer(_port_state(jst), opt, 2.0, sh_degree=1, seed=4)
    tr.step_block(96, [0, 2, 1, 3], stacks, gts, W, H, n_steps=4)
    return tr, stacks, gts


@pytest.mark.parametrize("grow", [False, True])
def test_densify_in_place_keeps_the_graph_key(grow):
    """Four splats with a statistic of 1 (threshold 0.5: they clone or
    split into free slots, capacity unchanged), or every splat (threshold
    0: the requests outrun the 24 free slots and the capacity grows)."""
    tr, stacks, gts = _densify_trainer(0.0 if grow else 0.5)
    st = tr.state
    st.denom.fill_(1.0)
    st.grad_accum.zero_()
    st.grad_accum[:4] = 1.0
    gen = torch.Generator()
    gen.set_state(tr.generator.get_state())
    want, info = TG.densify_and_prune(
        TG.map_tensors(torch.clone, st), tr.opt.densify_grad_threshold,
        0.005, 2.0, 0.0, tr.opt.percent_dense, generator=gen)
    key = tr._graph_key(stacks, gts, W, H)
    count = trace.counters().get("densify_in_place", 0)

    tr.maybe_densify(100)

    in_place = trace.counters().get("densify_in_place", 0) - count
    assert int(info["n_clone"]) + int(info["n_split"]) > 0
    if grow:
        assert tr.state.capacity > 64
        assert tr._graph_key(stacks, gts, W, H) != key
        assert in_place == 0
        return
    assert int(info["n_dropped"]) == 0 and tr.state.capacity == 64
    assert tr.state is st
    assert tr._graph_key(stacks, gts, W, H) == key
    assert in_place == 1
    for a, b in zip(TT.state_tensors(tr.state), TT.state_tensors(want)):
        assert torch.equal(a, b)
    assert tr.state.adam.step == want.adam.step
    assert int(tr.state.num_alive) == int(info["n_alive"]) != 40


def test_densify_input_is_never_written(monkeypatch):
    """densify_and_prune wrapped as the benchmark's DensifyRecorder wraps
    it: the state of its first call and a copy of its rows, taken then,
    are still equal after another block and another densify, both in
    place, while the working set has moved on."""
    kept = []
    densify = TG.densify_and_prune

    def recorded(state, *a, **kw):
        kept.append((state, [t.clone() for t in TT.state_tensors(state)]))
        return densify(state, *a, **kw)

    monkeypatch.setattr(TG, "densify_and_prune", recorded)
    tr, stacks, gts = _densify_trainer(1e9)
    count = trace.counters().get("densify_in_place", 0)
    tr.step_block(100, [1], stacks, gts, W, H, n_steps=1)
    tr.step_block(101, list(range(4)) * 25, stacks, gts, W, H,
                  n_steps=100)
    assert trace.counters().get("densify_in_place", 0) - count == 2
    assert len(kept) == 2 and tr.state.capacity == 64
    state, rows = kept[0]
    assert state is not tr.state
    for a, b in zip(TT.state_tensors(state), rows):
        assert torch.equal(a, b)
    assert not torch.equal(state.params.means, tr.state.params.means)
