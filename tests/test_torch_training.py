"""Parity of the port's training step, Trainer and training CLI
(wheat3dgs_tpu_torch.training, apps/train_vanilla) with the JAX package's.

- One `train_step` (its scalar row built by `step_scalars` for iteration 1
  and Adam's first update) from the same state (live and dead slots) and
  view as JAX's `train_step` on its XLA backend with 32-pixel tiles (the
  port's tile; the image depends on it, see
  tests/test_torch_train_raster.py) and caps that crop nothing. The loss
  within rel 1e-4; the gradients, read from the first Adam moments (mu =
  0.1 g), the second moments, and the densification statistics within 2%
  of each field's max |value| (float32 sums in another order through
  projection, SH and SSIM); the visibility counts and screen radii
  exactly.
- The Trainer's entry budget equals JAX's
  pick_entry_budget(entry_demand_probe(...)).
- The CLI (`--device cpu`) on a tiny scene made by the port's generator:
  30 iterations with densify events, the full output tree, a PSNR rise, a
  PLY that JAX's load_ply reads, and a resume from its checkpoint.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu import testing
from wheat3dgs_tpu import training as JT
from wheat3dgs_tpu.config import OptimizationParams as JOpt
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.models import serialization as JS
from wheat3dgs_tpu.ops.binning import pick_entry_budget as j_pick
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch.config import OptimizationParams as TOpt
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops.binning import pick_entry_budget as t_pick
from wheat3dgs_tpu_torch.render.pipeline import entry_demand_probe

FIELDS = TG.PARAM_FIELDS
W, H = 48, 32


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


def _scene(n=40, cap=64, seed=5):
    cam = testing.look_at_camera(width=W, height=H)
    g = testing.random_gaussians(n=n, seed=seed, spread=0.7, sh_degree=1)
    params = JG.GaussianParams(
        means=jnp.asarray(g["means3d"]), quats=jnp.asarray(g["quats"]),
        log_scales=jnp.asarray(np.log(g["scales"])),
        sh_dc=jnp.asarray(g["sh"][:, 0]),
        sh_rest=jnp.asarray(g["sh"][:, 1:].reshape(n, -1)),
        opacity_logit=jnp.asarray(np.log(g["opacities"]
                                         / (1 - g["opacities"]))))
    st = JG.init_state(params, capacity=cap)
    gt = np.random.default_rng(seed).random((3, H, W)).astype(np.float32)
    return cam, st, gt


def _port_state(st):
    def tree(t):
        return {f: np.asarray(getattr(t, f)) for f in FIELDS}

    return TG.state_from_numpy(
        tree(st.params), alive=np.asarray(st.alive),
        instance_id=np.asarray(st.instance_id), device="cpu",
        adam={"mu": tree(st.adam.mu), "nu": tree(st.adam.nu),
              "step": int(st.adam.step)},
        grad_accum=np.asarray(st.grad_accum), denom=np.asarray(st.denom),
        max_radii2d=np.asarray(st.max_radii2d))


def _cams(cam):
    j = (jnp.asarray(cam.w2c), jnp.asarray(cam.full_proj),
         jnp.asarray(cam.cam_center), jnp.float32(cam.tanfovx),
         jnp.float32(cam.tanfovy))
    t = (torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
         torch.tensor(cam.cam_center), torch.tensor(cam.tanfovx),
         torch.tensor(cam.tanfovy))
    return j, t


def _close(a, b, rel, name):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(a).max()
    assert scale > 0, name
    assert np.abs(a - b).max() <= rel * scale, name


def test_train_step_matches_jax():
    cam, jst, gt = _scene()
    tst = _port_state(jst)
    jcam, tcam = _cams(cam)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jconf = JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=512,
                    backend="xla")
    jnew, jm = JT.train_step(jst, *jcam, jnp.asarray(gt), jnp.asarray(bg),
                             jnp.int32(1), sh_degree=1, width=W, height=H,
                             opt=JOpt(), config=jconf, extent=2.0)
    # Iteration 1, Adam's first update: the step's scalar row.
    row = TT.step_scalars(1, tst.adam.step + 1, 1, TOpt(), 2.0)[0]
    tnew, tm = TT.train_step(tst, tcam, torch.tensor(gt), torch.tensor(bg),
                             row, sh_degree=1, width=W, height=H, opt=TOpt())
    tnew.adam.step += 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(tm["l1"]) == pytest.approx(float(jm["l1"]), rel=1e-4)
    assert float(tm["psnr"]) == pytest.approx(float(jm["psnr"]), rel=1e-4)
    assert int(tm["n_alive"]) == int(jm["n_alive"]) == 40
    assert tnew.adam.step == int(jnew.adam.step) == 1
    for f in FIELDS:
        _close(getattr(jnew.adam.mu, f), tnew.adam.mu[f], 0.02, f"mu.{f}")
        _close(getattr(jnew.adam.nu, f), tnew.adam.nu[f], 0.02, f"nu.{f}")
        # Dead slots stay put and keep zero moments.
        assert (tnew.adam.mu[f][40:] == 0).all(), f
    _close(jnew.grad_accum, tnew.grad_accum, 0.02, "grad_accum")
    np.testing.assert_array_equal(tnew.denom.numpy(), np.asarray(jnew.denom))
    np.testing.assert_array_equal(tnew.max_radii2d.numpy(),
                                  np.asarray(jnew.max_radii2d))
    assert (tnew.grad_accum[40:] == 0).all()
    for f in FIELDS:
        assert torch.isfinite(getattr(tnew.params, f)).all(), f


@pytest.mark.parametrize("it", [0, 1, 500, 7_000, 29_999, 30_000, 40_000])
def test_lr_tree_matches_jax(it):
    """The per-leaf learning rates, with expon_lr's log-linear position
    schedule, equal JAX's (float32 there, float64 here: rel 1e-6)."""
    jst = _scene()[1]
    want = JT.lr_tree(jst.params, it, JOpt(), 2.5)
    got = TT.lr_tree(it, TOpt(), 2.5)
    for f in FIELDS:
        assert got[f] == pytest.approx(float(getattr(want, f)), rel=1e-6), f


def test_trainer_budget_matches_jax_probe():
    cam, jst, _ = _scene(n=40, cap=64)
    tst = _port_state(jst)
    jcam, tcam = _cams(cam)
    demand = int(JT.entry_demand_probe(jst, *jcam, width=W, height=H))
    assert int(entry_demand_probe(tst, *tcam, width=W, height=H)) == demand
    trainer = TT.Trainer(tst, TOpt(), cameras_extent=1.0, sh_degree=1)
    trainer._refresh_occupancy(tcam, W, H)
    assert trainer.config.entry_budget == j_pick(demand)
    # The ladder's rungs above the floor agree too.
    for d in (0, 150_000, 1_286_401, 3_000_000):
        assert t_pick(d) == j_pick(d)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("torch_train") / "scene")
    make_synthetic_colmap_scene(out, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=300,
                                device="cpu")
    return out


def test_train_cli_on_cpu(tiny_scene, tmp_path):
    from wheat3dgs_tpu_torch.apps import train_vanilla

    model_dir = str(tmp_path / "model")
    common = ["-s", tiny_scene, "-m", model_dir, "--device", "cpu",
              "--densify_from_iter", "5", "--densification_interval", "10",
              "--densify_until_iter", "25", "--densify_grad_threshold",
              "0.00002", "--quiet"]
    trainer, scene = train_vanilla.main(
        common + ["--iterations", "30", "--test_iterations", "1", "30",
                  "--save_iterations", "30", "--checkpoint_iterations", "20",
                  "--debug_from", "25"])
    assert not torch.is_anomaly_enabled()   # scoped to the steps
    for f in ("cfg_args", "input.ply", "cameras.json", "metrics.jsonl",
              "chkpnt20.npz",
              os.path.join("point_cloud", "iteration_30",
                           "point_cloud.ply")):
        assert os.path.exists(os.path.join(model_dir, f)), f
    recs = [json.loads(ln) for ln in open(os.path.join(model_dir,
                                                       "metrics.jsonl"))]
    tests = [r["test_psnr"] for r in recs if "test_psnr" in r]
    assert len(tests) == 2 and tests[1] > tests[0] + 1.0
    n_init = len(scene.data.point_cloud.points)
    assert int(trainer.state.num_alive) != n_init     # densify events
    assert [r["iter"] for r in recs if "loss" in r] == [30]

    # JAX reads the port's PLY.
    ply = os.path.join(model_dir, "point_cloud", "iteration_30",
                       "point_cloud.ply")
    jst, deg = JS.load_ply(ply)
    assert deg == 3 and int(jst.num_alive) == int(trainer.state.num_alive)
    alive = trainer.state.alive.numpy()
    np.testing.assert_array_equal(
        np.asarray(jst.params.means)[:int(alive.sum())],
        trainer.state.params.means.numpy()[alive])

    # Resume from the checkpoint at 20 to 35.
    trainer2, _ = train_vanilla.main(
        common + ["--iterations", "35", "--test_iterations", "-1",
                  "--save_iterations", "35", "--start_checkpoint",
                  os.path.join(model_dir, "chkpnt20.npz")])
    assert trainer2.state.adam.step == 20 + 15
    assert os.path.exists(os.path.join(model_dir, "point_cloud",
                                       "iteration_35", "point_cloud.ply"))
    recs = [json.loads(ln) for ln in open(os.path.join(model_dir,
                                                       "metrics.jsonl"))]
    assert recs[-1]["iter"] == 35 and np.isfinite(recs[-1]["loss"])


def test_train_cli_refuses_without_card(tiny_scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wheat3dgs_tpu_torch.apps import train_vanilla

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vanilla.main(["-s", tiny_scene, "-m", str(tmp_path / "m")])


def test_trainer_random_background_is_seeded():
    cam, jst, gt = _scene()
    _, tcam = _cams(cam)
    opt = dataclasses.replace(TOpt(), random_background=True,
                              densify_from_iter=10_000)
    losses = []
    for _ in range(2):
        tr = TT.Trainer(_port_state(jst), opt, 1.0, sh_degree=1, seed=3)
        losses.append([float(tr.step(it, tcam, torch.tensor(gt), W,
                                     H)["loss"]) for it in (1, 2)])
    assert losses[0] == losses[1]
