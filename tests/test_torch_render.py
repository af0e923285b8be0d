"""The port's serving slice against the JAX package, end to end:
`render_fwd` on one state, the `render_sets` PNG tree of a JAX-written
scene and model, PLY files crossing between the packages, and
`state_from_numpy`.

Tolerances: render_fwd colour / alpha atol 1e-4 and depth rtol + atol 1e-4
(the raster tests' bounds; projection adds float32 rounding only). PNGs:
within 1/255 on >= 99.9% of pixel channels (8-bit truncation of values
that differ in the last float32 bits).

JAX's render_sets renders through its Pallas path (interpret mode,
pack_payload=False), the port's reference: on a CPU host its
inference_config would pick the XLA tile backend instead, whose
16-tiles-per-splat and one-view max_per_tile caps crop differently."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wheat3dgs_tpu import config as jcfg
from wheat3dgs_tpu import testing
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.models import serialization as JS
from wheat3dgs_tpu.render import pipeline as JP
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.models import serialization as TS
from wheat3dgs_tpu_torch.render import pipeline as TP


def _numpy_params(n, seed, sh_degree=3):
    g = testing.random_gaussians(n=n, seed=seed, spread=0.8,
                                 sh_degree=sh_degree)
    rng = np.random.default_rng(seed + 100)
    return {
        "means": g["means3d"],
        "quats": g["quats"],
        "log_scales": np.log(g["scales"]),
        "sh_dc": g["sh"][:, 0, :],
        "sh_rest": g["sh"][:, 1:, :].reshape(n, -1),
        "opacity_logit": rng.normal(1.0, 1.0, n).astype(np.float32),
    }, g["colors"]


def _jax_state(params, instance_id=None):
    return JG.init_state(JG.GaussianParams(
        **{k: jnp.asarray(v) for k, v in params.items()}),
        instance_id=instance_id)


def _as_numpy(state):
    return ({f: np.asarray(getattr(state.params, f))
             for f in TG.PARAM_FIELDS}, np.asarray(state.alive),
            np.asarray(state.instance_id))


def _torch_cam(cam):
    return (torch.from_numpy(cam.w2c), torch.from_numpy(cam.full_proj),
            torch.from_numpy(cam.cam_center), cam.tanfovx, cam.tanfovy)


@pytest.mark.parametrize("mode", ["sh3_used_mask", "override_color"])
def test_render_fwd_matches_jax(mode):
    n = 150
    params, colors = _numpy_params(n, seed=6)
    jstate = _jax_state(params)
    p, alive, inst = _as_numpy(jstate)
    tstate = TG.state_from_numpy(p, alive, inst, device="cpu")
    cam = testing.look_at_camera(width=70, height=45)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    budget = 4096
    mask = np.random.default_rng(0).random(jstate.capacity) < 0.6
    override = np.zeros((jstate.capacity, 3), np.float32)
    override[:n] = colors
    kw_j, kw_t = {}, {}
    if mode == "sh3_used_mask":
        kw_j["used_mask"] = jnp.asarray(mask)
        kw_t["used_mask"] = torch.from_numpy(mask)
    else:
        kw_j["override_color"] = jnp.asarray(override)
        kw_t["override_color"] = torch.from_numpy(override)
    ref = JP.render_fwd(
        jstate, cam.w2c, cam.full_proj, cam.cam_center, cam.tanfovx,
        cam.tanfovy, 70, 45, sh_degree=3, bg=jnp.asarray(bg),
        config=JP.RasterConfig(backend="pallas", entry_budget=budget,
                               pack_payload=False), **kw_j)
    out = TP.render_fwd(tstate, *_torch_cam(cam), 70, 45, sh_degree=3,
                        bg=torch.from_numpy(bg),
                        config=TP.RasterConfig(entry_budget=budget), **kw_t)
    assert int(out.entries_total) == int(ref.entries_total) <= budget
    assert int(out.entries_alive) == int(ref.entries_alive)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("budget", [4096, 64])
def test_subset_stream_alpha_matches_render_fwd(budget):
    """subset_stream's compositor inputs give render_fwd's alpha of the
    same subset (opacity masked off it) at the budget it settles on; a
    budget under the demand is raised to twice the demand."""
    params, _ = _numpy_params(150, seed=6)
    p, alive, inst = _as_numpy(_jax_state(params))
    state = TG.state_from_numpy(p, alive, inst, device="cpu")
    cam = _torch_cam(testing.look_at_camera(width=70, height=45))
    used = torch.from_numpy(
        np.random.default_rng(1).random(state.capacity) < 0.5)
    args, plan, alive_n, used_budget = TP.subset_stream(
        state, cam, used, 70, 45, budget, with_depth=False)
    assert int(plan.total) <= used_budget
    assert used_budget == budget if budget >= int(plan.total) else \
        used_budget >= 2 * int(plan.total)
    img = TP.cuda_raster.composite_fwd_plain(*args)
    out = TP.render_fwd(state, *cam, 70, 45, sh_degree=0, used_mask=used,
                        config=TP.RasterConfig(entry_budget=used_budget),
                        with_color=False, with_depth=False)
    assert img.shape == (1, 45, 70) and float(img.max()) > 0.5
    assert int(out.entries_alive) == alive_n
    assert torch.equal(img[0], out.alpha)


def _tree(root):
    out = set()
    for split in ("train", "test"):
        for d, _, files in os.walk(os.path.join(root, split)):
            out |= {os.path.relpath(os.path.join(d, f), root) for f in files}
    return out


def test_render_sets_tree_matches_jax(tmp_path, monkeypatch):
    from wheat3dgs_tpu.apps import render_sets as jrs
    from wheat3dgs_tpu.io.synthetic import make_synthetic_colmap_scene
    from wheat3dgs_tpu_torch.apps import render_sets as trs

    scene = str(tmp_path / "scene")
    make_synthetic_colmap_scene(scene, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=400,
                                with_masks=False)
    gt = np.load(os.path.join(scene, "gt_points.npz"))
    n = len(gt["points"])
    rng = np.random.default_rng(7)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    params = {
        "means": gt["points"].astype(np.float32),
        "quats": quats / np.linalg.norm(quats, axis=1, keepdims=True),
        "log_scales": (np.log(0.02) + rng.normal(0, 0.2, (n, 3))
                       ).astype(np.float32),
        "sh_dc": rng.normal(0, 0.5, (n, 3)).astype(np.float32),
        "sh_rest": rng.normal(0, 0.05, (n, 9)).astype(np.float32),
        "opacity_logit": rng.normal(1.5, 1.0, n).astype(np.float32),
    }
    state = _jax_state(params, instance_id=gt["head_id"])
    models = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for m in models.values():
        JS.save_ply(state, os.path.join(m, "point_cloud", "iteration_7",
                                        "point_cloud.ply"))
        jcfg.save_cfg_args(m, jcfg.ModelParams(source_path=scene,
                                               model_path=m))
    monkeypatch.setattr(jrs, "inference_config", lambda c: dataclasses.replace(
        c, backend="pallas", pack_payload=False))
    jrs.main(["-m", models["jax"]])
    trs.main(["-m", models["torch"], "--device", "cpu"])

    tree = _tree(models["jax"])
    assert len(tree) == 2 * 12 and _tree(models["torch"]) == tree
    for rel in sorted(tree):
        a = np.asarray(Image.open(os.path.join(models["jax"], rel)),
                       np.int32)
        b = np.asarray(Image.open(os.path.join(models["torch"], rel)),
                       np.int32)
        assert a.shape == b.shape == (48, 64, 3)
        if "/gt/" in rel:
            np.testing.assert_array_equal(a, b)
        else:
            assert a.std() > 1.0
            assert (np.abs(a - b) <= 1).mean() >= 0.999, rel


def test_ply_crosses_between_packages(tmp_path):
    params, _ = _numpy_params(40, seed=2, sh_degree=2)
    inst = np.arange(40, dtype=np.int32) % 5
    jstate = _jax_state(params, instance_id=inst)
    JS.save_ply(jstate, str(tmp_path / "jax.ply"))
    tstate, deg = TS.load_ply(str(tmp_path / "jax.ply"), device="cpu")
    assert deg == 2 and tstate.capacity == jstate.capacity
    for got, want in zip(TG.state_to_numpy(tstate), _as_numpy(jstate)):
        if isinstance(want, dict):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got, want)

    TS.save_ply(tstate, str(tmp_path / "torch.ply"))
    assert (open(tmp_path / "torch.ply", "rb").read()
            == open(tmp_path / "jax.ply", "rb").read())
    back, deg = JS.load_ply(str(tmp_path / "torch.ply"))
    assert deg == 2
    for k, v in _as_numpy(back)[0].items():
        np.testing.assert_array_equal(v, _as_numpy(jstate)[0][k])
    np.testing.assert_array_equal(np.asarray(back.instance_id),
                                  np.asarray(jstate.instance_id))


def test_state_from_numpy_round_trip():
    params, _ = _numpy_params(30, seed=8, sh_degree=1)
    alive = np.random.default_rng(1).random(30) < 0.7
    inst = np.arange(30, dtype=np.int32)
    state = TG.state_from_numpy(params, alive=alive, instance_id=inst,
                                device="cpu")
    assert state.capacity == 30 and state.sh().shape == (30, 12)
    np.testing.assert_array_equal(state.opacity().numpy()[~alive], 0.0)
    p2, a2, i2 = TG.state_to_numpy(state)[:3]
    np.testing.assert_array_equal(a2, alive)
    np.testing.assert_array_equal(i2, inst)
    for k, v in params.items():
        np.testing.assert_array_equal(p2[k], np.asarray(v, np.float32))
    # The JAX state's activations agree on the same numpy leaves.
    jstate = dataclasses.replace(_jax_state(params),
                                 alive=jnp.asarray(np.pad(alive, (0, 994))))
    np.testing.assert_allclose(state.opacity().numpy(),
                               np.asarray(jstate.opacity())[:30],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(state.scales().numpy(),
                               np.asarray(jstate.scales())[:30], rtol=1e-6)
