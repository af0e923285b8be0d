"""The port's 360° path (render/camera_paths.py, utils/video.py,
apps/render_360_app.py) against the JAX package's.

- camera_paths: every function's arrays equal JAX's exactly (the same
  numpy code on the same inputs).
- write_video: an mp4 through OpenCV; a GIF beside the asked path when
  OpenCV cannot be imported.
- _orbit_frames at 64x48 over 3 frames, with and without the head
  overlay, at one explicit entry budget, against JAX's on its Pallas path
  (interpret mode, pack_payload=False; the JAX app itself renders with the
  XLA RasterConfig(), see ROADMAP C): every uint8 level within 1.
- A frame whose demand exceeds the budget raises; a config without a
  probed budget is refused.
- render_360_app.main, field then head, on a tiny scene and stand-in
  model made by the port's generator and segmented by run_3d_seg_app:
  the artifact tree (all_counts.pth, all_obj_labels.pth, the field video,
  one video per head without a letter suffix, no frame directories left),
  and all_obj_labels.pth equal to JAX's labels_from_seg_maps on the same
  2DSeg maps (JAX's lift on its XLA backend at the port's 32-px tiles and
  caps that cannot crop), all_counts.pth within 1e-4 of each row's max.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu import testing
from wheat3dgs_tpu.apps import render_360_app as JA
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.render import camera_paths as JC
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu_torch.apps import render_360_app as TA
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.render import camera_paths as TC
from wheat3dgs_tpu_torch.render.pipeline import RasterConfig as TConfig
from wheat3dgs_tpu_torch.utils import video as TV

W, H = 64, 48
BUDGET = 8192


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_camera_paths_equal_jax():
    args = (7, 2)
    kw = dict(camera_distance=3.5, cam_center=(0.2, -0.1, 0.4),
              elevation=35.0)
    a = TC.camera_path_fixed_elevation(*args, **kw)
    b = JC.camera_path_fixed_elevation(*args, **kw)
    np.testing.assert_array_equal(a, b)
    up, look, pos = (np.array([0, 0, 1.0]), np.zeros(3),
                     np.array([2.0, 1.0, 1.5]))
    np.testing.assert_array_equal(TC.c2w_from_up_and_look_at(up, look, pos),
                                  JC.c2w_from_up_and_look_at(up, look, pos))
    for x, y in zip(TC.c2ws_to_camera_arrays(a, 0.9, 0.7),
                    JC.c2ws_to_camera_arrays(b, 0.9, 0.7)):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 4))
    rots = [_rot(v / np.linalg.norm(v)) for v in q]
    t1, t2 = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_array_equal(
        TC.interpolate_viewpoints(rots[0], t1, rots[1], t2, 0.9, 0.7, n=5),
        JC.interpolate_viewpoints(rots[0], t1, rots[1], t2, 0.9, 0.7, n=5))


def _rot(q):
    from wheat3dgs_tpu_torch.utils.graphics import qvec_to_rotmat

    return qvec_to_rotmat(q)


def _frames(n=3, h=24, w=32):
    rng = np.random.default_rng(1)
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(n)]


def test_write_video_mp4(tmp_path):
    pytest.importorskip("cv2")
    out = TV.write_video(_frames(), str(tmp_path / "v" / "a.mp4"), fps=5)
    assert out.endswith("a.mp4") and os.path.getsize(out) > 0


def test_write_video_gif_without_cv2(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setitem(sys.modules, "cv2", None)      # import fails
    frames = _frames(h=25, w=33)
    out = TV.write_video(frames, str(tmp_path / "a.mp4"), fps=5)
    assert out == str(tmp_path / "a.gif")
    img = Image.open(out)
    assert img.n_frames == 3 and img.size == (32, 24)  # even dimensions


def _states(n=160, cap=256, seed=8):
    g = testing.random_gaussians(n=n, seed=seed, spread=0.8, sh_degree=1)
    o = np.clip(g["opacities"] * 0.5 + 0.5, 1e-4, 1 - 1e-4)
    p = {"means": g["means3d"], "quats": g["quats"],
         "log_scales": np.log(g["scales"] * 1.3),
         "sh_dc": g["sh"][:, 0], "sh_rest": g["sh"][:, 1:].reshape(n, -1),
         "opacity_logit": np.log(o / (1 - o)).astype(np.float32)}
    js = JG.init_state(JG.GaussianParams(
        **{k: jnp.asarray(v) for k, v in p.items()}), capacity=cap)
    ts = TG.init_state(TG.GaussianParams(
        **{k: torch.as_tensor(np.asarray(v, np.float32))
           for k, v in p.items()}), capacity=cap)
    head = np.random.default_rng(seed).integers(0, 4, size=cap)
    labels = np.arange(5)[:, None] == head[None, :]        # row 4 empty
    return js, ts, labels


def _orbit():
    c2ws = TC.camera_path_fixed_elevation(3, 1, camera_distance=4.0,
                                          cam_center=(0.0, 0.0, 0.0),
                                          elevation=30.0)
    return c2ws, 0.9, 2 * np.arctan(np.tan(0.45) * H / W)


@pytest.mark.parametrize("overlay", [False, True])
def test_orbit_frames_match_jax(overlay):
    js, ts, labels = _states()
    c2ws, fovx, fovy = _orbit()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    lab = labels if overlay else None
    want = JA._orbit_frames(
        js, 1, c2ws, fovx, fovy, W, H, jnp.asarray(bg),
        JConfig(backend="pallas", pack_payload=False, entry_budget=BUDGET),
        obj_labels=lab)
    got = TA._orbit_frames(ts, 1, c2ws, fovx, fovy, W, H,
                           torch.from_numpy(bg),
                           TConfig(entry_budget=BUDGET), obj_labels=lab)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape == (H, W, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    if overlay:
        plain = TA._orbit_frames(ts, 1, c2ws, fovx, fovy, W, H,
                                 torch.from_numpy(bg),
                                 TConfig(entry_budget=BUDGET))
        assert any((a != b).any() for a, b in zip(got, plain))


def test_orbit_budget_is_checked_every_frame():
    _, ts, _ = _states()
    c2ws, fovx, fovy = _orbit()
    bg = torch.zeros(3)
    probed = TA.orbit_config(ts, c2ws, fovx, fovy, W, H)
    assert probed.entry_budget > 128
    TA._orbit_frames(ts, 1, c2ws, fovx, fovy, W, H, bg, probed)
    with pytest.raises(RuntimeError, match="over the probed budget"):
        TA._orbit_frames(ts, 1, c2ws, fovx, fovy, W, H, bg,
                         TConfig(entry_budget=128))
    with pytest.raises(ValueError, match="probed entry budget"):
        TA._orbit_frames(ts, 1, c2ws, fovx, fovy, W, H, bg, TConfig())


@pytest.fixture(scope="module")
def segmented(tmp_path_factory):
    """A tiny port-written scene and stand-in model, segmented by the
    port's run_3d_seg_app (experiment "e"), with two torch threads (as
    tests/test_torch_seg_eval.py runs its segmentation)."""
    from wheat3dgs_tpu_torch.apps import run_3d_seg_app
    from wheat3dgs_tpu_torch.io.synthetic import (make_synthetic_colmap_scene,
                                                  write_stand_in_model)

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("seg360")
    scene, model = str(root / "scene"), str(root / "model")
    try:
        make_synthetic_colmap_scene(scene, width=W, height=H, n_cams=8,
                                    n_heads=3, pts_per_head=80,
                                    ground_pts=400, seed=3, device="cpu")
        write_stand_in_model(model, scene, 3, 80, 400, 3, device="cpu")
        run_3d_seg_app.main(["-s", scene, "-m", model, "--exp_name", "e",
                             "--device", "cpu", "--quiet"])
    finally:
        torch.set_num_threads(n)
    return scene, model


def test_render_360_app_field_and_head(segmented):
    from wheat3dgs_tpu import config as jcfg
    from wheat3dgs_tpu.scene import Scene as JScene
    from wheat3dgs_tpu.seg.eval import labels_from_seg_maps as j_labels
    from wheat3dgs_tpu.seg.pipeline import load_pt

    scene_dir, model = segmented
    base = os.path.join(model, "wheat-head", "e")
    field = TA.main(["-m", model, "--exp_name", "e", "--render_type",
                     "field", "--n_frames", "4", "--framerate", "20",
                     "--elevation", "45", "--device", "cpu"])
    assert field in (os.path.join(base, "wheat_field_360.mp4"),
                     os.path.join(base, "wheat_field_360.gif"))
    assert os.path.getsize(field) > 0
    assert not os.path.exists(os.path.join(base, "3DSeg"))
    heads = TA.main(["-m", model, "--exp_name", "e", "--render_type",
                     "head", "--n_frames", "3", "--framerate", "10",
                     "--elevation", "30", "--device", "cpu"])
    plys = sorted(f for f in os.listdir(os.path.join(base, "ply"))
                  if f.startswith("wh_") and len(f[:-4].split("_")) == 2)
    assert len(plys) >= 2
    assert [os.path.splitext(os.path.basename(v))[0] for v in heads] == \
        [f[3:-4] for f in plys]
    assert all(os.path.getsize(v) > 0 for v in heads)
    assert sorted(os.listdir(os.path.join(base, "wheat_head_360"))) == \
        sorted(os.path.basename(v) for v in heads)

    counts = load_pt(os.path.join(base, "all_counts.pth"))
    labels = load_pt(os.path.join(base, "all_obj_labels.pth"))
    js = JScene(jcfg.ModelParams(source_path=scene_dir, model_path=model),
                load_iteration=-1, shuffle=False)
    c = js.data.train.cameras
    maps = [load_pt(os.path.join(base, "2DSeg", f"{m.image_name}.pt"))
            for m in js.data.train.metas]
    # Caps that cannot crop: every tile of the image per splat, every
    # alive splat per tile.
    tiles = -(-W // 32) * -(-H // 32)
    alive = int(np.asarray(js.gaussians.alive).sum())
    j_counts, j_lab = j_labels(
        js.gaussians, (c.w2c, c.full_proj, c.cam_center, c.tanfovx,
                       c.tanfovy), maps, W, H,
        JConfig(tile=32, max_tiles_per_gauss=tiles, max_per_tile=alive))
    assert labels.dtype == np.bool_ and labels.shape == j_lab.shape
    assert labels[1:].any(axis=1).all()
    np.testing.assert_array_equal(labels, j_lab)
    scale = np.abs(j_counts).max(axis=1, keepdims=True)
    assert (np.abs(counts - j_counts) / np.maximum(scale, 1e-30)).max() \
        <= 1e-4
