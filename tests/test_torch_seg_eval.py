"""The port's segmentation slice against the JAX package as a whole:
eval_obj_labels, the synthetic masks, run_segmentation on one scene and
model that both packages read, and the evaluation that follows.

The JAX side runs its XLA rasterizer at the port's 32-px tiles with caps
that crop nothing at these sizes (RasterConfig(tile=32,
max_tiles_per_gauss=64, max_per_tile=1024)), except where the JAX
generator renders at its own settings (16-px tiles, max_tiles_per_gauss
32, max_per_tile 256). The port runs its kernels' plain versions.

Tolerances:
- eval_obj_labels: the head map equal to JAX's but on pixels whose alpha,
  in JAX's render of one of the heads, lies within 1e-4 of the 0.5 claim
  threshold, and those at most 0.1% of the pixels (float32 compositing in
  another order).
- _write_view_masks given the same head map and footprints: the same PNGs
  and bboxes, exactly.
- The whole generator: the two packages render at other tile sizes, so
  per view the mask count within +-1 (a head can sit at the visibility
  gate) and each JAX mask of >= 200 px matched by a port mask at IoU >=
  0.9.
- run_segmentation: the same head count, the same results.csv rows (id,
  initial mask, number of matched views; Gaussian count within 1%), and
  >= 99.5% of the 2DSeg pixels equal. labels_from_seg_maps: all_counts
  within 1e-4 of each row's max |value|.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wheat3dgs_tpu import config as jcfg
from wheat3dgs_tpu import testing
from wheat3dgs_tpu.io import synthetic as JY
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.models import serialization as JSer
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu.render.pipeline import render_fwd as j_render_fwd
from wheat3dgs_tpu.seg import eval as JE
from wheat3dgs_tpu_torch import config as tcfg
from wheat3dgs_tpu_torch.io import synthetic as TY
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.render.pipeline import RasterConfig as TConfig
from wheat3dgs_tpu_torch.render.pipeline import adapt_config
from wheat3dgs_tpu_torch.seg import eval as TE

JAX_CONFIG = JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=1024)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run many small torch ops on the CPU; with the suite's
    parallel workers, torch's default of one thread per core oversubscribes
    the host, so they use two threads while they run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_eval_obj_labels_matches_jax():
    n, cap, w, h = 90, 128, 64, 48
    g = testing.random_gaussians(n=n, seed=12, spread=0.6)
    o = np.clip(g["opacities"] * 0.5 + 0.5, 1e-4, 1 - 1e-4)
    params = {"means": g["means3d"], "quats": g["quats"],
              "log_scales": np.log(g["scales"] * 1.5), "sh_dc": g["colors"],
              "sh_rest": np.zeros((n, 0), np.float32),
              "opacity_logit": np.log(o / (1 - o)).astype(np.float32)}
    jstate = JG.init_state(JG.GaussianParams(
        **{k: jnp.asarray(v) for k, v in params.items()}), capacity=cap)
    tstate = TG.init_state(TG.GaussianParams(
        **{k: torch.as_tensor(np.asarray(v, np.float32))
           for k, v in params.items()}), capacity=cap)
    head = np.random.default_rng(0).integers(0, 5, size=cap)  # 4 heads
    head[4::9] = 0
    labels = np.arange(6)[:, None] == head[None, :]           # row 5 empty
    cam = testing.look_at_camera(width=w, height=h)
    jc = (jnp.asarray(cam.w2c), jnp.asarray(cam.full_proj),
          jnp.asarray(cam.cam_center), jnp.float32(cam.tanfovx),
          jnp.float32(cam.tanfovy))
    tc = (torch.from_numpy(cam.w2c), torch.from_numpy(cam.full_proj),
          torch.from_numpy(cam.cam_center), cam.tanfovx, cam.tanfovy)
    want, j_areas = JE.eval_obj_labels(jstate, jnp.asarray(labels), *jc,
                                       width=w, height=h, config=JAX_CONFIG,
                                       with_areas=True)
    got, t_areas = TE.eval_obj_labels(tstate, torch.from_numpy(labels), *tc,
                                      width=w, height=h, config=TConfig(),
                                      with_areas=True)
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.int32 and len(np.unique(got)) >= 4
    near = np.zeros((h, w), bool)
    for row in labels[1:5]:
        a = np.asarray(j_render_fwd(
            jstate, *jc, w, h, 0, used_mask=jnp.asarray(row),
            config=JAX_CONFIG, with_color=False).alpha)
        near |= np.abs(a - 0.5) <= 1e-4
    off = got != want
    assert not (off & ~near).any()
    assert off.mean() <= 1e-3
    assert np.abs(t_areas.numpy() - np.asarray(j_areas)).max() <= near.sum()


def _fake_head_map(w, h):
    """A depth-resolved head map with speckle, a hole, two components, a
    head below the pixel floor and a head mostly hidden."""
    pred = np.zeros((h, w), np.int32)
    pred[5:25, 4:20] = 1
    pred[12:15, 10:13] = 0                      # hole
    pred[8, 5::3] = 0                           # speckle
    pred[30:44, 30:52] = 2
    pred[30:33, 55:60] = 2                      # a second component
    pred[2:4, 40:43] = 3                        # 6 px: below 12 px
    pred[20:28, 40:50] = 4                      # visible 80 of 400 amodal
    amodal = np.array([3000, 300, 330, 6, 400, 0], np.int32)
    return pred, amodal


def test_write_view_masks_matches_jax(tmp_path, monkeypatch):
    w, h = 64, 48
    pred, amodal = _fake_head_map(w, h)

    def fake_eval(*args, **kwargs):
        return pred, amodal

    monkeypatch.setattr(JE, "eval_obj_labels", fake_eval)
    monkeypatch.setattr(TE, "eval_obj_labels", lambda *a, **k: (
        torch.from_numpy(pred), torch.from_numpy(amodal)))
    roots = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        for d in ("masks", "bboxes"):
            os.makedirs(root / d)
        roots[side] = root
    JY._write_view_masks(str(roots["jax"]), "plot_000_01", None,
                         np.zeros(8, np.int32), 5, (), w, h, None)
    tstate = TG.init_state(TG.GaussianParams(
        means=torch.zeros((1, 3)), quats=torch.ones((1, 4)),
        log_scales=torch.zeros((1, 3)), sh_dc=torch.zeros((1, 3)),
        sh_rest=torch.zeros((1, 0)), opacity_logit=torch.zeros(1)))
    TY._write_view_masks(str(roots["port"]), "plot_000_01", tstate, 5,
                         (), w, h, None)
    names = sorted(os.listdir(roots["jax"] / "masks"))
    assert names == sorted(os.listdir(roots["port"] / "masks"))
    assert names == ["plot_000_01_000.png", "plot_000_01_001.png"]
    for f in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(roots["port"] / "masks" / f)),
            np.asarray(Image.open(roots["jax"] / "masks" / f)))
    np.testing.assert_array_equal(
        TY.load_bboxes(str(roots["port"] / "bboxes" / "plot_000_01.pt")),
        JY.load_bboxes(str(roots["jax"] / "bboxes" / "plot_000_01.pt")))


def _masks_by_view(root):
    out = {}
    for f in sorted(os.listdir(os.path.join(root, "masks"))):
        view = f.rsplit("_", 1)[0]
        m = np.asarray(Image.open(os.path.join(root, "masks", f))) > 0
        out.setdefault(view, []).append(m)
    return out


def test_generator_masks_match_jax(tmp_path):
    kw = dict(width=96, height=72, n_heads=3, pts_per_head=100,
              ground_pts=500, seed=3)
    JY.make_synthetic_colmap_scene(str(tmp_path / "jax"), **kw)
    TY.make_synthetic_colmap_scene(str(tmp_path / "port"), device="cpu", **kw)
    jm = _masks_by_view(str(tmp_path / "jax"))
    tm = _masks_by_view(str(tmp_path / "port"))
    views = [f"plot_000_{i:02d}" for i in range(1, 13)]
    matched = 0
    for v in views:
        a, b = jm.get(v, []), tm.get(v, [])
        assert abs(len(a) - len(b)) <= 1, v
        for m in a:
            if m.sum() < 200:
                continue
            best = max((np.logical_and(m, x).sum() / np.logical_or(m, x).sum()
                        for x in b), default=0.0)
            assert best >= 0.9, (v, best)
            matched += 1
    assert matched >= 12
    for v in views:
        boxes = TY.load_bboxes(str(tmp_path / "port" / "bboxes" / f"{v}.pt"))
        assert boxes.shape == (len(tm.get(v, [])), 4)


@pytest.fixture(scope="module")
def shared_scene(tmp_path_factory):
    """A JAX-written scene with masks and a JAX-written "trained" model:
    the generator's ground-truth splats (as a trained model, with no head
    ids) saved with JAX's save_ply. Both packages read the same files."""
    root = tmp_path_factory.mktemp("segslice")
    scene_dir, model_dir = str(root / "scene"), str(root / "model")
    kw = dict(width=64, height=48, n_heads=3, pts_per_head=100,
              ground_pts=500, seed=3)
    JY.make_synthetic_colmap_scene(scene_dir, **kw)
    state = JY._build_gt_scene(kw["width"], kw["height"], 12, kw["n_heads"],
                               kw["pts_per_head"], kw["ground_pts"],
                               kw["seed"], 2.2, 40.0, None)[4]
    state = dataclasses.replace(state,
                                instance_id=jnp.zeros_like(state.instance_id))
    JSer.save_ply(state, os.path.join(model_dir, "point_cloud",
                                      "iteration_100", "point_cloud.ply"))
    jcfg.save_cfg_args(model_dir, jcfg.ModelParams(source_path=scene_dir,
                                                   model_path=model_dir))
    return scene_dir, model_dir


def _run_jax(scene_dir, model_dir, out):
    from wheat3dgs_tpu.apps.run_3d_seg_app import build_context
    from wheat3dgs_tpu.scene import Scene
    from wheat3dgs_tpu.seg.pipeline import run_segmentation

    scene = Scene(jcfg.ModelParams(source_path=scene_dir,
                                   model_path=model_dir),
                  load_iteration=-1, shuffle=False)
    ctx = build_context(scene, JAX_CONFIG)
    c = scene.data.test.cameras
    names = [m.image_name for m in scene.data.test.metas]
    res = run_segmentation(
        ctx, out, "e", eval_names=names,
        eval_cams=(c.w2c, c.full_proj, c.cam_center, c.tanfovx, c.tanfovy),
        verbose=False)
    return scene, res


def _run_port(scene_dir, model_dir, out):
    from wheat3dgs_tpu_torch.apps.run_3d_seg_app import build_context
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.seg.pipeline import run_segmentation

    scene = Scene(tcfg.ModelParams(source_path=scene_dir,
                                   model_path=model_dir),
                  load_iteration=-1, shuffle=False, device="cpu")
    w, h = scene.image_size
    config = adapt_config(
        scene.gaussians, scene.cam_arrays("train", 0), w, h,
        cams=[scene.cam_arrays("train", i)
              for i in range(len(scene.data.train))])
    ctx = build_context(scene, config)
    names = [m.image_name for m in scene.data.test.metas]
    res = run_segmentation(ctx, out, "e", eval_names=names,
                           eval_cams=scene.cam_stack("test"), verbose=False)
    return scene, config, res


def _rows(base):
    import csv

    with open(os.path.join(base, "results.csv")) as f:
        return list(csv.reader(f))


def test_segmentation_slice_matches_jax(shared_scene, tmp_path):
    from wheat3dgs_tpu.seg.eval import labels_from_seg_maps as j_labels
    from wheat3dgs_tpu.seg.pipeline import load_pt
    from wheat3dgs_tpu_torch.apps import eval_wheatgs_app

    scene_dir, model_dir = shared_scene
    j_scene, j_res = _run_jax(scene_dir, model_dir, str(tmp_path / "jax"))
    t_scene, t_config, t_res = _run_port(scene_dir, model_dir,
                                         str(tmp_path / "port"))
    assert t_res["num_heads"] == j_res["num_heads"] >= 2
    j_rows, t_rows = _rows(j_res["out_dir"]), _rows(t_res["out_dir"])
    assert len(t_rows) == len(j_rows) >= 3
    for a, b in zip(j_rows[1:], t_rows[1:]):
        assert b[:3] == a[:3]
        assert abs(int(b[3]) - int(a[3])) <= 0.01 * int(a[3])
    assert sorted(os.listdir(os.path.join(t_res["out_dir"], "ply"))) == \
        sorted(os.listdir(os.path.join(j_res["out_dir"], "ply")))
    seg = {}
    for side, res in (("jax", j_res), ("port", t_res)):
        d = os.path.join(res["out_dir"], "2DSeg")
        seg[side] = {f: load_pt(os.path.join(d, f)) for f in os.listdir(d)}
    assert sorted(seg["port"]) == sorted(seg["jax"]) and len(seg["jax"]) == 12
    same = np.mean([np.mean(seg["port"][f] == seg["jax"][f])
                    for f in seg["jax"]])
    assert same >= 0.995
    ids = set()
    for m in seg["port"].values():
        ids |= set(np.unique(m).tolist())
    assert len(ids - {0}) == t_res["num_heads"]

    # Labels from the (port's) 2DSeg maps, in both packages.
    names = [m.image_name for m in t_scene.data.train.metas]
    maps = [seg["port"][f"{n}.pt"] for n in names]
    jc = j_scene.data.train.cameras
    j_counts, j_lab = j_labels(
        j_scene.gaussians, (jc.w2c, jc.full_proj, jc.cam_center, jc.tanfovx,
                            jc.tanfovy), maps, 64, 48, JAX_CONFIG)
    t_counts, t_lab = TE.labels_from_seg_maps(
        t_scene.gaussians, t_scene.cam_stack("train"), maps, 64, 48,
        t_config)
    scale = np.abs(j_counts).max(axis=1, keepdims=True)
    assert (scale > 0).all()
    assert (np.abs(t_counts - j_counts) / scale).max() <= 1e-4
    assert (t_lab != j_lab).mean() <= 1e-3

    # The port's evaluation CLI over its own segmentation (written under
    # tmp_path/port, made a model dir of the shared model).
    port_model = tmp_path / "port"
    tcfg.save_cfg_args(str(port_model), tcfg.ModelParams(
        source_path=scene_dir, model_path=str(port_model)))
    os.makedirs(port_model / "point_cloud")
    os.symlink(os.path.join(model_dir, "point_cloud", "iteration_100"),
               port_model / "point_cloud" / "iteration_100")
    labels = eval_wheatgs_app.main(["-m", str(port_model), "--exp_name", "e",
                                    "--device", "cpu"])
    app_counts = load_pt(str(port_model / "wheat-head" / "e" /
                             "all_counts.pt"))
    assert (np.abs(app_counts - j_counts) / scale).max() <= 1e-4
    assert labels.shape == j_lab.shape
    for split, n in (("train", 10), ("test", 2)):
        for sub in ("segmentation", "overlay"):
            files = os.listdir(port_model / split / sub)
            assert len(files) == n, (split, sub)
        seg_png = np.asarray(Image.open(
            port_model / split / "segmentation" / sorted(files)[0]))
        assert seg_png.shape == (48, 64) and seg_png.max() == 255
