"""The synthetic generator's arguments (wheat3dgs_tpu_torch.io.synthetic:
point_jitter, cam_radius, cam_elev_deg, head_centers, min_visibility,
min_mask_frac) against the JAX generator's, on the CPU.

- The scene points and ring cameras of non-default arguments (placed
  heads, a larger ring, one elevation per ring row of 12) equal JAX's
  exactly, and so do the generator's points3D (the jittered subsample)
  and image poses on disk.
- The defaults written out give the same files, byte for byte, as the
  arguments left out.
- The mask gate (_write_view_masks) at other thresholds writes the same
  masks and boxes as JAX's, from one head map (the model of
  tests/test_torch_seg_eval.py::test_write_view_masks_matches_jax).
- color_noise, at 0.05 (the generator of JAX's exp_bench2 table, commit
  54bd0ea) and at 0.15 (today's): the scene points and colours equal
  JAX's _scene_points / _build_gt_scene exactly; the splat scales are the
  exact 3-NN distance (float64), within 1e-3 in log of JAX's float32
  |a|^2 + |b|^2 - 2ab form; the files the port writes match JAX's writer
  (its _build_gt_scene given the noise) at
  tests/test_torch_seg_eval.py::test_generator_masks_match_jax's mask
  tolerances, with points3D and poses exact and each image within 2
  levels on 99% of its pixels (the rest are splats cut at tile edges:
  JAX's CPU writer draws 16-px tiles, the port 32-px ones). The explicit
  default writes the same files as none.
- knn="bfloat16" sizes the splats with JAX's kNN as a TPU computes it
  (ops/knn.knn_mean_sq_dist_bf16): held to a numpy construction of the
  same float32 formula from bfloat16-rounded operands; on a plot as dense
  as exp_bench2's most splats get the 1e-4 floor; the points, colours and
  draws are those of the exact kNN; another name raises.
"""

import filecmp
import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_seg_eval import _fake_head_map, _masks_by_view
from wheat3dgs_tpu.io import colmap as JC
from wheat3dgs_tpu.io import synthetic as JY
from wheat3dgs_tpu.seg import eval as JE
from wheat3dgs_tpu_torch.io import synthetic as TY
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops import knn as TK
from wheat3dgs_tpu_torch.seg import eval as TE

HEADS = [[-0.3, 0.2], [0.05, 0.1], [0.4, -0.1]]
SIZE = dict(width=32, height=24, n_heads=3, pts_per_head=40, ground_pts=200)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scene_points_and_cameras_match_jax():
    for centers in (None, HEADS):
        want = JY._scene_points(np.random.default_rng(2), 3, 40, 200,
                                head_centers=centers)
        got = TY._scene_points(np.random.default_rng(2), 3, 40, 200,
                               head_centers=centers)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    placed = TY._scene_points(np.random.default_rng(2), 3, 40, 200,
                              head_centers=HEADS)
    for h, (cx, cy) in enumerate(HEADS):
        mean = placed[0][placed[2] == h + 1].mean(0)
        assert abs(mean[0] - cx) < 0.1 and abs(mean[1] - cy) < 0.1
    for radius, elev in ((2.2, 40.0), (3.0, [30.0, 60.0])):
        for (tq, tt), (jq, jt) in zip(TY._ring_cameras(24, radius, elev),
                                      JY._ring_cameras(24, radius, elev)):
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(tt, jt)


def test_generator_arguments_on_disk_match_jax(tmp_path):
    kw = dict(SIZE, n_cams=24, seed=4, point_jitter=0.05, cam_radius=3.0,
              cam_elev_deg=[30.0, 60.0], head_centers=HEADS)
    TY.make_synthetic_colmap_scene(str(tmp_path), plot_id=7,
                                   with_masks=False, device="cpu", **kw)
    sparse = str(tmp_path / "sparse" / "0")
    # The JAX generator's draws: its scene points, then the subsample and
    # its jitter from the same generator.
    rng = np.random.default_rng(4)
    pts, cols, _ = JY._scene_points(rng, 3, 40, 200, head_centers=HEADS)
    sub = rng.choice(len(pts), size=max(len(pts) // 2, 64), replace=False)
    noisy = pts[sub] + rng.normal(0, 0.05, (len(sub), 3))
    xyz, rgb, _ = JC.read_points3D_binary(os.path.join(sparse,
                                                       "points3D.bin"))
    np.testing.assert_array_equal(xyz, noisy.astype(np.float64))
    np.testing.assert_array_equal(rgb, (cols[sub] * 255).astype(np.uint8))
    extr = JC.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
    cams = JY._ring_cameras(24, 3.0, [30.0, 60.0])
    for i, (q, t) in enumerate(cams):
        img = extr[i + 1]
        assert img.name == JY._image_name(7, i, 24)
        np.testing.assert_array_equal(img.qvec, q)
        np.testing.assert_array_equal(img.tvec, t)
    assert extr[13].name == "plot_007_r1_01.png"
    gt = np.load(tmp_path / "gt_points.npz")
    np.testing.assert_array_equal(gt["points"], pts)


def test_generator_defaults_written_out_are_the_same_files(tmp_path):
    kw = dict(SIZE, seed=3, device="cpu")
    TY.make_synthetic_colmap_scene(str(tmp_path / "implicit"), **kw)
    TY.make_synthetic_colmap_scene(
        str(tmp_path / "explicit"), point_jitter=0.02, cam_radius=2.2,
        cam_elev_deg=40.0, head_centers=None, min_visibility=0.35,
        min_mask_frac=6e-4, **kw)
    names = []
    for d, _, files in os.walk(tmp_path / "implicit"):
        names += [os.path.relpath(os.path.join(d, f),
                                  tmp_path / "implicit") for f in files]
    assert len([n for n in names if n.startswith("masks")]) > 0
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "implicit", tmp_path / "explicit", names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


@pytest.mark.parametrize("gate,n_masks", [((0.1, 6e-4), 3),
                                          ((0.35, 0.2), 0),
                                          ((0.95, 0.0), 2)])
def test_mask_gates_match_jax(gate, n_masks, tmp_path, monkeypatch):
    w, h = 64, 48
    pred, amodal = _fake_head_map(w, h)
    monkeypatch.setattr(JE, "eval_obj_labels", lambda *a, **k: (pred,
                                                                amodal))
    monkeypatch.setattr(TE, "eval_obj_labels", lambda *a, **k: (
        torch.from_numpy(pred), torch.from_numpy(amodal)))
    for side in ("jax", "port"):
        for d in ("masks", "bboxes"):
            os.makedirs(tmp_path / side / d)
    JY._write_view_masks(str(tmp_path / "jax"), "plot_000_01", None,
                         np.zeros(8, np.int32), 5, (), w, h, None,
                         min_visibility=gate[0], min_mask_frac=gate[1])
    tstate = TG.init_state(TG.GaussianParams(
        means=torch.zeros((1, 3)), quats=torch.ones((1, 4)),
        log_scales=torch.zeros((1, 3)), sh_dc=torch.zeros((1, 3)),
        sh_rest=torch.zeros((1, 0)), opacity_logit=torch.zeros(1)))
    TY._write_view_masks(str(tmp_path / "port"), "plot_000_01", tstate, 5,
                         (), w, h, None, min_visibility=gate[0],
                         min_mask_frac=gate[1])
    names = sorted(os.listdir(tmp_path / "jax" / "masks"))
    assert names == sorted(os.listdir(tmp_path / "port" / "masks"))
    assert len(names) == n_masks     # the default gate writes 2
    for f in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / "masks" / f)),
            np.asarray(Image.open(tmp_path / "jax" / "masks" / f)))
    np.testing.assert_array_equal(
        TY.load_bboxes(str(tmp_path / "port" / "bboxes" / "plot_000_01.pt")),
        JY.load_bboxes(str(tmp_path / "jax" / "bboxes" / "plot_000_01.pt")))


NOISES = [0.05, 0.15]
# tests/test_torch_seg_eval.py::test_generator_masks_match_jax's scene.
WRITER = dict(width=96, height=72, n_heads=3, pts_per_head=100,
              ground_pts=500, seed=3)


def _exact_log_scales(points):
    d2 = ((points[:, None, :].astype(np.float64)
           - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    dist = np.sqrt(np.maximum(np.sort(d2, 1)[:, :3].mean(1), 1e-12))
    return np.log(np.clip(dist.astype(np.float32) * TY.SPLAT_SCALE,
                          1e-4, 0.1))


@pytest.mark.parametrize("noise", NOISES)
def test_scene_and_gt_params_at_color_noise_match_jax(noise):
    for centers in (None, HEADS):
        want = JY._scene_points(np.random.default_rng(2), 3, 40, 200,
                                head_centers=centers, color_noise=noise)
        got = TY._scene_points(np.random.default_rng(2), 3, 40, 200,
                               head_centers=centers, color_noise=noise)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    j = JY._build_gt_scene(SIZE["width"], SIZE["height"], 12, 3, 40, 200, 5,
                           2.2, 40.0, None, color_noise=noise)
    rng, params, colors, head_id = TY.gt_params(3, 40, 200, 5,
                                                color_noise=noise)
    n = len(colors)
    np.testing.assert_array_equal(params["means"], j[1])
    np.testing.assert_array_equal(colors, j[2])
    np.testing.assert_array_equal(head_id, j[3])
    jp = j[4].params
    for k in ("means", "quats", "sh_dc", "opacity_logit"):
        np.testing.assert_array_equal(params[k],
                                      np.asarray(getattr(jp, k))[:n])
    np.testing.assert_allclose(params["log_scales"][:, 0],
                               _exact_log_scales(params["means"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(params["log_scales"],
                               np.asarray(jp.log_scales)[:n], rtol=0,
                               atol=1e-3)
    # The draws after the scene (points3D's subsample) continue alike.
    np.testing.assert_array_equal(rng.integers(1 << 30, size=4),
                                  j[0].integers(1 << 30, size=4))
    # The noise is the colours' spread about the ground's base colour.
    ground = colors[head_id == 0] - np.array([0.25, 0.45, 0.15])
    assert abs(ground.std() / noise - 1) < 0.15


@pytest.mark.parametrize("noise", NOISES)
def test_writer_at_color_noise_matches_jax(noise, tmp_path, monkeypatch):
    monkeypatch.setattr(JY, "_build_gt_scene", functools.partial(
        JY._build_gt_scene, color_noise=noise))
    JY.make_synthetic_colmap_scene(str(tmp_path / "jax"), **WRITER)
    TY.make_synthetic_colmap_scene(str(tmp_path / "port"), device="cpu",
                                   color_noise=noise, **WRITER)
    sparse = {k: str(tmp_path / k / "sparse" / "0") for k in ("jax", "port")}
    for a, b in zip(*(JC.read_points3D_binary(os.path.join(sparse[k],
                                                           "points3D.bin"))
                      for k in ("port", "jax"))):
        np.testing.assert_array_equal(a, b)
    je, te = (JC.read_extrinsics_binary(os.path.join(sparse[k],
                                                     "images.bin"))
              for k in ("jax", "port"))
    assert sorted(je) == sorted(te)
    for i in je:
        assert te[i].name == je[i].name
        np.testing.assert_array_equal(te[i].qvec, je[i].qvec)
        np.testing.assert_array_equal(te[i].tvec, je[i].tvec)
    a, b = (np.load(tmp_path / k / "gt_points.npz") for k in ("port", "jax"))
    for key in ("points", "head_id"):
        np.testing.assert_array_equal(a[key], b[key])
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images"))
    for f in names:
        a, b = (np.asarray(Image.open(tmp_path / k / "images" / f), np.int32)
                for k in ("port", "jax"))
        assert (np.abs(a - b) <= 2).mean() >= 0.99, f
    # The masks at test_generator_masks_match_jax's tolerances.
    jm, tm = (_masks_by_view(str(tmp_path / k)) for k in ("jax", "port"))
    matched = 0
    for v in (n[:-4] for n in names):
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


def test_color_noise_sets_the_texture(tmp_path):
    """The 0.05 scene's images are smoother than the 0.15 scene's (mean
    horizontal step), and its explicit default writes the same files as
    none."""
    kw = dict(SIZE, seed=3, with_masks=False, device="cpu")
    steps = {}
    for noise in NOISES:
        out = tmp_path / str(noise)
        TY.make_synthetic_colmap_scene(str(out), color_noise=noise, **kw)
        img = np.asarray(Image.open(out / "images" / "plot_000_11.png"),
                         np.float64)
        steps[noise] = np.abs(np.diff(img, axis=1)).mean()
    assert steps[0.05] < 0.8 * steps[0.15]
    TY.make_synthetic_colmap_scene(str(tmp_path / "implicit"), **kw)
    names = [os.path.relpath(os.path.join(d, f), tmp_path / "implicit")
             for d, _, files in os.walk(tmp_path / "implicit")
             for f in files]
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "implicit", tmp_path / str(TY.COLOR_NOISE), names,
        shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def _bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def test_tpu_knn_matches_its_formula():
    pts = TY._scene_points(np.random.default_rng(1), 3, 40, 200)[0]
    sq = (pts * pts).sum(-1)
    low = _bf16(pts)
    d2 = (sq[:, None] + sq[None, :]) - np.float32(2) * (low @ low.T)
    np.fill_diagonal(d2, np.inf)
    want = np.sort(d2, 1)[:, :3].mean(1)
    got = TK.knn_mean_sq_dist_bf16(pts, block=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(_bf16(low), low)


def test_gt_params_tpu_knn():
    """Heads as dense as exp_bench2's (3,000 points each): most head
    splats at the floor, where the exact kNN puts none; everything but
    the scales as the exact kNN's."""
    centers = [[-0.1, 0.0], [0.1, 0.05]]
    exact = TY.gt_params(2, 3000, 800, 0, head_centers=centers)
    tpu = TY.gt_params(2, 3000, 800, 0, head_centers=centers,
                       knn="bfloat16")
    for a, b in zip(exact[2:], tpu[2:]):
        np.testing.assert_array_equal(a, b)
    for k in ("means", "quats", "sh_dc", "opacity_logit"):
        np.testing.assert_array_equal(exact[1][k], tpu[1][k])
    heads = tpu[3] > 0
    floor = np.log(1e-4) + 1e-6
    assert (tpu[1]["log_scales"][heads, 0] <= floor).mean() > 0.7
    assert not (exact[1]["log_scales"][:, 0] <= floor).any()
    assert exact[0].integers(1 << 30) == tpu[0].integers(1 << 30)
    with pytest.raises(ValueError, match="knn"):
        TY.gt_params(2, 40, 80, 0, knn="float16")
