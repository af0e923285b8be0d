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
"""

import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_seg_eval import _fake_head_map
from wheat3dgs_tpu.io import colmap as JC
from wheat3dgs_tpu.io import synthetic as JY
from wheat3dgs_tpu.seg import eval as JE
from wheat3dgs_tpu_torch.io import synthetic as TY
from wheat3dgs_tpu_torch.models import gaussians as TG
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
