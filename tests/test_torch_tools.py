"""The port's numpy helpers against the JAX package's, on the CPU:
io/depth_scale.py (make_depth_scales, main), utils/geometry2d.py and
image_ops' bbox IoU, precision, recall and palette. Both packages run the
same numpy arithmetic, so the results are held equal exactly."""

import json

import numpy as np
import pytest
from PIL import Image

from wheat3dgs_tpu.io import colmap as JC
from wheat3dgs_tpu.io import depth_scale as JD
from wheat3dgs_tpu.utils import geometry2d as JG2
from wheat3dgs_tpu.utils import image_ops as JI
from wheat3dgs_tpu_torch.io import depth_scale as TD
from wheat3dgs_tpu_torch.utils import geometry2d as TG2
from wheat3dgs_tpu_torch.utils import image_ops as TI


def _depth_scene(root):
    """tests/test_io.py::test_depth_scale_alignment's scene (one camera,
    a smooth inverse-depth field at 0.5 x the true one + 0.002), plus an
    image with no depth PNG and one with too few tracks to fit."""
    rng = np.random.default_rng(0)
    n = 200
    xyz = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                    rng.uniform(2.0, 6.0, n)], 1)
    fx = fy = 100.0
    w, h = 128, 96
    uv = np.stack([fx * xyz[:, 0] / xyz[:, 2] + w / 2,
                   fy * xyz[:, 1] / xyz[:, 2] + h / 2], 1)
    keep = ((uv[:, 0] > 1) & (uv[:, 0] < w - 2)
            & (uv[:, 1] > 1) & (uv[:, 1] < h - 2))
    xyz, uv = xyz[keep], uv[keep]
    xyz[:, 2] = 2.0 + 4.0 * (uv[:, 0] / w)
    ids = np.arange(1, len(xyz) + 1)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    intr = {1: JC.ColmapCamera(1, "PINHOLE", w, h,
                               np.array([fx, fy, w / 2, h / 2]))}
    q = np.array([1.0, 0, 0, 0])
    extr = {1: JC.ColmapImage(1, q, np.zeros(3), 1, "img.png", uv, ids),
            2: JC.ColmapImage(2, q, np.zeros(3), 1, "nodepth.png", uv, ids),
            3: JC.ColmapImage(3, q, np.zeros(3), 1, "few.png", uv[:8],
                              ids[:8])}
    JC.write_model(str(sparse), intr, extr,
                   (xyz, np.zeros((len(xyz), 3), np.uint8)))
    depths = root / "depths"
    depths.mkdir()
    xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")[1]
    inv_map = 0.5 * (1.0 / (2.0 + 4.0 * (xx / w))) + 0.002
    for name in ("img", "few"):
        Image.fromarray((inv_map * 2 ** 16).astype(np.uint16)).save(
            depths / f"{name}.png")
    return root, depths


def test_depth_scales_match_jax(tmp_path):
    base, depths = _depth_scene(tmp_path)
    want = JD.make_depth_scales(str(base), str(depths))
    got = TD.make_depth_scales(str(base), str(depths))
    assert got == want
    assert set(got) == {"img", "few"}
    assert got["img"]["scale"] == pytest.approx(2.0, rel=0.05)
    assert got["img"]["offset"] == pytest.approx(-0.004, abs=5e-4)
    assert got["few"] == {"scale": 0.0, "offset": 0.0}
    out = base / "sparse" / "0" / "depth_params.json"
    out.unlink()
    TD.main(["--base_dir", str(base), "--depths_dir", str(depths)])
    assert json.load(open(out)) == want


def _polygons():
    rng = np.random.default_rng(4)
    out = []
    for _ in range(12):
        c, (a, b) = rng.uniform(-2, 2, 2), rng.uniform(0.3, 2.0, 2)
        th = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        rect = np.array([[-a, -b], [a, -b], [a, b], [-a, b]]) @ rot.T + c
        out.append(rect if rng.random() < 0.5 else rect[::-1].copy())
    return out


def test_geometry2d_matches_jax():
    polys = _polygons()
    for i, p in enumerate(polys):
        assert TG2.polygon_area(p) == JG2.polygon_area(p)
        for q in polys[i + 1:]:
            np.testing.assert_array_equal(TG2.clip_convex(p, q),
                                          JG2.clip_convex(p, q))
            assert TG2.intersection_area(p, q) == JG2.intersection_area(p, q)
            assert TG2.polygon_distance(p, q) == JG2.polygon_distance(p, q)
        _, t_idx = TG2.find_best_match(p, polys[:i] + polys[i + 1:])
        _, j_idx = JG2.find_best_match(p, polys[:i] + polys[i + 1:])
        assert t_idx == j_idx
    # tests/test_tools.py::test_polygon_helpers
    sq = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], float)
    half = np.array([[1, 0], [3, 0], [3, 2], [1, 2]], float)
    assert TG2.intersection_area(sq, half) == pytest.approx(2.0, rel=1e-6)
    far = half + 10
    assert TG2.find_best_match(sq, [far, half])[1] == 1
    assert TG2.find_best_match(sq, [far, far + 5])[1] == 0   # the nearest
    centers = np.random.default_rng(1).normal(size=(9, 3))
    for k in (1, 3, 9):
        np.testing.assert_array_equal(
            TG2.nearest_k_viewpoints(centers[2] + 0.1, centers, k=k),
            JG2.nearest_k_viewpoints(centers[2] + 0.1, centers, k=k))


def test_bbox_iou_precision_recall_palette_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        b1 = np.sort(rng.uniform(0, 10, (2, 2)), axis=0).T.reshape(-1)
        b2 = np.sort(rng.uniform(0, 10, (2, 2)), axis=0).T.reshape(-1)
        b1, b2 = b1[[0, 2, 1, 3]], b2[[0, 2, 1, 3]]
        assert TI.calculate_bbox_iou(b1, b2) == JI.calculate_bbox_iou(b1, b2)
    assert TI.calculate_bbox_iou((0, 0, 2, 2), (1, 1, 3, 3)) == \
        pytest.approx(1 / 7)
    assert TI.calculate_bbox_iou((0, 0, 0, 0), (0, 0, 0, 0)) == 0.0
    for _ in range(5):
        pred, gt = rng.random((2, 16, 12)) < 0.4
        for fn in ("calculate_precision", "calculate_recall"):
            assert getattr(TI, fn)(pred, gt) == getattr(JI, fn)(pred, gt)
    empty = np.zeros((4, 4), bool)
    assert TI.calculate_precision(empty, pred[:4, :4]) == 0.0
    assert TI.calculate_recall(pred[:4, :4], empty) == 0.0
    np.testing.assert_array_equal(TI.palette(40), JI.palette(40))
    assert TI.palette(3).shape == (4, 3) and not TI.palette(3)[0].any()
