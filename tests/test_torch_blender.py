"""The port's Blender (NeRF-synthetic) reader, `io/dataset.py::
read_blender_scene`, and its `Scene` branch against the JAX package's.

On a tiny transforms_{train,test}.json scene of RGBA images: the cameras
(w2c, full_proj, cam_center, tan-fovs, size), the alpha-composited images
on either background, the metas, the split with and without eval, and the
random initial points (np.random.default_rng(0), written once to
points3d.ply) equal JAX's; `Scene` picks the reader for such a source, and
two training steps run from it on the CPU through the training CLI.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from wheat3dgs_tpu.io import dataset as JD
from wheat3dgs_tpu_torch.io import dataset as TD


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blender_scene(src):
    src.mkdir()
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("test", 2)):
        (src / split).mkdir()
        frames = []
        for i in range(n):
            ang = 2 * np.pi * (i + 0.5 * (split == "test")) / n
            eye = np.array([2 * np.cos(ang), 2 * np.sin(ang), 1.0])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0, 0, 1.0])
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
            c2w[:3, 2], c2w[:3, 3] = -fwd, eye
            img = (rng.random((24, 32, 4)) * 255).astype(np.uint8)
            Image.fromarray(img, "RGBA").save(src / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(src / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return str(src)


def _same_group(j, t):
    assert len(j) == len(t)
    for f in ("w2c", "full_proj", "cam_center", "tanfovx", "tanfovy"):
        np.testing.assert_allclose(getattr(t.cameras, f).numpy(),
                                   np.asarray(getattr(j.cameras, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    assert (t.cameras.width, t.cameras.height) == (j.cameras.width,
                                                   j.cameras.height)
    np.testing.assert_array_equal(t.images, j.images)
    for a, b in zip(j.metas, t.metas):
        assert (a.image_name, a.image_path, a.fovx, a.fovy,
                a.resolution_scale) == (b.image_name, b.image_path, b.fovx,
                                        b.fovy, b.resolution_scale)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)


@pytest.mark.parametrize("white,eval_split", [(False, True), (True, False)])
def test_read_blender_scene_matches_jax(tmp_path, white, eval_split):
    src = _blender_scene(tmp_path / "blender")
    t = TD.read_blender_scene(src, white_background=white,
                              eval_split=eval_split, num_random_points=500,
                              device="cpu")
    assert os.path.exists(os.path.join(src, "points3d.ply"))
    j = JD.read_blender_scene(src, white_background=white,
                              eval_split=eval_split, num_random_points=500)
    _same_group(j.train, t.train)
    _same_group(j.test, t.test)
    assert len(t.train) == (4 if eval_split else 6)
    assert t.cameras_extent == j.cameras_extent > 0
    np.testing.assert_array_equal(t.translate, j.translate)
    # The port wrote the random cloud; JAX read it back. Each alone writes
    # the same one (both from np.random.default_rng(0)).
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t.point_cloud, f),
                                      getattr(j.point_cloud, f))
    os.remove(os.path.join(src, "points3d.ply"))
    j2 = JD.read_blender_scene(src, num_random_points=500)
    np.testing.assert_array_equal(j2.point_cloud.points,
                                  t.point_cloud.points)


def test_blender_scene_trains_on_cpu(tmp_path):
    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.apps import train_vanilla
    from wheat3dgs_tpu_torch.scene import Scene

    src = _blender_scene(tmp_path / "blender")
    TD.read_blender_scene(src, num_random_points=2000, device="cpu")
    scene = Scene(cfg.ModelParams(source_path=src, model_path=""),
                  sh_degree=1, device="cpu")
    assert len(scene.data.train) == 4 and len(scene.data.test) == 2
    assert scene.image_size == (32, 24)
    model = str(tmp_path / "model")
    trainer, scene = train_vanilla.main(
        ["-s", src, "-m", model, "--device", "cpu", "--iterations", "2",
         "--sh_degree", "1", "--test_iterations", "2", "--save_iterations",
         "2", "--quiet"])
    assert trainer.state.adam.step == 2
    assert int(trainer.state.num_alive) == 2000
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
    recs = [json.loads(ln) for ln in open(os.path.join(model,
                                                       "metrics.jsonl"))]
    assert np.isfinite(recs[0]["loss"])
