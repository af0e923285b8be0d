"""The port's Scene without images (load_images=False) against the JAX
package's, on a scene written by the port's generator: the camera stacks
equal (the same float32 arithmetic on the same COLMAP numbers), the metas
equal, each split's images the JAX reader's zero placeholder, and no image
file read."""

import numpy as np
import pytest

from wheat3dgs_tpu import config as jcfg
from wheat3dgs_tpu.scene import Scene as JScene
from wheat3dgs_tpu_torch import config as tcfg
from wheat3dgs_tpu_torch.io import dataset as TD
from wheat3dgs_tpu_torch.scene import Scene as TScene


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("torch_scene") / "scene")
    make_synthetic_colmap_scene(out, width=48, height=32, n_heads=1,
                                pts_per_head=30, ground_pts=100,
                                with_masks=False, device="cpu")
    return out


def test_scene_without_images_matches_jax(scene_dir, tmp_path, monkeypatch):
    def no_read(*a, **k):
        raise AssertionError("an image was read")

    monkeypatch.setattr(TD, "load_image", no_read)
    jsc = JScene(jcfg.ModelParams(source_path=scene_dir,
                                  model_path=str(tmp_path / "j")),
                 load_images=False)
    tsc = TScene(tcfg.ModelParams(source_path=scene_dir,
                                  model_path=str(tmp_path / "t")),
                 load_images=False, device="cpu")
    assert tsc.image_size == jsc.image_size
    assert tsc.cameras_extent == pytest.approx(jsc.cameras_extent, rel=1e-12)
    for split in ("train", "test"):
        jg, tg = getattr(jsc.data, split), getattr(tsc.data, split)
        assert len(tg) == len(jg) > 0
        assert tg.images.shape == jg.images.shape
        assert not tg.images.any() and not np.asarray(jg.images).any()
        for jm, tm in zip(jg.metas, tg.metas):
            assert tm.image_name == jm.image_name
            assert tm.image_path == jm.image_path
            np.testing.assert_array_equal(tm.R, jm.R)
            np.testing.assert_array_equal(tm.T, jm.T)
            assert (tm.fovx, tm.fovy) == (jm.fovx, jm.fovy)
        c = jg.cameras
        for a, b in zip(tsc.cam_stack(split), (c.w2c, c.full_proj,
                                               c.cam_center, c.tanfovx,
                                               c.tanfovy)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
