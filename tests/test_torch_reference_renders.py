"""utils/image_stats.py and scripts/reference_renders.py on the CPU.

- The texture statistics against direct numpy on known images: a ramp's
  horizontal step, a checkerboard's 8x8 block std, PSNR of a constant
  offset; as_png quantizes as the generator writes a PNG.
- reference_renders.py on a made-up model tree whose renders are JAX's
  saved renders and whose ground truths are them offset by 2 levels: the
  PSNRs each pair gives, for every save, and JAX's texture read back.
"""

import importlib.util
import os

import numpy as np
import pytest
from PIL import Image

from wheat3dgs_tpu_torch.utils import image_stats as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts",
                      "reference_renders.py")


def test_texture_statistics():
    ramp = np.tile(np.linspace(0, 1, 17)[None, :, None], (16, 1, 3))
    assert S.h_step(ramp) == pytest.approx(1 / 16)
    assert S.block_std(np.full((16, 16, 3), 0.3)) == pytest.approx(
        0, abs=1e-12)
    yy, xx = np.mgrid[:16, :18]
    board = np.repeat(((yy + xx) % 2)[..., None], 3, 2).astype(np.float64)
    # Every whole 8x8 tile holds 32 zeros and 32 ones; the 2 columns past
    # the last whole tile are dropped.
    assert S.block_std(board) == pytest.approx(0.5)
    assert S.texture(board) == {"h_step": 1.0, "block_std": 0.5}
    a = np.full((4, 4, 3), 0.5)
    assert S.psnr(a, a + 0.1) == pytest.approx(20.0)
    assert S.psnr(a, a) == float("inf")
    x = np.array([[[-0.2, 0.5, 1.3]]])
    np.testing.assert_array_equal(S.as_png(x) * 255, [[[0, 127, 255]]])


def test_reference_renders_scores_each_save(tmp_path):
    ref = tmp_path / "ref"
    ref.mkdir()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(2, 250, (24, 32, 3)).astype(np.uint8)
            for _ in range(3)]
    for it in (7000, 30000):
        for sub in ("renders", "gt"):
            (tmp_path / "m" / "test" / f"ours_{it}" / sub).mkdir(
                parents=True)
    for k, img in enumerate(imgs):
        name = f"{k:05d}.png"
        Image.fromarray(img).save(ref / name)
        for it in (7000, 30000):
            base = tmp_path / "m" / "test" / f"ours_{it}"
            Image.fromarray(img).save(base / "renders" / name)
            Image.fromarray(img + 2).save(base / "gt" / name)
    spec = importlib.util.spec_from_file_location("reference_renders",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main([str(tmp_path / "m"), "--ref", str(ref)])
    assert list(out) == ["7000", "30000"]
    want = -10 * np.log10((2 / 255) ** 2)
    for rows in out.values():
        assert [r["view"] for r in rows] == ["00000.png", "00001.png",
                                             "00002.png"]
        for r, img in zip(rows, imgs):
            assert r["psnr_render_vs_jax"] == float("inf")
            assert r["psnr_gt_vs_jax"] == pytest.approx(want)
            assert r["psnr_render_vs_gt"] == pytest.approx(want)
            assert r["texture"]["jax"] == S.texture(S.unit(img))
