"""The port's small public helpers against the JAX package's:
io/colmap.py's text writers and write_model, io/cameras.py's make_camera,
make_camera_from_c2w and concat_cameras, utils/sh.py's num_sh_bands and
sh_to_rgb_dc, utils/general.py's cov_to_sym6.

Tolerances:
- COLMAP files: byte-equal, and each package reads the other's.
- Cameras: built in float64 numpy by both, then cast to float32, so equal
  exactly.
- num_sh_bands, cov_to_sym6: equal exactly (integers; a gather).
- sh_to_rgb_dc: within 2e-7, about two float32 ulps at these values (XLA
  may contract the multiply-add into one FMA where torch rounds twice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu.io import cameras as JC
from wheat3dgs_tpu.io import colmap as JCol
from wheat3dgs_tpu.utils import general as JGen
from wheat3dgs_tpu.utils import sh as JSH
from wheat3dgs_tpu_torch.io import cameras as TC
from wheat3dgs_tpu_torch.io import colmap as TCol
from wheat3dgs_tpu_torch.utils import general as TGen
from wheat3dgs_tpu_torch.utils import sh as TSH


def _model(pkg, seed=0, empty_track=True):
    """A small COLMAP model in `pkg`'s record types: two cameras, three
    images (the second with an empty track if empty_track) and 20 points
    with errors."""
    rng = np.random.default_rng(seed)
    intr = {1: pkg.ColmapCamera(1, "PINHOLE", 640, 480,
                                np.array([500.1, 499.7, 320.0, 240.5])),
            2: pkg.ColmapCamera(2, "SIMPLE_RADIAL", 320, 240,
                                rng.normal(size=4))}
    extr = {}
    for i in range(1, 4):
        q = rng.normal(size=4)
        m = 0 if i == 2 and empty_track else 3
        extr[i] = pkg.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2,
            f"plot_461_{i:02d}.png", rng.uniform(0, 600, (m, 2)),
            rng.integers(-1, 20, m))
    xyz = rng.normal(size=(20, 3))
    rgb = rng.integers(0, 256, (20, 3)).astype(np.uint8)
    err = rng.uniform(0, 2, 20)
    return intr, extr, (xyz, rgb, err)


def _write(pkg, kind, out):
    intr, extr, pts = _model(pkg)
    if kind == "cameras.txt":
        pkg.write_intrinsics_text(str(out / kind), intr)
    elif kind == "images.txt":
        pkg.write_extrinsics_text(str(out / kind), extr)
    elif kind == "points3D.txt":
        pkg.write_points3D_text(str(out / kind), *pts)
    elif kind == "points3D_noerr.txt":
        pkg.write_points3D_text(str(out / kind), *pts[:2])
    else:
        pkg.write_model(str(out), intr, extr, pts[:2] if kind == ".bin"
                        else pts, ext=kind)


FILES = {"cameras.txt": ["cameras.txt"], "images.txt": ["images.txt"],
         "points3D.txt": ["points3D.txt"],
         "points3D_noerr.txt": ["points3D_noerr.txt"],
         ".txt": ["cameras.txt", "images.txt", "points3D.txt"],
         ".bin": ["cameras.bin", "images.bin", "points3D.bin"]}


@pytest.mark.parametrize("kind", list(FILES))
def test_colmap_writers_byte_equal_jax(tmp_path, kind):
    for name, pkg in (("jax", JCol), ("port", TCol)):
        (tmp_path / name).mkdir()
        _write(pkg, kind, tmp_path / name)
    for f in FILES[kind]:
        want = (tmp_path / "jax" / f).read_bytes()
        assert len(want) > 0
        assert (tmp_path / "port" / f).read_bytes() == want


def _same_model(a, b):
    intr_a, extr_a, pts_a = a
    intr_b, extr_b, pts_b = b
    assert intr_a.keys() == intr_b.keys() and extr_a.keys() == extr_b.keys()
    for k in intr_a:
        assert tuple(intr_a[k])[:4] == tuple(intr_b[k])[:4]
        np.testing.assert_array_equal(intr_a[k].params, intr_b[k].params)
    for k in extr_a:
        ia, ib = extr_a[k], extr_b[k]
        assert (ia.id, ia.camera_id, ia.name) == (ib.id, ib.camera_id,
                                                  ib.name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(ia, f)),
                                          np.asarray(getattr(ib, f)))
    for x, y in zip(pts_a, pts_b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ext", [".txt", ".bin"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_colmap_models_read_across_packages(tmp_path, ext, writer):
    """Each package reads the model the other wrote, to the same values.
    (Both text readers drop blank lines, so neither reads back an image
    with an empty track from images.txt: the models here have none.)"""
    pkg = JCol if writer == "jax" else TCol
    intr, extr, pts = _model(pkg, empty_track=False)
    pkg.write_model(str(tmp_path), intr, extr, pts, ext=ext)
    got_j = JCol.load_colmap_model(str(tmp_path))
    got_t = TCol.load_colmap_model(str(tmp_path))
    _same_model(got_j, got_t)
    assert len(got_t[0]) == 2 and len(got_t[1]) == 3
    np.testing.assert_allclose(got_t[2][0], pts[0], rtol=0, atol=0)


def _pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    from wheat3dgs_tpu_torch.utils import graphics
    return graphics.qvec_to_rotmat(q), rng.normal(size=3)


FIELDS = ("w2c", "full_proj", "cam_center", "tanfovx", "tanfovy")


def _same_cameras(jc, tc):
    assert (jc.width, jc.height) == (tc.width, tc.height)
    for f in FIELDS:
        t = getattr(tc, f)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jc, f)))


@pytest.mark.parametrize("translate,scale", [
    (None, 1.0), (np.array([0.3, -0.2, 1.1]), 1.7)])
@pytest.mark.parametrize("seed", [4, 5])
def test_make_camera_matches_jax(seed, translate, scale):
    R_w2c, t = _pose(seed)
    args = (R_w2c.T, t, 1.0, 0.8, 640, 480)
    _same_cameras(JC.make_camera(*args, translate=translate, scale=scale),
                  TC.make_camera(*args, translate=translate, scale=scale,
                                 device="cpu"))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_make_camera_from_c2w_matches_jax(seed):
    R_w2c, t = _pose(seed)
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = R_w2c, t
    c2w = np.linalg.inv(w2c)
    jc = JC.make_camera_from_c2w(c2w, 0.9, 0.7, 64, 48)
    tc = TC.make_camera_from_c2w(c2w, 0.9, 0.7, 64, 48, device="cpu")
    _same_cameras(jc, tc)
    # The reference MiniCam's round trip: the pose's own camera, up to the
    # rounding of two matrix inversions.
    own = TC.make_camera(R_w2c.T, t, 0.9, 0.7, 64, 48, device="cpu")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   getattr(own, f).numpy(), atol=1e-5)


@pytest.mark.parametrize("sizes", [(1, 1), (1, 3, 2)])
def test_concat_cameras_matches_jax(sizes):
    jparts, tparts, seed = [], [], 10
    for b in sizes:
        poses = [_pose(seed + i) for i in range(b)]
        seed += b
        rs, ts = [r.T for r, _ in poses], [t for _, t in poses]
        fx = [0.8 + 0.1 * i for i in range(b)]
        jparts.append(JC.make_camera_batch(rs, ts, fx, fx, 32, 24))
        tparts.append(TC.make_camera_batch(rs, ts, fx, fx, 32, 24,
                                           device="cpu"))
    tc = TC.concat_cameras(tparts)
    assert tc.w2c.shape[0] == sum(sizes)
    _same_cameras(JC.concat_cameras(jparts), tc)


def test_concat_cameras_refuses_mixed_sizes():
    R, t = _pose(1)
    a = TC.make_camera(R.T, t, 1.0, 1.0, 32, 24, device="cpu")
    b = TC.make_camera(R.T, t, 1.0, 1.0, 64, 48, device="cpu")
    with pytest.raises(ValueError):
        TC.concat_cameras([a, b])


@pytest.mark.parametrize("deg", range(5))
def test_num_sh_bands_matches_jax(deg):
    assert TSH.num_sh_bands(deg) == JSH.num_sh_bands(deg) == (deg + 1) ** 2


@pytest.mark.parametrize("shape", [(3,), (50, 3), (4, 16, 3)])
def test_sh_to_rgb_dc_matches_jax(shape):
    sh = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    want = np.asarray(JSH.sh_to_rgb_dc(jnp.asarray(sh)))
    got = TSH.sh_to_rgb_dc(torch.from_numpy(sh))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7)
    rgb = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(TSH.sh_to_rgb_dc(TSH.rgb_to_sh(rgb)).numpy(),
                               rgb.numpy(), atol=1e-6)


@pytest.mark.parametrize("batch", [(), (7,), (2, 5)])
def test_cov_to_sym6_matches_jax(batch):
    rng = np.random.default_rng(len(batch))
    a = rng.normal(size=batch + (3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    want = np.asarray(JGen.cov_to_sym6(jnp.asarray(cov)))
    got = TGen.cov_to_sym6(torch.from_numpy(cov))
    assert tuple(got.shape) == batch + (6,)
    np.testing.assert_array_equal(got.numpy(), want)
