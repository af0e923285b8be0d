"""The port's mask lifting and find-&-match association against the JAX
package (wheat3dgs_tpu_torch.ops.mask_lift, .seg.flashsplat, .seg.pipeline).

The same seeded numpy Gaussians and cameras go to both packages. The JAX
side runs its XLA rasterizer at the port's 32-px tiles with caps that crop
nothing at these sizes (RasterConfig(tile=32, max_tiles_per_gauss=64,
max_per_tile=1024)); the port runs its entry-stream rasterizer with the
kernels' plain versions.

Tolerances:
- multi_instance_opt, counts_to_used_mask, apply_pts_filter, reset_label,
  _pack_bits / _unpack_bits, _bbox_device and the image_ops helpers:
  exactly equal (the same float32 arithmetic, or integer logic).
- The port's per-mask lift (lift_counts) against its batched per-camera
  lift (SegContext.cached_counts): atol 1e-4 + rtol 1e-4.
- Lifted counts (lift_batch8, lift_mask): atol 1e-4 + rtol 1e-4, both
  float32. JAX sums weights per tile with a matmul in its forward pass;
  the port takes the gradient of a render in the label colours, which sums
  them per entry in the backward replay and per splat in the segment sum.
- Association: used_mask exactly equal to JAX's; inter, area and bbox
  exactly equal to the port's own alpha_views thresholded in numpy (the
  device path must not change the answer); the alphas within 1e-5 of
  JAX's (float32 compositing in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu import testing
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.ops import mask_lift as JM
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu.seg import flashsplat as JF
from wheat3dgs_tpu.seg import pipeline as JS
from wheat3dgs_tpu.utils import image_ops as JI
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops import mask_lift as TM
from wheat3dgs_tpu_torch.render.pipeline import RasterConfig as TConfig
from wheat3dgs_tpu_torch.seg import flashsplat as TF
from wheat3dgs_tpu_torch.seg import pipeline as TS
from wheat3dgs_tpu_torch.utils import image_ops as TI

W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run many small torch ops on the CPU; with the suite's
    parallel workers, torch's default of one thread per core oversubscribes
    the host, so they use two threads while they run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


JAX_CONFIG = JConfig(tile=32, max_tiles_per_gauss=64, max_per_tile=1024)
PORT_CONFIG = TConfig()


def _states(n=60, seed=7, capacity=64):
    g = testing.random_gaussians(n=n, seed=seed, spread=0.7)
    o = np.clip(g["opacities"], 1e-4, 1 - 1e-4)
    params = {"means": g["means3d"], "quats": g["quats"],
              "log_scales": np.log(g["scales"]), "sh_dc": g["colors"],
              "sh_rest": np.zeros((n, 0), np.float32),
              "opacity_logit": np.log(o / (1 - o)).astype(np.float32)}
    jstate = JG.init_state(JG.GaussianParams(
        **{k: jnp.asarray(v) for k, v in params.items()}), capacity=capacity)
    tstate = TG.init_state(TG.GaussianParams(
        **{k: torch.as_tensor(np.asarray(v, np.float32))
           for k, v in params.items()}), capacity=capacity)
    return jstate, tstate


def _cams(eyes=((0.0, 0.0, -4.0),)):
    """Stacked (w2c, full_proj, cam_center, tanfovx, tanfovy) of look-at
    cameras, as numpy."""
    cs = [testing.look_at_camera(width=W, height=H, eye=e) for e in eyes]
    return (np.stack([c.w2c for c in cs]), np.stack([c.full_proj for c in cs]),
            np.stack([c.cam_center for c in cs]),
            np.array([c.tanfovx for c in cs], np.float32),
            np.array([c.tanfovy for c in cs], np.float32))


def _jcams(cams, i=None):
    return tuple(jnp.asarray(c if i is None else c[i]) for c in cams)


def _tcams(cams, i=None):
    return tuple(torch.as_tensor(c if i is None else c[i]) for c in cams)


@pytest.mark.parametrize("gamma", [0.0, 0.1])
def test_multi_instance_opt_matches_jax(gamma):
    rng = np.random.default_rng(1)
    counts = rng.uniform(0, 5, size=(5, 300)).astype(np.float32)
    counts[:, :20] = 0.0
    counts[2, 20:40] = 0.0
    want = np.asarray(JM.multi_instance_opt(jnp.asarray(counts), gamma))
    got = TM.multi_instance_opt(torch.from_numpy(counts), gamma).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_pts_filter_and_used_mask_match_jax():
    rng = np.random.default_rng(6)
    counts = rng.uniform(0, 3, size=(3, 200)).astype(np.float32)
    filt = rng.random(200) < 0.3
    want = np.asarray(JF.apply_pts_filter(jnp.asarray(counts), filt))
    got = TF.apply_pts_filter(torch.from_numpy(counts), filt).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1:, filt] == 0).all() and (got[0] == counts[0]).all()
    two = counts[:2]
    np.testing.assert_array_equal(TS.counts_to_used_mask(two, 0.1),
                                  JS.counts_to_used_mask(two, 0.1))


def test_image_ops_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(9)
    a, b = rng.random((2, H, W)) < 0.3
    boxes = [(3, 4, 20, 30), (10, 2, 40, 25), (50, 40, 60, 47)]
    assert TI.calculate_seg_iou(a, b) == JI.calculate_seg_iou(a, b)
    for x in boxes:
        for y in boxes:
            assert TI.is_overlapping(x, y) == JI.is_overlapping(x, y)
    assert TI.get_bbox_from_mask(a) == JI.get_bbox_from_mask(a)
    for i in range(41):
        np.testing.assert_array_equal(TI.id2rgb(i), JI.id2rgb(i))
    ids = rng.integers(0, 6, size=(H, W))
    np.testing.assert_array_equal(TI.visualize_obj(ids), JI.visualize_obj(ids))
    img = rng.random((3, H, W)).astype(np.float32)
    np.testing.assert_array_equal(
        TI.overlay_image(img, TI.visualize_obj(ids) / 255.0),
        JI.overlay_image(img, JI.visualize_obj(ids) / 255.0))
    path = str(tmp_path / "m.png")
    Image.fromarray((a * 255).astype(np.uint8), mode="L").save(path)
    np.testing.assert_array_equal(TI.read_mask(path, (W, H)), a)
    np.testing.assert_array_equal(TI.read_mask(path, (W, H)),
                                  JI.read_mask(path, (W, H)))
    for lib, name in ((TI, "t.jpg"), (JI, "j.jpg")):
        lib.save_overlay(img, a, str(tmp_path / name), resize_factor=4)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.jpg")),
                                  np.asarray(Image.open(tmp_path / "j.jpg")))


def test_reset_label_matches_jax():
    rng = np.random.default_rng(2)
    for case in range(40):
        inst = rng.integers(0, 4, size=60).astype(np.int32)
        if case % 3 == 0:
            inst[:] = 0
        used = rng.random(60) < rng.uniform(0.05, 0.6)
        if case % 4 == 1:      # a new head over most of an old one
            used = (inst == 2) | (rng.random(60) < 0.02)
        j_inst, j_which = JS.reset_label(inst, used, 7)
        t_inst, t_which = TS.reset_label(inst, used, 7)
        np.testing.assert_array_equal(t_inst, j_inst)
        assert t_which == j_which


@pytest.mark.parametrize("shape", [(48, 64), (11, 37)])
def test_pack_unpack_bits_match_jax(shape):
    rng = np.random.default_rng(3)
    pred = rng.random(shape) < 0.4
    n = pred.size
    want = np.asarray(JF._pack_bits(jnp.asarray(pred)))
    got = TF._pack_bits(torch.from_numpy(pred)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.packbits(pred, axis=None))
    bits = np.stack([want, np.packbits(~pred, axis=None)])
    np.testing.assert_array_equal(
        TF._unpack_bits(torch.from_numpy(bits), n).numpy(),
        np.asarray(JF._unpack_bits(jnp.asarray(bits), n)))


@pytest.mark.parametrize("fill", ["blob", "corner", "empty"])
def test_bbox_device_matches_jax(fill):
    pred = np.zeros((H, W), bool)
    if fill == "blob":
        pred[10:31, 5:22] = True
        pred[40, 50] = True
    elif fill == "corner":
        pred[H - 1, W - 1] = True
        pred[0, 3] = True
    want = np.asarray(JF._bbox_device(jnp.asarray(pred), W, H))
    got = TF._bbox_device(torch.from_numpy(pred), W, H).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    if fill != "empty":
        assert tuple(got) == JI.get_bbox_from_mask(pred)


def test_lift_batch8_matches_jax():
    jstate, tstate = _states()
    cams = _cams()
    rng = np.random.default_rng(3)
    masks = rng.random((8, H, W)) < 0.3
    masks[7] = True
    bits8 = np.stack([np.packbits(m, axis=None) for m in masks])
    want = np.asarray(JF.lift_batch8(jstate, *_jcams(cams, 0),
                                     jnp.asarray(bits8), width=W, height=H,
                                     config=JAX_CONFIG))
    got = TF.lift_batch8(tstate, *_tcams(cams, 0), torch.from_numpy(bits8),
                         width=W, height=H, config=PORT_CONFIG).numpy()
    assert got.shape == (8, tstate.capacity)
    assert want[7].max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("labels", [4, 11])
def test_lift_mask_matches_jax_lift_view(labels):
    """L+1 labels: one pass of 8 label channels at 4, two at 11."""
    jstate, tstate = _states(n=60, seed=11)
    cams = _cams()
    rng = np.random.default_rng(labels)
    gt = rng.integers(0, labels, size=(H, W)).astype(np.int32)
    gt[:, :10] = labels - 1                     # one large region
    ref = JF.lift_view(jstate, *_jcams(cams, 0), jnp.asarray(gt),
                       num_obj=labels - 1, width=W, height=H,
                       config=JAX_CONFIG)
    out = TF.lift_view(tstate, *_tcams(cams, 0), torch.from_numpy(gt),
                       num_obj=labels - 1, width=W, height=H,
                       config=PORT_CONFIG)
    want = np.asarray(ref.used_count)
    got = out.used_count.numpy()
    assert got.shape == (labels, tstate.capacity)
    assert (want.sum(1) > 0).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha),
                               atol=1e-5)
    np.testing.assert_allclose(out.proj_xy.numpy(), np.asarray(ref.proj_xy),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.gs_depth.numpy(),
                               np.asarray(ref.gs_depth), rtol=1e-6)


def test_match_views_packed_and_predbits_match_jax():
    jstate, tstate = _states()
    cams = _cams(((0.0, 0.0, -4.0), (0.6, -0.3, -3.8), (-0.5, 0.4, -4.1)))
    rng = np.random.default_rng(5)
    counts = rng.uniform(0, 2, (2, tstate.capacity)).astype(np.float32)
    m_masks = rng.random((3, 3, H, W)) < 0.25          # (B, M) SAM masks
    m_masks[1, 0] = False                              # an empty mask
    bits = np.stack([[np.packbits(mm, axis=None) for mm in view]
                     for view in m_masks])

    j_used = np.asarray(JF.match_views_packed(
        jstate, *_jcams(cams), jnp.asarray(counts), jnp.asarray(bits),
        width=W, height=H, config=JAX_CONFIG)[0])
    used, inter, area, bbox, entries = TF.match_views_packed(
        tstate, *_tcams(cams), counts, torch.from_numpy(bits), width=W,
        height=H, config=PORT_CONFIG)
    used = used.numpy()
    np.testing.assert_array_equal(used, j_used)
    assert 0 < used.sum() < tstate.capacity
    assert 0 < int(entries) <= 16 * tstate.capacity

    alphas = TF.alpha_views(tstate, *_tcams(cams), torch.from_numpy(used),
                            width=W, height=H, config=PORT_CONFIG).numpy()
    j_alphas = np.asarray(JF.alpha_views(
        jstate, *_jcams(cams), jnp.asarray(used), width=W, height=H,
        config=JAX_CONFIG))
    np.testing.assert_allclose(alphas, j_alphas, atol=1e-5)
    pbits, _ = TF.predbits_views(tstate, *_tcams(cams),
                                 torch.from_numpy(used), width=W, height=H,
                                 config=PORT_CONFIG)
    for v in range(3):
        pred = alphas[v] > 0.5
        assert int(area[v]) == int(pred.sum()) > 0
        assert tuple(bbox[v].tolist()) == JI.get_bbox_from_mask(pred)
        for k in range(3):
            assert int(inter[v, k]) == int(np.logical_and(
                pred, m_masks[v, k]).sum())
        np.testing.assert_array_equal(pbits[v].numpy(),
                                      np.packbits(pred, axis=None))


def test_find_match_device_equals_host_find_match(tmp_path):
    """The device association step picks the same masks as the host-side
    find_match on the shipped alphas (one seg context, two paths)."""
    from PIL import Image

    _, tstate = _states()
    cams = _cams(((0.0, 0.0, -4.0), (0.6, -0.3, -3.8), (-0.5, 0.4, -4.1)))
    used = np.zeros(tstate.capacity, bool)
    used[:30] = True
    alphas = TF.alpha_views(tstate, *_tcams(cams), torch.from_numpy(used),
                            width=W, height=H, config=PORT_CONFIG).numpy()
    rng = np.random.default_rng(8)
    mask_paths, bboxes = [], []
    for v in range(3):
        pred = alphas[v] > 0.5
        noisy = [pred ^ (rng.random(pred.shape) < p) & pred
                 for p in (0.05, 0.6)] + [rng.random(pred.shape) < 0.2]
        paths, boxes = [], []
        for k, m in enumerate(noisy):
            path = str(tmp_path / f"v{v}_{k:03d}.png")
            Image.fromarray((m * 255).astype(np.uint8), mode="L").save(path)
            paths.append(path)
            boxes.append(JI.get_bbox_from_mask(m))
        mask_paths.append(paths)
        bboxes.append(np.asarray(boxes, np.float32))
    ctx = TS.SegContext(state=tstate, cams=_tcams(cams),
                        image_names=["a", "b", "c"], mask_paths=mask_paths,
                        bboxes=bboxes, width=W, height=H, config=PORT_CONFIG)
    counts = np.stack([(~used).astype(np.float32), used.astype(np.float32)])
    # The per-mask lift and the batched per-camera lift agree.
    for v in range(3):
        single = TS.lift_counts(ctx, v, mask_paths[v][0])
        np.testing.assert_allclose(ctx.cached_counts(v, mask_paths[v][0]),
                                   single, atol=1e-4, rtol=1e-4)
        assert single[1].max() > 0
    d_used, d_idx, d_paths = TS.find_match_device(ctx, [0, 1, 2], counts,
                                                  0.6)
    h_idx, h_paths, _ = TS.find_match(ctx, [0, 1, 2], d_used, 0.6)
    np.testing.assert_array_equal(d_used, used)
    assert d_idx == h_idx == [0, 1, 2]
    assert d_paths == h_paths
    assert all(p.endswith("_000.png") for p in d_paths)


def test_regen_masks_rewrites_the_same_masks(tmp_path):
    from PIL import Image

    from wheat3dgs_tpu_torch.io import synthetic as TY

    kw = dict(width=64, height=48, n_heads=3, pts_per_head=80,
              ground_pts=400, seed=3)
    root = tmp_path / "scene"
    TY.make_synthetic_colmap_scene(str(root), device="cpu", **kw)
    names = sorted(os.listdir(root / "masks"))
    before = {f: np.asarray(Image.open(root / "masks" / f)) for f in names}
    boxes = {f: TY.load_bboxes(str(root / "bboxes" / f))
             for f in sorted(os.listdir(root / "bboxes"))}
    (root / "masks" / names[0]).unlink()
    TY.regen_masks(str(root), device="cpu", **kw)
    assert sorted(os.listdir(root / "masks")) == names and len(names) >= 12
    for f in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(root / "masks" / f)), before[f])
    for f, b in boxes.items():
        np.testing.assert_array_equal(TY.load_bboxes(str(root / "bboxes" / f)),
                                      b)
