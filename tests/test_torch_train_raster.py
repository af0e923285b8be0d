"""Parity of the port's differentiable rasterizer (wheat3dgs_tpu_torch.ops.
cuda_raster.rasterize: the training compositor, backward replay and segment
sum, here through their plain versions on the CPU) and of projection's
autograd with the JAX package.

The same seeded numpy scene goes through both packages' projection and
rasterizer, and the loss colour MSE + 0.1 depth + 0.05 alpha (so every
output row carries a cotangent) is differentiated in both.

Every comparison uses 32-pixel tiles, the port's (and JAX `render`'s for
the Pallas backend): a splat renders only in the tiles its radius rect
touches (renderCUDA's getRect), so the image itself depends on the tile
size.

- Against JAX's `rasterize_pallas` (interpret mode, pack_payload=False):
  forward images within atol 1e-4 (float32 sum order: the TPU kernel's
  chunked matmul prefix sums against the port's per-chunk cumsum) and
  gradients within 4% of each leaf's max |g|. The 2% bound of
  tests/test_pallas.py does not hold here for JAX's own backward: its bf16
  gradient matmuls and bf16-packed reduction put its scales gradient
  1.6-3.1% of the max away from its XLA autodiff on these scenes (SH 0/1,
  seeds 5/6). The same test holds the port to XLA autodiff within 1e-3.
  Interpret mode costs tens of seconds, so there is one such case.
- Against JAX's XLA autodiff (`ops/raster.py::rasterize`, caps large
  enough that nothing is cropped): gradients within 1e-3 of each leaf's
  max |g| (both float32; only the summation order differs), over a
  background, odd image sizes and culled splats.
- Dead capacity slots (zero-filled, one at the camera centre) give finite
  gradients in every leaf (tests/test_raster.py:185), and the gradient of
  `ndc_offset` is JAX's viewspace gradient, with its 0.5 * W pixel scale
  (tests/test_raster.py:167).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu import testing
from wheat3dgs_tpu.ops import projection as JP
from wheat3dgs_tpu.ops import raster as JR
from wheat3dgs_tpu.ops.pallas_raster import rasterize_pallas
from wheat3dgs_tpu_torch.ops import cuda_raster as CR
from wheat3dgs_tpu_torch.ops import projection as TP

LEAVES = ("means3d", "scales", "quats", "opacities", "sh", "dcolor")


def _inputs(n, seed, width, height, sh_degree=1, cull=False):
    cam = testing.look_at_camera(width=width, height=height)
    g = testing.random_gaussians(n=n, seed=seed, spread=0.7,
                                 sh_degree=sh_degree)
    g["sh"] = g["sh"].reshape(n, -1)            # flat coefficient-major
    g["dcolor"] = np.zeros((n, 3), np.float32)  # d loss / d colour hook
    if cull:
        g["means3d"][:4] -= np.array([0, 0, 100.0], np.float32)  # behind
        g["means3d"][4:7] += np.array([50.0, 0, 0], np.float32)  # off frame
        g["opacities"][7:9] = 1e-3                               # < 1/255
    rng = np.random.default_rng(seed + 100)
    gt = rng.random((3, height, width)).astype(np.float32)
    return cam, g, gt


def _loss(out, gt):
    return (((out.color - gt) ** 2).mean() + 0.1 * out.depth.mean()
            + 0.05 * out.alpha.mean())


def _jax_grads(raster_fn, cam, g, gt, sh_degree=1):
    def loss(means, scales, quats, opac, sh, dcol):
        s = JP.project_gaussians(
            means, scales, quats, opac, cam.w2c, cam.full_proj,
            cam.cam_center, cam.tanfovx, cam.tanfovy, cam.width, cam.height,
            sh=sh, sh_degree=sh_degree)
        s = s._replace(color=s.color + dcol)
        out = raster_fn(s)
        return _loss(out, gt), out

    args = [jnp.asarray(g[k]) for k in LEAVES]
    (val, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return float(val), out, [np.asarray(x) for x in grads]


def _torch_grads(cam, g, gt, bg=None, sh_degree=1, budget=0):
    leaves = [torch.tensor(g[k], requires_grad=True) for k in LEAVES]
    s = TP.project_gaussians(
        *leaves[:4], torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
        torch.tensor(cam.cam_center), cam.tanfovx, cam.tanfovy, cam.width,
        cam.height, sh=leaves[4], sh_degree=sh_degree)
    s = s._replace(color=s.color + leaves[5])
    out = CR.rasterize(s, cam.width, cam.height,
                       None if bg is None else torch.tensor(bg),
                       entry_budget=budget)
    val = _loss(out, torch.tensor(gt))
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), out, [x.numpy() for x in grads]


def _assert_grads_close(ref, got, rel):
    for name, a, b in zip(LEAVES, ref, got):
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max()
        assert scale > 0, name
        err = np.abs(a - b).max() / scale
        assert err < rel, f"{name}: {err:.2e} of max"


def _xla(width, height, bg=None):
    return lambda s: JR.rasterize(
        s, width, height, None if bg is None else jnp.asarray(bg),
        tile=CR.TILE_PX, max_tiles_per_gauss=64, max_per_tile=512)


def test_forward_and_gradients_match_jax_pallas():
    cam, g, gt = _inputs(40, 5, 48, 32)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    val_j, out_j, grads_j = _jax_grads(
        lambda s: rasterize_pallas(s, cam.width, cam.height, jnp.asarray(bg),
                                   tile=CR.TILE_PX, interpret=True,
                                   pack_payload=False),
        cam, g, gt)
    _, _, grads_x = _jax_grads(_xla(cam.width, cam.height, bg), cam, g, gt)
    val_t, out_t, grads_t = _torch_grads(cam, g, gt, bg)
    for f in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(out_t, f).detach().numpy(),
                                   np.asarray(getattr(out_j, f)), atol=1e-4,
                                   err_msg=f)
    assert int(out_t.entries_total) == int(out_j.entries_total)
    assert int(out_t.entries_alive) == int(out_j.entries_alive)
    assert val_t == pytest.approx(val_j, rel=1e-5)
    _assert_grads_close(grads_j, grads_t, 0.04)
    _assert_grads_close(grads_x, grads_t, 1e-3)


@pytest.mark.parametrize("width,height,bg,cull", [
    (48, 32, None, False),                   # no background
    (48, 32, (0.3, 0.6, 0.9), False),        # background
    (50, 37, (0.1, 0.2, 0.3), False),        # odd size: partial edge tiles
    (64, 48, (0.5, 0.5, 0.5), True),         # culled / off-frame / faint
])
def test_gradients_match_jax_xla_autodiff(width, height, bg, cull):
    cam, g, gt = _inputs(60, 9, width, height, cull=cull)
    bg_np = None if bg is None else np.asarray(bg, np.float32)
    val_j, _, grads_j = _jax_grads(_xla(width, height, bg_np), cam, g, gt)
    val_t, out_t, grads_t = _torch_grads(cam, g, gt, bg_np)
    assert int(out_t.entries_total) <= max(1024, 16 * 60)  # nothing cropped
    assert val_t == pytest.approx(val_j, rel=1e-5)
    if cull:
        r = out_t.radii.numpy()
        assert (r[:9] == 0).all() and (r[9:] > 0).any()
        for gr in grads_t[:5]:     # culled splats get exact zeros
            assert (gr[:9] == 0).all()
    _assert_grads_close(grads_j, grads_t, 1e-3)


def test_budget_crop_gradients_finite():
    """An entry budget below the demand crops the deepest splats' entries:
    entries_total still reports the demand, and the gradients stay finite
    and change (the cropped slots' rows never reach the segment sum)."""
    cam, g, gt = _inputs(120, 9, 64, 48)
    _, out_full, grads_full = _torch_grads(cam, g, gt)
    _, out_crop, grads_crop = _torch_grads(cam, g, gt, budget=128)
    assert int(out_crop.entries_total) == int(out_full.entries_total) > 128
    assert int(out_crop.entries_alive) <= 128
    for gf, gc in zip(grads_full, grads_crop):
        assert np.isfinite(gc).all()
    assert not np.allclose(grads_full[0], grads_crop[0])


def test_dead_lane_gradients_finite():
    """Zero-filled dead capacity slots (the post-densify/prune state), one
    of them at the camera centre, inject no NaN/inf into any leaf, as in
    tests/test_raster.py::test_dead_lane_gradients_finite."""
    cam = testing.look_at_camera(width=64, height=48)
    g = testing.random_gaussians(n=16, seed=7, sh_degree=1)
    g["sh"] = g["sh"].reshape(16, -1)
    dead = np.arange(16) >= 6
    for k in ("means3d", "scales", "quats", "opacities", "sh"):
        g[k][dead] = 0.0
    g["means3d"][6] = cam.cam_center
    leaves = [torch.tensor(g[k], requires_grad=True)
              for k in ("means3d", "scales", "quats", "opacities", "sh")]
    s = TP.project_gaussians(
        *leaves[:4], torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
        torch.tensor(cam.cam_center), cam.tanfovx, cam.tanfovy, 64, 48,
        sh=leaves[4], sh_degree=1)
    out = CR.rasterize(s, 64, 48)
    loss = (out.color ** 2).mean() + out.depth.mean() + out.alpha.mean()
    grads = torch.autograd.grad(loss, leaves)
    for name, gr in zip(("means", "scales", "quats", "opac", "sh"), grads):
        assert torch.isfinite(gr).all(), f"NaN/inf grad in {name}"
        assert (gr[dead] == 0).all(), name
    assert float(grads[0][:6].abs().max()) > 0


def test_ndc_offset_gradient_matches_jax():
    """The ndc_offset gradient is the CUDA viewspace-point gradient (the
    0.5 * W NDC-to-pixel scale included), as JAX's."""
    cam, g, gt = _inputs(20, 3, 64, 48)
    n = 20

    def jloss(off):
        s = JP.project_gaussians(
            g["means3d"], g["scales"], g["quats"], g["opacities"], cam.w2c,
            cam.full_proj, cam.cam_center, cam.tanfovx, cam.tanfovy, 64, 48,
            colors=g["colors"], ndc_offset=off)
        return (_xla(64, 48)(s).color ** 2).mean()

    ref = np.asarray(jax.grad(jloss)(jnp.zeros((n, 2), jnp.float32)))
    off = torch.zeros((n, 2), requires_grad=True)
    t = {k: torch.tensor(g[k]) for k in g}
    s = TP.project_gaussians(
        t["means3d"], t["scales"], t["quats"], t["opacities"],
        torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
        torch.tensor(cam.cam_center), cam.tanfovx, cam.tanfovy, 64, 48,
        colors=t["colors"], ndc_offset=off)
    out = CR.rasterize(s, 64, 48)
    got = torch.autograd.grad((out.color ** 2).mean(), off)[0].numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())

    # The pixel scale: d/d ndc_x = (W / 2) d/d x.
    xy = s.xy.detach().requires_grad_(True)
    out2 = CR.rasterize(s._replace(xy=xy), 64, 48)
    gxy = torch.autograd.grad((out2.color ** 2).mean(), xy)[0].numpy()
    np.testing.assert_allclose(got[:, 0], gxy[:, 0] * 32, rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(got[:, 1], gxy[:, 1] * 24, rtol=1e-5,
                               atol=1e-9)
