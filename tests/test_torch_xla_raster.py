"""Parity of the port's padded-tile rasterizer (JAX's "xla" backend:
wheat3dgs_tpu_torch.ops.binning's bin_splats / count_tiles / ladders,
ops/raster.py's rasterize and compositors, ops/reference_raster.py) with
the JAX package's, on the CPU.

The splats are projected once by JAX (`testing.project_scene`) and the
same float32 arrays go to both packages, so binning can be held exactly:
- `bin_splats`' tile_lists, tile_counts and depth_order, and `count_tiles`,
  equal JAX's, at JAX's test configs (tests/test_raster.py,
  tests/test_seg.py, tests/test_parallel.py), with crops at max_per_tile
  and at max_tiles_per_gauss and an odd image size;
- `pick_mtpg` / `pick_max_per_tile` give JAX's rung over a sweep;
- `rasterize` within 2e-5 (colour, alpha) and 2e-4 (depth) of JAX's and
  of the port's own naive `composite_pixels(tile_grid=...)` (only JAX's
  where a tile crops), the bounds of tests/test_raster.py:113-115;
- `composite_tile` (cumulative product) against `composite_packed`
  (exp of a cumulative log sum);
- the gradients of an L2 loss through `render(config=RasterConfig(
  backend="xla"))` within 1e-3 of each leaf's max |g| of JAX's XLA
  autodiff, and one finite-difference check as tests/test_raster.py's;
- RasterConfig takes JAX's fields and refuses an unknown backend.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu import testing
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.ops import binning as JB
from wheat3dgs_tpu.ops import raster as JR
from wheat3dgs_tpu.render import pipeline as JP
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops import binning as TB
from wheat3dgs_tpu_torch.ops import raster as TR
from wheat3dgs_tpu_torch.ops import reference_raster as TREF
from wheat3dgs_tpu_torch.ops.projection import Splats2D
from wheat3dgs_tpu_torch.render import pipeline as TP

# (width, height, n, seed, tile, max_tiles_per_gauss, max_per_tile,
#  tile_batch): JAX's test configs.
CONFIGS = {
    "raster": (64, 48, 120, 3, 16, 32, 128, 64),     # test_raster.py:56
    "raster_256": (64, 48, 120, 3, 16, 32, 256, 64),  # :112
    "odd": (50, 37, 60, 9, 16, 32, 128, 64),          # :121-128
    "seg_crop": (64, 48, 120, 3, 16, 8, 16, 4),       # test_seg.py:290
    "parallel": (64, 48, 120, 3, 16, 8, 64, 12),      # test_parallel.py:35
    "tile32": (50, 37, 60, 9, 32, 64, 512, 7),        # the entry stream's tile
}


# JAX's functions jitted once per config: op-by-op dispatch of the same
# programs costs several times more on the CPU.
_jbin = jax.jit(JB.bin_splats, static_argnums=(1, 2, 3, 4, 5))
_jcount = jax.jit(JB.count_tiles, static_argnums=(1, 2, 3, 4))
_jraster = jax.jit(JR.rasterize, static_argnames=(
    "width", "height", "tile", "max_tiles_per_gauss", "max_per_tile",
    "tile_batch"))


@functools.lru_cache(maxsize=None)
def _splats(width, height, n, seed, scale_range=(0.02, 0.25)):
    cam = testing.look_at_camera(width=width, height=height)
    g = testing.random_gaussians(n=n, seed=seed, spread=0.8,
                                 scale_range=scale_range)
    g["colors"] = np.random.default_rng(seed + 7).random(
        (n, 3)).astype(np.float32)
    js = testing.project_scene(g, cam, use_colors=True)
    ts = Splats2D(*(torch.tensor(np.asarray(x)) for x in js))
    return js, ts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bin_splats_and_count_tiles_equal_jax(name):
    w, h, n, seed, tile, mtpg, mpt, _ = CONFIGS[name]
    js, ts = _splats(w, h, n, seed)
    jb = _jbin(js, w, h, tile, mtpg, mpt)
    tb = TB.bin_splats(ts, w, h, tile, mtpg, mpt)
    np.testing.assert_array_equal(tb.tile_lists.numpy(),
                                  np.asarray(jb.tile_lists))
    np.testing.assert_array_equal(tb.tile_counts.numpy(),
                                  np.asarray(jb.tile_counts))
    np.testing.assert_array_equal(tb.depth_order.numpy(),
                                  np.asarray(jb.depth_order))
    np.testing.assert_array_equal(
        TB.count_tiles(ts, w, h, tile, mtpg).numpy(),
        np.asarray(_jcount(js, w, h, tile, mtpg)))
    if name == "seg_crop":     # the config crops at max_per_tile
        assert int(tb.tile_counts.max()) > mpt


def test_bin_splats_crops_large_splats_like_jax():
    """Splats far wider than max_tiles_per_gauss keep JAX's centred
    window: a crop at the expansion cap."""
    w, h, tile, mtpg, mpt = 64, 48, 8, 4, 64
    js, ts = _splats(w, h, 40, 11, scale_range=(0.3, 0.6))
    tiles_x, tiles_y = TB.num_tiles(w, h, tile)
    _, _, sx, sy, _ = TB.capped_rect(ts, tiles_x, tiles_y, tile, 1 << 30)
    assert int((sx * sy).max()) > mtpg
    jb = _jbin(js, w, h, tile, mtpg, mpt)
    tb = TB.bin_splats(ts, w, h, tile, mtpg, mpt)
    np.testing.assert_array_equal(tb.tile_lists.numpy(),
                                  np.asarray(jb.tile_lists))
    np.testing.assert_array_equal(tb.tile_counts.numpy(),
                                  np.asarray(jb.tile_counts))


def test_ladders_match_jax():
    for m in range(0, 6000, 7):
        assert TB.pick_max_per_tile(m) == JB.pick_max_per_tile(m)
        for hr in (1.0, 1.15, 1.5):
            assert (TB.pick_max_per_tile(m, headroom=hr)
                    == JB.pick_max_per_tile(m, headroom=hr))
    for a in range(0, 70):
        assert TB.pick_mtpg(a) == JB.pick_mtpg(a)
    assert TB.MAX_PER_TILE_LADDER == JB.MAX_PER_TILE_LADDER
    assert TB.MTPG_LADDER == JB.MTPG_LADDER


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rasterize_matches_jax_and_naive(name):
    w, h, n, seed, tile, mtpg, mpt, tb = CONFIGS[name]
    js, ts = _splats(w, h, n, seed)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jo = _jraster(js, width=w, height=h, bg=jnp.asarray(bg), tile=tile,
                  max_tiles_per_gauss=mtpg, max_per_tile=mpt, tile_batch=tb)
    to = TR.rasterize(ts, w, h, torch.tensor(bg), tile=tile,
                      max_tiles_per_gauss=mtpg, max_per_tile=mpt,
                      tile_batch=tb)
    assert to.entries_total is None and to.entries_alive is None
    assert to.color.shape == (3, h, w)
    for f, atol in (("color", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        _close(getattr(to, f), getattr(jo, f), atol, f"{name} {f} vs JAX")
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))
    counts = TB.count_tiles(ts, w, h, tile, mtpg)
    tiles_x, tiles_y = TB.num_tiles(w, h, tile)
    _, _, sx, sy, _ = TB.capped_rect(ts, tiles_x, tiles_y, tile, 1 << 30)
    cropped = (int(counts.max()) > mpt
               or int(((sx * sy) * (ts.radius > 0)).max()) > mtpg)
    if not cropped:
        gold = TREF.rasterize_naive(ts, w, h, torch.tensor(bg), tile=tile)
        for f, atol in (("color", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
            _close(getattr(to, f), gold[f].numpy(), atol,
                   f"{name} {f} vs naive")
    else:
        assert name in ("seg_crop", "parallel")   # both crop


def test_naive_matches_jax_naive():
    """The port's golden model against JAX's: colour, alpha, depth, the
    contributor count."""
    from wheat3dgs_tpu.ops import reference_raster as JREF

    js, ts = _splats(50, 37, 60, 9)
    bg = np.array([0.3, 0.0, 0.6], np.float32)
    jg = JREF.rasterize_naive(js, 50, 37, jnp.asarray(bg))
    tg = TREF.rasterize_naive(ts, 50, 37, torch.tensor(bg))
    for f, atol in (("color", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        _close(tg[f], jg[f], atol, f)
    np.testing.assert_array_equal(tg["n_contrib"].numpy(),
                                  np.asarray(jg["n_contrib"]))


def test_composite_tile_matches_composite_packed():
    w, h, tile, mtpg, mpt = 64, 48, 16, 32, 128
    js, ts = _splats(w, h, 120, 3)
    bins = TB.bin_splats(ts, w, h, tile, mtpg, mpt)
    bg = torch.tensor([0.2, 0.4, 0.1])
    packed = TR.pack_splats(ts)
    pix0 = TR._tile_pixel_grid(tile)
    origins = TR.tile_origins(*TB.num_tiles(w, h, tile), tile)
    busiest = int(torch.argmax(bins.tile_counts))
    for t in (0, busiest):
        idx = bins.tile_lists[t]
        valid = idx >= 0
        safe = torch.clamp(idx, min=0).long()
        pix = pix0 + origins[t]
        a = TR.composite_packed(pix, packed[safe], valid, bg)
        b = TR.composite_tile(pix, ts.xy[safe], ts.conic[safe],
                              ts.color[safe], ts.opacity[safe],
                              ts.depth[safe], valid, bg)
        for x, y, atol in zip(a, b, (2e-5, 2e-4, 2e-5, 2e-5)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol)
        # And each against JAX's composite_tile on the same rows.
        j = JR.composite_tile(*(jnp.asarray(x.numpy()) for x in (
            pix, ts.xy[safe], ts.conic[safe], ts.color[safe],
            ts.opacity[safe], ts.depth[safe], valid, bg)))
        for x, y, atol in zip(b, j, (2e-5, 2e-4, 2e-5, 2e-5)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=atol)


def _state_pair(n=60, seed=9, cap=72):
    g = testing.random_gaussians(n=n, seed=seed, spread=0.7, sh_degree=1)
    params = {
        "means": g["means3d"], "quats": g["quats"],
        "log_scales": np.log(g["scales"]),
        "sh_dc": g["sh"][:, 0], "sh_rest": g["sh"][:, 1:].reshape(n, -1),
        "opacity_logit": np.log(g["opacities"] / (1 - g["opacities"]))}
    jst = JG.init_state(JG.GaussianParams(
        **{k: jnp.asarray(v) for k, v in params.items()}), capacity=cap)
    full = {k: np.asarray(getattr(jst.params, k)) for k in params}
    tst = TG.state_from_numpy(full, alive=np.asarray(jst.alive),
                              device="cpu")
    return jst, tst


def _cam(width, height):
    cam = testing.look_at_camera(width=width, height=height)
    j = (jnp.asarray(cam.w2c), jnp.asarray(cam.full_proj),
         jnp.asarray(cam.cam_center), jnp.float32(cam.tanfovx),
         jnp.float32(cam.tanfovy))
    t = (torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
         torch.tensor(cam.cam_center), torch.tensor(cam.tanfovx),
         torch.tensor(cam.tanfovy))
    return j, t


@pytest.mark.parametrize("w,h,fields", [
    (64, 48, dict(max_tiles_per_gauss=32, max_per_tile=128)),
    (50, 37, dict(max_tiles_per_gauss=8, max_per_tile=16, tile_batch=4)),
])
def test_render_gradients_match_jax_xla_autodiff(w, h, fields):
    """An L2 loss on colour, depth and alpha through render(config=xla):
    every parameter leaf's gradient within 1e-3 of its max |g| of JAX's
    autodiff (the crop case included)."""
    jst, tst = _state_pair()
    jcam, tcam = _cam(w, h)
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    gt = np.random.default_rng(4).random((3, h, w)).astype(np.float32)
    jconf = JP.RasterConfig(backend="xla", **fields)
    tconf = TP.RasterConfig(backend="xla", **fields)

    def jloss(params):
        st = dataclasses.replace(jst, params=params)
        out = JP.render(st, *jcam, w, h, 1, bg=jnp.asarray(bg),
                        config=jconf)
        return (((out.color - gt) ** 2).mean() + 0.1 * out.depth.mean()
                + 0.05 * out.alpha.mean())

    jval, jg = jax.jit(jax.value_and_grad(jloss))(jst.params)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tst.params.as_dict().items()}
    st = dataclasses.replace(tst, params=TG.GaussianParams(**leaves))
    out = TP.render(st, *tcam, w, h, 1, bg=torch.tensor(bg), config=tconf)
    assert out.entries_total is None
    tval = (((out.color - torch.tensor(gt)) ** 2).mean()
            + 0.1 * out.depth.mean() + 0.05 * out.alpha.mean())
    tg = torch.autograd.grad(tval, list(leaves.values()))
    assert float(tval.detach()) == pytest.approx(float(jval), rel=1e-5)
    for k, got in zip(leaves, tg):
        want = np.asarray(getattr(jg, k))
        scale = np.abs(want).max()
        assert scale > 0, k
        err = np.abs(got.numpy() - want).max() / scale
        assert err < 1e-3, f"{k}: {err:.2e} of max"


def test_render_gradient_finite_difference():
    """d loss / d means through render(config=xla) against central
    differences on the coordinates with the largest gradient
    (tests/test_raster.py:138-165)."""
    w, h = 64, 48
    _, tst = _state_pair(n=40, seed=3, cap=40)
    _, tcam = _cam(w, h)
    conf = TP.RasterConfig(backend="xla", max_tiles_per_gauss=32,
                           max_per_tile=128)

    def loss(means):
        st = dataclasses.replace(tst, params=dataclasses.replace(
            tst.params, means=means))
        out = TP.render(st, *tcam, w, h, 0, config=conf)
        return (out.color ** 2).mean()

    means = tst.params.means.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(loss(means), means)
    assert torch.isfinite(grad).all()
    flat = grad.reshape(-1)
    eps = 2e-3
    with torch.no_grad():
        for j in torch.argsort(-flat.abs())[:4].tolist():
            e = torch.zeros_like(flat)
            e[j] = eps
            e = e.reshape(means.shape)
            fd = (loss(means + e) - loss(means - e)) / (2 * eps)
            assert float(fd) == pytest.approx(float(flat[j]), rel=0.12,
                                              abs=1e-6)


def test_render_fwd_xla_fills_every_field():
    """render_fwd on "xla" ignores with_color / with_depth (JAX's
    docstring) and equals render's forward."""
    w, h = 50, 37
    jst, tst = _state_pair()
    jcam, tcam = _cam(w, h)
    conf = TP.RasterConfig(backend="xla", tile_batch=5)
    a = TP.render_fwd(tst, *tcam, w, h, 1, config=conf, with_color=False,
                      with_depth=False)
    assert a.color is not None and a.depth is not None
    b = TP.render_fwd(tst, *tcam, w, h, 1, config=conf)
    with torch.no_grad():
        c = TP.render(tst, *tcam, w, h, 1, config=conf)
    torch.testing.assert_close(b.color, c.color, rtol=0, atol=0)
    torch.testing.assert_close(a.alpha, b.alpha, rtol=0, atol=0)
    j = JP.render_fwd_jit(jst, *jcam, w, h, 1, config=JP.RasterConfig(
        backend="xla", tile_batch=5))
    _close(b.color, j.color, 2e-5, "color")
    _close(b.depth, j.depth, 2e-4, "depth")


def test_raster_config_fields_and_backend():
    jax_style = TP.RasterConfig(tile=32, max_tiles_per_gauss=8,
                                max_per_tile=256, tile_batch=16,
                                backend="xla", entry_budget=0,
                                pack_payload=False)
    assert [f.name for f in dataclasses.fields(jax_style)] == [
        f.name for f in dataclasses.fields(JP.RasterConfig)]
    assert TP.RasterConfig(tile=8, max_per_tile=64).backend == "pallas"
    with pytest.raises(ValueError, match="bogus"):
        TP.RasterConfig(backend="bogus")
    conf = TP.inference_config(TP.RasterConfig(backend="xla", tile=32))
    assert conf.backend == "pallas" and conf.tile == 32


def test_adapt_config_xla_picks_jax_rung():
    w, h = 64, 48
    jst, tst = _state_pair(n=120, seed=3, cap=128)
    jcam, tcam = _cam(w, h)
    for fields in (dict(), dict(tile=8, max_tiles_per_gauss=32)):
        jc = JP.adapt_config(jst, jcam, w, h,
                             JP.RasterConfig(backend="xla", **fields))
        tc = TP.adapt_config(tst, tcam, w, h,
                             TP.RasterConfig(backend="xla", **fields))
        assert tc.max_per_tile == jc.max_per_tile
        assert tc.entry_budget == 0 and tc.backend == "xla"
