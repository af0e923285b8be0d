"""LiftOut.contrib_num of the port (ops/mask_lift.py, from the training
compositor's per-pixel count of included entries) against the JAX
package's lift_mask, which counts (w > 0) per pixel in its XLA tile
compositor.

The same seeded numpy Gaussians and look-at cameras go to both packages.
The JAX side runs its XLA rasterizer at the port's 32-px tiles with caps
that crop nothing at these sizes (as tests/test_torch_seg.py does); the
port runs its entry-stream rasterizer with the kernels' plain versions.

Tolerances: the counts are integers and must be equal exactly, pixel for
pixel. The plain walk's per-pixel count must also sum to its own
`weighted` total (the (pixel, entry) pairs with w > 0), and the training
compositor's count must equal the lift's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seg import JAX_CONFIG, _cams, _jcams, _states, _tcams
from wheat3dgs_tpu.ops import mask_lift as JM
from wheat3dgs_tpu.seg import flashsplat as JF
from wheat3dgs_tpu_torch.ops import cuda_raster as CR
from wheat3dgs_tpu_torch.ops import mask_lift as TM
from wheat3dgs_tpu_torch.seg import flashsplat as TF

W, H = 64, 48


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lifts(n, seed, eye, labels):
    jstate, tstate = _states(n=n, seed=seed, capacity=n + 4)
    cams = _cams((eye,))
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, labels, size=(H, W)).astype(np.int32)
    jsplats = JF._project(jstate, *_jcams(cams, 0), W, H)
    ref = JM.lift_mask(jsplats, jnp.asarray(gt), labels - 1, W, H,
                       tile=JAX_CONFIG.tile,
                       max_tiles_per_gauss=JAX_CONFIG.max_tiles_per_gauss,
                       max_per_tile=JAX_CONFIG.max_per_tile)
    tsplats = TF._project(tstate, *_tcams(cams, 0), W, H)
    out = TM.lift_mask(tsplats, torch.from_numpy(gt), labels - 1, W, H)
    return ref, out, tsplats


CASES = [
    (60, 7, (0.0, 0.0, -4.0), 4),
    (60, 11, (0.6, -0.3, -3.8), 11),   # two passes: the first one counts
    (300, 3, (0.0, 0.0, -3.0), 4),     # dense: pixels stop at T < 1e-4
]


@pytest.mark.parametrize("n,seed,eye,labels", CASES)
def test_contrib_num_matches_jax_lift_mask(n, seed, eye, labels):
    ref, out, _ = _lifts(n, seed, eye, labels)
    want = np.asarray(ref.contrib_num)
    got = out.contrib_num
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
    assert want.max() > 1
    np.testing.assert_array_equal(got.numpy(), want)
    # The rest of the LiftOut still lines up with JAX's, field for field.
    assert TM.LiftOut._fields == JM.LiftOut._fields
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha),
                               atol=1e-5)


@pytest.mark.parametrize("n,seed,eye,labels", CASES)
def test_plain_count_sums_to_weighted_pairs(n, seed, eye, labels):
    """The plain walk's per-pixel count against its `weighted` total, and
    the training compositor's count (every value-row width) against the
    lift's."""
    _, out, splats = _lifts(n, seed, eye, labels)
    plan = CR.alloc_prologue(splats, W, H, CR.default_budget(n + 4))
    keys, _ = CR.decode_cull(plan)
    skeys, starts, ends = CR.sorted_stream(keys, plan.t_total,
                                           plan.rank_bits)
    colors = torch.zeros((splats.xy.shape[0], 8))
    feat = CR.entry_features(splats._replace(color=colors), plan.order,
                             True, True)
    args = (skeys, starts, ends, feat, plan.rank_bits, W, H)
    img, stop, contrib = CR.composite_train_fwd(*args, with_contrib=True)
    np.testing.assert_array_equal(contrib.numpy(), out.contrib_num.numpy())
    # Under the kernels' sub-tile cull the walk skips the pixels past the
    # image, so `weighted` counts the image's pairs only; the cull drops
    # no pair with w > 0, so the count is the same.
    keep = CR.fwd_subtile_keep(*args)
    img_k, stop_k, (visited, weighted), contrib_k = CR._plain_forward(
        *args, True, True, keep, with_contrib=True)
    assert int(contrib_k.sum()) == weighted < visited
    assert torch.equal(contrib_k, contrib) and torch.equal(stop_k, stop)
    img_p, stop_p = CR.composite_train_fwd(*args)
    assert torch.equal(img_p, img) and torch.equal(stop_p, stop)
    for nv in (0, 4):
        f = feat[:, :6 + nv].contiguous()
        _, _, c = CR.composite_train_fwd_plain(
            skeys, starts, ends, f, plan.rank_bits, W, H, with_contrib=True)
        assert torch.equal(c, contrib)


@pytest.mark.parametrize("n,seed,eye,labels", CASES)
def test_lift_without_contrib_keeps_counts(n, seed, eye, labels):
    """with_contrib=False (the seg and eval apps' lifts, which read only
    the counts) leaves contrib_num None and every other field equal."""
    _, out, splats = _lifts(n, seed, eye, labels)
    rng = np.random.default_rng(seed)
    gt = torch.from_numpy(
        rng.integers(0, labels, size=(H, W)).astype(np.int32))
    bare = TM.lift_mask(splats, gt, labels - 1, W, H, with_contrib=False)
    assert bare.contrib_num is None
    for k in ("used_count", "alpha", "proj_xy", "gs_depth"):
        assert torch.equal(getattr(bare, k), getattr(out, k)), k
