"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips itself when no CUDA device is present. This
file imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances: decode_cull keys and alive count exactly equal (its source is
built without FMA contraction); composite_fwd and composite_train_fwd
atol 1e-4 + rtol 1e-4 (the kernel sums per pixel sequentially, the plain
version per chunk through a cumsum); the train forward's stop equal but on
the few pixels whose transmittance lands within rounding of the 1e-4 floor;
composite_bwd within 1e-3 of each column's max |value| (the per-entry sums
run in another order: a shuffle tree over 1024 pixels against a sum over a
tensor axis); segsum within 1e-5 of each column's max (float32 against a
float64 running sum); end-to-end gradients within 2% of each leaf's max
|g|, the bound of tests/test_pallas.py. The segmentation lift's shape (9
value rows: depth + 8 label channels) is held to the same bounds. The scan
probe within 1e-5 of the block's max |value| (float32 sums in another
order, renormalised every step).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from wheat3dgs_tpu_torch.ops import cuda_raster as CR
from wheat3dgs_tpu_torch.ops import scan_probe as SP
from wheat3dgs_tpu_torch.ops.projection import project_gaussians


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _splats(dev, n, width, height, seed, channels=3):
    """Random anisotropic splats seen by a look-at camera 4 units away."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    fx = width / (2 * math.tan(0.4))
    fovy = 2 * math.atan(height / (2 * fx))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0], proj[1, 1] = 1 / math.tan(0.4), 1 / math.tan(fovy / 2)
    proj[2, 2], proj[2, 3], proj[3, 2] = 100 / 99.99, -1 / 99.99, 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return project_gaussians(
        t(rng.normal(size=(n, 3)) * 0.8),
        t(rng.uniform(0.01, 0.2, (n, 3))), t(q / np.linalg.norm(q, axis=1,
                                                               keepdims=True)),
        t(rng.uniform(0.05, 0.95, n)), t(w2c), t(proj @ w2c),
        t([0.0, 0.0, -4.0]), math.tan(0.4), math.tan(fovy / 2), width,
        height, colors=t(rng.uniform(0, 1, (n, channels))))


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,budget", [(200, 150, 0),
                                                 (131, 77, 2048)])
def test_decode_cull_kernel_matches_plain(width, height, budget):
    dev = _card()
    s = _splats(dev, 3000, width, height, seed=1)
    plan = CR.alloc_prologue(s, width, height, budget or 3000 * 16)
    before = CR.launches["decode_cull"]
    key, alive = CR.decode_cull(plan)
    key_p, alive_p = CR.decode_cull_plain(plan)
    torch.cuda.synchronize()
    assert CR.launches["decode_cull"] == before + 1
    assert torch.equal(key, key_p)
    assert int(alive) == int(alive_p) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("with_color,with_depth", [(True, True),
                                                   (False, False)])
def test_composite_fwd_kernel_matches_plain(with_color, with_depth):
    dev = _card()
    width, height = 131, 77
    s = _splats(dev, 3000, width, height, seed=2)
    plan = CR.alloc_prologue(s, width, height, 3000 * 16)
    key, _ = CR.decode_cull(plan)
    skeys, starts, ends = CR.sorted_stream(key, plan.t_total, plan.rank_bits)
    feat = CR.entry_features(s, plan.order, with_color, with_depth)
    args = (skeys, starts, ends, feat, plan.rank_bits, width, height)
    img = CR.composite_fwd(*args)
    ref = CR.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    assert img.shape == ref.shape == (1 + feat.shape[1] - 6, height, width)
    assert float(ref[0].max()) > 0.5
    torch.testing.assert_close(img, ref, atol=1e-4, rtol=1e-4)


def _stream(dev, n=3000, width=131, height=77, seed=2, channels=3):
    s = _splats(dev, n, width, height, seed=seed, channels=channels)
    plan = CR.alloc_prologue(s, width, height, n * 16)
    key, _ = CR.decode_cull(plan)
    skeys, starts, ends, perm = CR.sorted_stream(
        key, plan.t_total, plan.rank_bits, with_perm=True)
    feat = CR.entry_features(s, plan.order, True, True)
    return plan, skeys, starts, ends, perm, feat


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [3, 8])
def test_composite_train_fwd_kernel_matches_plain(channels):
    dev = _card()
    width, height = 131, 77
    plan, skeys, starts, ends, _, feat = _stream(dev, channels=channels)
    args = (skeys, starts, ends, feat, plan.rank_bits, width, height)
    before = CR.launches["composite_train_fwd"]
    img, stop = CR.composite_train_fwd(*args)
    img_p, stop_p = CR.composite_train_fwd_plain(*args)
    torch.cuda.synchronize()
    assert CR.launches["composite_train_fwd"] == before + 1
    torch.testing.assert_close(img, img_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(img, CR.composite_fwd(*args))
    assert stop.dtype == torch.int32 and stop.shape == (height, width)
    assert int((stop != stop_p).sum()) <= 0.001 * width * height


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [3, 8])
def test_composite_bwd_kernel_matches_plain(channels):
    dev = _card()
    width, height = 131, 77
    plan, skeys, starts, ends, perm, feat = _stream(dev, channels=channels)
    img, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                       plan.rank_bits, width, height)
    g = torch.as_tensor(np.random.default_rng(0).normal(
        size=img.shape).astype(np.float32), device=dev)
    args = (skeys, perm, starts, ends, feat, img, stop, g, plan.rank_bits,
            width, height)
    before = CR.launches["composite_bwd"]
    rows = CR.composite_bwd(*args)
    ref = CR.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    assert CR.launches["composite_bwd"] == before + 1
    assert rows.shape == ref.shape == (skeys.shape[0], feat.shape[1])
    scale = ref.abs().amax(dim=0)
    assert bool((scale > 0).all())
    assert float(((rows - ref).abs() / scale).max()) < 1e-3


@pytest.mark.gpu
def test_segsum_kernel_matches_plain():
    dev = _card()
    plan, *_ = _stream(dev)
    e = plan.owner.shape[0]
    vals = torch.as_tensor(np.random.default_rng(1).normal(
        size=(e, 10)).astype(np.float32), device=dev)
    before = CR.launches["segsum"]
    out = CR.segsum(vals, plan.seg_start, plan.seg_end)
    ref = CR.segsum_plain(vals, plan.seg_start, plan.seg_end)
    torch.cuda.synchronize()
    assert CR.launches["segsum"] == before + 1
    scale = ref.abs().amax(dim=0)
    assert float(((out - ref).abs() / scale).max()) < 1e-5


@contextlib.contextmanager
def plain_kernels():
    """Route the rasterizer's kernel calls to their plain versions (on the
    card's tensors) for the duration."""
    names = ("decode_cull", "composite_train_fwd", "composite_bwd", "segsum")
    saved = {k: getattr(CR, k) for k in names}
    try:
        for k in names:
            setattr(CR, k, getattr(CR, k + "_plain"))
        yield
    finally:
        for k, fn in saved.items():
            setattr(CR, k, fn)


@pytest.mark.gpu
def test_rasterize_gradients_match_plain_path():
    dev = _card()
    width, height = 131, 77
    rng = np.random.default_rng(3)
    n = 3000
    q = rng.normal(size=(n, 4)).astype(np.float32)
    fx = width / (2 * math.tan(0.4))
    fovy = 2 * math.atan(height / (2 * fx))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0], proj[1, 1] = 1 / math.tan(0.4), 1 / math.tan(fovy / 2)
    proj[2, 2], proj[2, 3], proj[3, 2] = 100 / 99.99, -1 / 99.99, 1.0

    def t(a, grad=False):
        return torch.tensor(np.asarray(a, np.float32), device=dev,
                            requires_grad=grad)

    leaves = [t(rng.normal(size=(n, 3)) * 0.8, True),
              t(rng.uniform(0.01, 0.2, (n, 3)), True),
              t(q / np.linalg.norm(q, axis=1, keepdims=True), True),
              t(rng.uniform(0.05, 0.95, n), True),
              t(rng.uniform(0, 1, (n, 3)), True)]
    target = t(rng.uniform(0, 1, (3, height, width)))

    def grads():
        s = project_gaussians(*leaves[:4], t(w2c), t(proj @ w2c),
                              t([0.0, 0.0, -4.0]), math.tan(0.4),
                              math.tan(fovy / 2), width, height,
                              colors=leaves[4])
        out = CR.rasterize(s, width, height, t([0.2, 0.1, 0.4]))
        loss = ((out.color - target) ** 2).mean() + 0.1 * out.depth.mean() \
            + 0.05 * out.alpha.mean()
        return torch.autograd.grad(loss, leaves)

    before = dict(CR.launches)
    got = grads()
    for k in ("decode_cull", "composite_train_fwd", "composite_bwd",
              "segsum"):
        assert CR.launches[k] == before[k] + 1
    with plain_kernels():
        ref = grads()
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) / scale < 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SP.KINDS)
@pytest.mark.parametrize("rows,steps,start", [(1024, 256, "ones"),
                                              (64, 17, "normal")])
def test_scan_probe_kernel_matches_plain(kind, rows, steps, start):
    dev = _card()
    if start == "ones":
        x = torch.full((rows, SP.LANES), 0.001, device=dev)
    else:
        x = torch.as_tensor(np.random.default_rng(4).normal(
            size=(rows, SP.LANES)).astype(np.float32), device=dev)
    before = CR.launches["scan_probe"]
    got = SP.scan_probe(x, kind, steps)
    ref = SP.scan_probe_plain(x, kind, steps)
    torch.cuda.synchronize()
    assert CR.launches["scan_probe"] == before + 1
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale
