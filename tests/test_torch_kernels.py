"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips itself when no CUDA device is present. This
file imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances: decode_cull keys and alive count exactly equal (its source is
built without FMA contraction); composite_fwd and composite_train_fwd
atol 1e-4 + rtol 1e-4 (the kernel sums per pixel sequentially, the plain
version per chunk through a cumsum), on partial edge tiles, a near-empty
and an all-empty 1600x1200 frame and 0, 1, 4 and 9 value rows, with two
launches bit-identical and the two kernels' images equal; the train
forward's stop equal but on the few pixels whose transmittance lands
within rounding of the 1e-4 floor;
composite_bwd within 1e-3 of each column's max |value| (the per-entry sums
run in another order: a shuffle tree over 1024 pixels against a sum over a
tensor axis); segsum within 1e-5 of each column's max (float32 against a
float64 running sum); end-to-end gradients within 2% of each leaf's max
|g|, the bound of tests/test_pallas.py. The segmentation lift's shape (9
value rows: depth + 8 label channels) is held to the same bounds. The scan
probe within 1e-5 of the block's max |value| (float32 sums in another
order, renormalised every step), at the probe's shape and at the edges of
its one cluster (8 rows, fewer than its CTAs; rows that are no multiple of
them; the most it holds), with 0 steps returning the input and a row past
its capacity refused. composite_bwd, segsum and the probe sum in a fixed
order, so two launches on the same inputs are bit-identical.
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


def _splats(dev, n, width, height, seed, channels=3, big=0):
    """Random anisotropic splats seen by a look-at camera 4 units away; the
    first `big` of them are 5x larger."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    scale = rng.uniform(0.01, 0.2, (n, 3))
    scale[:big] *= 5.0
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
        t(scale), t(q / np.linalg.norm(q, axis=1, keepdims=True)),
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


def _stream(dev, n=3000, width=131, height=77, seed=2, channels=3,
            with_color=True, with_depth=True, big=0):
    s = _splats(dev, n, width, height, seed=seed, channels=channels, big=big)
    plan = CR.alloc_prologue(s, width, height, n * 16)
    key, _ = CR.decode_cull(plan)
    skeys, starts, ends, perm = CR.sorted_stream(
        key, plan.t_total, plan.rank_bits, with_perm=True)
    feat = CR.entry_features(s, plan.order, with_color, with_depth)
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


# Value rows -> (colour channels, with colour, with depth) of the table.
NV_LAYOUT = {0: (3, False, False), 1: (3, False, True), 4: (3, True, True),
             9: (8, True, True)}


def _forward_case(dev, case, nv):
    """Compositor arguments of one forward case: "edges" (200x150, partial
    edge tiles, 40 large splats), "cluster" (one small cluster of 400
    splats in a 1600x1200 image: a near-empty frame) or "empty" (the
    cluster's stream with every tile's segment emptied)."""
    channels, with_color, with_depth = NV_LAYOUT[nv]
    if case == "edges":
        width, height = 200, 150
        plan, skeys, starts, ends, _, feat = _stream(
            dev, width=width, height=height, channels=channels,
            with_color=with_color, with_depth=with_depth, big=40)
        return (skeys, starts, ends, feat, plan.rank_bits, width, height)
    width, height = 1600, 1200
    s = _splats(dev, 400, width, height, seed=6, channels=channels)
    # Moved into one spot and shrunk 4x (conic x 16, radius / 4).
    centre = torch.tensor([800.0, 600.0], device=dev)
    s = s._replace(xy=centre + (s.xy - s.xy.mean(dim=0)) * 0.05,
                   conic=s.conic * 16.0, radius=(s.radius + 3) // 4)
    plan = CR.alloc_prologue(s, width, height, 128)
    plan = CR.alloc_prologue(s, width, height,
                             (int(plan.total) + 127) // 128 * 128)
    key, _ = CR.decode_cull(plan)
    skeys, starts, ends = CR.sorted_stream(key, plan.t_total, plan.rank_bits)
    feat = CR.entry_features(s, plan.order, with_color, with_depth)
    if case == "empty":
        starts = ends = torch.zeros_like(starts)
    else:
        assert 0 < int((ends > starts).sum()) < 0.05 * plan.t_total
    return (skeys, starts, ends, feat, plan.rank_bits, width, height)


@pytest.mark.gpu
@pytest.mark.parametrize("nv", sorted(NV_LAYOUT))
@pytest.mark.parametrize("case", ["edges", "cluster", "empty"])
def test_forward_compositors_match_plain(case, nv):
    """Both forward kernels against the plain walk, bit-identical over two
    launches, and composite_train_fwd's image equal to composite_fwd's."""
    dev = _card()
    args = _forward_case(dev, case, nv)
    width, height = args[-2:]
    before = dict(CR.launches)
    img, img2 = CR.composite_fwd(*args), CR.composite_fwd(*args)
    (timg, stop), (timg2, stop2) = (CR.composite_train_fwd(*args),
                                    CR.composite_train_fwd(*args))
    ref, stop_p = CR.composite_train_fwd_plain(*args)
    torch.cuda.synchronize()
    for k in ("composite_fwd", "composite_train_fwd"):
        assert CR.launches[k] == before[k] + 2
    assert img.shape == ref.shape == (1 + nv, height, width)
    assert torch.equal(img, img2) and torch.equal(timg, timg2)
    assert torch.equal(stop, stop2)
    assert torch.equal(img, timg)
    torch.testing.assert_close(img, ref, atol=1e-4, rtol=1e-4)
    assert int((stop != stop_p).sum()) <= 0.001 * width * height
    if case == "empty":
        assert not bool(img.any()) and not bool(stop.any())
    else:
        assert float(ref[0].max()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("nv", sorted(NV_LAYOUT))
def test_composite_bwd_kernel_matches_plain(nv):
    dev = _card()
    width, height = 131, 77
    channels, with_color, with_depth = NV_LAYOUT[nv]
    # 40 large splats: some tiles walk several 64-entry batches.
    plan, skeys, starts, ends, perm, feat = _stream(
        dev, channels=channels, with_color=with_color,
        with_depth=with_depth, big=40)
    assert feat.shape[1] == 6 + nv
    img, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                       plan.rank_bits, width, height)
    tiles_x = plan.tiles_x
    ty = torch.arange(height, device=dev)[:, None] // CR.TILE_PX
    tx = torch.arange(width, device=dev)[None, :] // CR.TILE_PX
    walked = stop.long() - starts[ty * tiles_x + tx]
    assert int(walked.max()) > 3 * 64
    g = torch.as_tensor(np.random.default_rng(0).normal(
        size=img.shape).astype(np.float32), device=dev)
    args = (skeys, perm, starts, ends, feat, img, stop, g, plan.rank_bits,
            width, height)
    before = CR.launches["composite_bwd"]
    rows = CR.composite_bwd(*args)
    again = CR.composite_bwd(*args)
    ref = CR.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    assert CR.launches["composite_bwd"] == before + 2
    assert rows.shape == ref.shape == (skeys.shape[0], feat.shape[1])
    assert torch.equal(rows, again)
    scale = ref.abs().amax(dim=0)
    assert bool((scale > 0).all())
    assert float(((rows - ref).abs() / scale).max()) < 1e-3


def segment_layout(kind: str, seed: int = 0):
    """(seg_start, seg_end) int32 numpy bounds of 1000 depth ranks tiling
    [0, min(total, E)) as alloc_prologue makes them, and the slot count E.
    Kinds: "long" (a dozen 1024-slot segments and some of 17-400 slots
    among short ones), "empty_runs" (runs of empty ranks, among them two
    whole blocks of the kernel's 128 ranks), "clipped" (a budget E two
    thirds of the demand: the ranks past it are empty at E, one is cut
    short), "unaligned" (every 128-rank block's span starts 3 slots past a
    4-slot boundary, so off 16 bytes at any column count)."""
    rng = np.random.default_rng(seed)
    n = 1000
    counts = rng.integers(0, 8, n)
    if kind == "long":
        counts[rng.choice(n, 12, replace=False)] = 1024
        counts[rng.choice(n, 20, replace=False)] = rng.integers(17, 400, 20)
    elif kind == "empty_runs":
        for a in rng.choice(n - 300, 6, replace=False):
            counts[a:a + rng.integers(30, 300)] = 0
        counts[256:512] = 0
    elif kind == "unaligned":
        for b in range(128, n, 128):
            counts[b - 1] += (3 - int(counts[:b].sum())) % 4
    elif kind != "clipped":
        raise ValueError(kind)
    offs = np.cumsum(counts) - counts
    total = int(counts.sum())
    e = total * 2 // 3 if kind == "clipped" else total + 100
    return (np.minimum(offs, e).astype(np.int32),
            np.minimum(offs + counts, e).astype(np.int32), e)


SEGMENT_KINDS = ("long", "empty_runs", "clipped", "unaligned")


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [1, 10, 15])
@pytest.mark.parametrize("kind", ("plan",) + SEGMENT_KINDS)
def test_segsum_kernel_matches_plain(kind, cols):
    dev = _card()
    if kind == "plan":
        plan, *_ = _stream(dev)
        seg_start, seg_end = plan.seg_start, plan.seg_end
        e = plan.owner.shape[0]
    else:
        a, b, e = segment_layout(kind)
        seg_start = torch.as_tensor(a, device=dev)
        seg_end = torch.as_tensor(b, device=dev)
    vals = torch.as_tensor(np.random.default_rng(1).normal(
        size=(e, cols)).astype(np.float32), device=dev)
    before = CR.launches["segsum"]
    out = CR.segsum(vals, seg_start, seg_end)
    again = CR.segsum(vals, seg_start, seg_end)
    ref = CR.segsum_plain(vals, seg_start, seg_end)
    torch.cuda.synchronize()
    assert CR.launches["segsum"] == before + 2
    assert torch.equal(out, again)
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
                                              (1024, 256, "normal"),
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


def _normal_block(dev, rows, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(rows, SP.LANES)).astype(np.float32), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SP.KINDS)
@pytest.mark.parametrize("rows", [8, 100, 1000, SP.MAX_ROWS])
def test_scan_probe_kernel_cluster_edges(kind, rows):
    dev = _card()
    x = _normal_block(dev, rows, 5)
    got = SP.scan_probe(x, kind, 17)
    ref = SP.scan_probe_plain(x, kind, 17)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SP.KINDS)
def test_scan_probe_kernel_repeats_and_zero_steps(kind):
    dev = _card()
    x = _normal_block(dev, SP.MAX_ROWS, 6)
    first = SP.scan_probe(x, kind, 256)
    again = SP.scan_probe(x, kind, 256)
    same = SP.scan_probe(x, kind, 0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(same, x)


@pytest.mark.gpu
def test_scan_probe_kernel_refuses_rows_past_the_cluster():
    dev = _card()
    x = torch.zeros((SP.MAX_ROWS + 1, SP.LANES), device=dev)
    with pytest.raises(ValueError, match=f"1..{SP.MAX_ROWS}"):
        SP.scan_probe(x, "cumsum", 1)
