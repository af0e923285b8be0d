"""The forward compositors' sub-tile cull (`cuda_raster.fwd_subtile_keep`,
the plain mirror of csrc/composite_fwd.cu's box_keep) and its work count
(`fwd_block_steps`), against brute force on the CPU:

(i)   every (sub-tile, entry) pair with a pixel at alpha >= 1/255 (power
      <= 0, the plain walk's float32 arithmetic) is kept;
(ii)  the plain walk over only the kept entries gives exactly
      composite_fwd_plain's image and composite_train_fwd_plain's stop;
(iii) fwd_block_steps equals a brute-force count of the kept, tested and
      walked pairs.

The streams have partial edge tiles (200x150 and 131x77), splats with
opacity just under and over the alpha floor (some survive decode_cull's
tile test and reach the sub-tile test), near-degenerate and degenerate
conics, and small splats centred on sub-tile borders.
"""

import numpy as np
import pytest
import torch
from test_torch_kernels import _splats

from wheat3dgs_tpu_torch.ops import cuda_raster as CR
from wheat3dgs_tpu_torch.ops.raster import ALPHA_MAX, ALPHA_MIN

SUB = CR.SUB_PX


def _edge_case_stream(width, height, seed):
    s = _splats(torch.device("cpu"), 1500, width, height, seed=seed, big=30)
    rng = np.random.default_rng(seed + 10)
    n = s.xy.shape[0]
    xy, conic, op = s.xy.clone(), s.conic.clone(), s.opacity.clone()
    idx = rng.permutation(n)
    faint, needle, flat, border = (torch.as_tensor(idx[a:b]) for a, b in
                                   ((0, 120), (120, 220), (220, 240),
                                    (240, 400)))
    # Opacity within 1e-4 of the floor, on both sides.
    op[faint] = ALPHA_MIN * torch.as_tensor(
        rng.choice([1 - 1e-4, 1 - 1e-5, 1 + 1e-5, 1 + 1e-3], len(faint)),
        dtype=torch.float32)
    # Needles: b^2 within 1e-5 of a c (near-degenerate), and a few with
    # b^2 = a c rounded either way (degenerate).
    a = torch.as_tensor(rng.uniform(0.3, 3.0, len(needle)),
                        dtype=torch.float32)
    c = torch.as_tensor(rng.uniform(1e-4, 1e-2, len(needle)),
                        dtype=torch.float32)
    sign = torch.as_tensor(rng.choice([-1.0, 1.0], len(needle)),
                           dtype=torch.float32)
    conic[needle] = torch.stack(
        [a, sign * torch.sqrt(a * c) * (1 - 1e-5), c], dim=1)
    a, c = conic[flat, 0], conic[flat, 2]
    conic[flat, 1] = torch.sqrt(a * c)
    # Small splats on the sub-tile borders (x or y a multiple of 16, give
    # or take a third of a pixel).
    xy[border] = torch.as_tensor(
        SUB * rng.integers(0, max(width, height) // SUB + 1, (len(border), 2))
        + rng.uniform(-0.34, 0.34, (len(border), 2)), dtype=torch.float32)
    xy[border] = torch.minimum(xy[border], torch.tensor([width - 1.0,
                                                         height - 1.0]))
    conic[border] = torch.as_tensor(
        np.stack([rng.uniform(0.2, 2.0, len(border)),
                  rng.uniform(-0.1, 0.1, len(border)),
                  rng.uniform(0.2, 2.0, len(border))], axis=1),
        dtype=torch.float32)
    s = s._replace(xy=xy, conic=conic, opacity=op)
    plan = CR.alloc_prologue(s, width, height, 1500 * 16)
    key, _ = CR.decode_cull(plan)
    skeys, starts, ends = CR.sorted_stream(key, plan.t_total, plan.rank_bits)
    feat = CR.entry_features(s, plan.order, True, True)
    return (skeys, starts, ends, feat, plan.rank_bits, width, height), plan


def _live(f, px, py):
    """(K, P) renderCUDA liveness of entries f (K, 6+) at pixels (P,), in
    the plain walk's float32 arithmetic (_chunk_alpha's)."""
    dx = px[None, :] - f[:, None, 0]
    dy = py[None, :] - f[:, None, 1]
    power = (-0.5 * (f[:, None, 2] * dx * dx + f[:, None, 4] * dy * dy)
             - f[:, None, 3] * dx * dy)
    alpha = torch.clamp(f[:, None, 5] * torch.exp(power), max=ALPHA_MAX)
    return ~((power > 0.0) | (alpha < ALPHA_MIN))


def _subtiles(t, tiles_x, width, height):
    """The in-image sub-tiles of tile t: (s, pixel xs, pixel ys)."""
    for s in range(4):
        x0 = (t % tiles_x) * CR.TILE_PX + (s % 2) * SUB
        y0 = (t // tiles_x) * CR.TILE_PX + (s // 2) * SUB
        if x0 < width and y0 < height:
            xs = torch.arange(x0, min(x0 + SUB, width), dtype=torch.float32)
            ys = torch.arange(y0, min(y0 + SUB, height), dtype=torch.float32)
            yield s, xs, ys


SHAPES = [(200, 150, 2), (200, 150, 7), (131, 77, 3)]


@pytest.mark.parametrize("width,height,seed", SHAPES)
def test_subtile_cull_keeps_every_live_pair(width, height, seed):
    args, plan = _edge_case_stream(width, height, seed)
    skeys, starts, ends, feat, rank_bits = args[:5]
    keep = CR.fwd_subtile_keep(*args)
    assert keep.shape == (skeys.shape[0], 4)
    rank = skeys & ((1 << rank_bits) - 1)
    kept = tested = 0
    for t in range(plan.t_total):
        k = torch.arange(int(starts[t]), int(ends[t]))
        f = feat[rank[k]]
        for s, xs, ys in _subtiles(t, plan.tiles_x, width, height):
            px = xs.repeat(len(ys))
            py = ys.repeat_interleave(len(xs))
            live = _live(f, px, py).any(dim=1)
            assert bool(keep[k, s][live].all()), (t, s)
            kept += int(keep[k, s].sum())
            tested += len(k)
    # The cull does cut: about half the pairs go, and entries past the
    # last tile's segment (decode_cull's culled slots) are never kept.
    assert 0 < kept < 0.7 * tested
    assert not bool(keep[int(ends[-1]):].any())


@pytest.mark.parametrize("width,height,seed", SHAPES)
def test_walk_over_kept_entries_is_exact(width, height, seed):
    args, _ = _edge_case_stream(width, height, seed)
    keep = CR.fwd_subtile_keep(*args)
    img, stop, _ = CR._plain_forward(*args, True, False, keep)
    img_p, stop_p = CR.composite_train_fwd_plain(*args)
    assert float(img_p[0].max()) > 0.9
    assert torch.equal(img, img_p)
    assert torch.equal(img, CR.composite_fwd_plain(*args))
    assert torch.equal(stop, stop_p)


@pytest.mark.parametrize("width,height,seed", SHAPES)
def test_fwd_block_steps_matches_brute_force(width, height, seed):
    args, plan = _edge_case_stream(width, height, seed)
    skeys, starts, ends, feat, rank_bits = args[:5]
    kept, walked, visited = CR.fwd_block_steps(*args)

    keep = CR.fwd_subtile_keep(*args)
    _, stop = CR.composite_train_fwd_plain(*args)
    rank = skeys & ((1 << rank_bits) - 1)
    want_kept = want_walked = want_visited = 0
    for t in range(plan.t_total):
        s0, s1 = int(starts[t]), int(ends[t])
        k = torch.arange(s0, s1)
        f = feat[rank[k]]
        for s, xs, ys in _subtiles(t, plan.tiles_x, width, height):
            want_walked += s1 - s0
            want_kept += int(keep[k, s].sum())
            px = xs.repeat(len(ys))
            py = ys.repeat_interleave(len(xs))
            live = _live(f, px, py)                           # (K, P)
            st = stop[py.long(), px.long()].long() - s0       # (P,)
            # A pixel walks up to and including the first live entry at or
            # past its stop (the one that would take T under the floor).
            after = live & (torch.arange(s1 - s0)[:, None] >= st[None, :])
            end = torch.where(after.any(dim=0),
                              after.int().argmax(dim=0) + 1,
                              torch.full_like(st, s1 - s0))
            walk = torch.arange(s1 - s0)[:, None] < end[None, :]
            want_visited += int((walk & keep[k, s][:, None]).sum())
    assert (kept, walked, visited) == (want_kept, want_walked, want_visited)
    assert 0 < visited < kept * SUB * SUB
