"""`bwd_warp_steps`, the count of the backward replay's work per warp that
chip_smoke.py reports beside composite_bwd's time, against a brute-force
count: for every tile row (one warp of 32 pixels) and every entry up to the
row's largest stop, whether some pixel of the row has a live pair (power
<= 0, alpha = min(0.99, o e^power) >= 1/255) before its stop. Exact.
"""

import numpy as np
import pytest
import torch
from test_torch_kernels import _stream

from wheat3dgs_tpu_torch.ops import cuda_raster as CR


@pytest.mark.parametrize("seed,big", [(2, 40), (5, 0)])
def test_bwd_warp_steps_matches_brute_force(seed, big):
    width, height = 131, 77
    plan, skeys, starts, ends, _, feat = _stream(
        torch.device("cpu"), n=1500, width=width, height=height, seed=seed,
        big=big)
    _, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                     plan.rank_bits, width, height)
    live, walked = CR.bwd_warp_steps(skeys, starts, ends, feat, stop,
                                     plan.rank_bits, width, height)

    rank = (skeys & ((1 << plan.rank_bits) - 1)).numpy()
    f, st = feat.numpy().astype(np.float64), stop.numpy()
    s_t, e_t = starts.numpy(), ends.numpy()
    want_live = want_walked = 0
    for t in range(plan.t_total):
        x0 = (t % plan.tiles_x) * CR.TILE_PX
        y0 = (t // plan.tiles_x) * CR.TILE_PX
        xs = np.arange(x0, min(x0 + CR.TILE_PX, width))
        for y in range(y0, min(y0 + CR.TILE_PX, height)):
            stops = st[y, xs]
            want_walked += max(0, int(stops.max()) - int(s_t[t]))
            for k in range(s_t[t], min(int(stops.max()), e_t[t])):
                x, yy, a, b, c, o = f[rank[k], :6]
                dx, dy = xs - x, y - yy
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = np.minimum(0.99, o * np.exp(power))
                want_live += bool(((power <= 0) & (alpha >= 1 / 255)
                                   & (k < stops)).any())
    assert walked == want_walked > 0
    assert live == want_live > 0
    assert live < walked
