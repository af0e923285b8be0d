"""The backward's segment sum, plain version against the JAX package's.

`segsum_plain` (what the `segsum` kernel is held to on the card, and what
the wrapper runs for a CPU tensor) against `_segment_sum_sorted`, the
function around the TPU's `_segsum_kernel` (run with interpret=True), on
the seeded layouts of the card tests (`segment_layout`): 1024-slot
segments, runs of empty ranks, ranks clipped at the budget, blocks whose
span starts off a 16-byte boundary, at 1, 10 and 15 columns. Tolerance:
1e-5 of each column's max |value| (float64 running sums against float32
mask matmuls).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import SEGMENT_KINDS, segment_layout

from wheat3dgs_tpu.ops.pallas_raster import _segment_sum_sorted
from wheat3dgs_tpu_torch.ops import cuda_raster as CR


@pytest.mark.parametrize("cols", [1, 10, 15])
@pytest.mark.parametrize("kind", SEGMENT_KINDS)
def test_segsum_plain_matches_jax(kind, cols):
    seg_start, seg_end, e = segment_layout(kind)
    n = seg_start.shape[0]
    vals = np.random.default_rng(1).normal(size=(e, cols)).astype(np.float32)
    ref = np.asarray(_segment_sum_sorted(jnp.asarray(vals.T),
                                         jnp.asarray(seg_end), n,
                                         interpret=True))
    args = (torch.as_tensor(vals), torch.as_tensor(seg_start),
            torch.as_tensor(seg_end))
    got = CR.segsum_plain(*args)
    assert torch.equal(CR.segsum(*args), got)
    assert got.shape == ref.shape == (n, cols)
    scale = np.abs(ref).max(axis=0)
    assert (scale > 0).all()
    assert float((np.abs(got.numpy() - ref) / scale).max()) < 1e-5
    # Empty ranks, those past the budget among them, sum to exact zeros.
    empty = seg_end == seg_start
    assert empty.any()
    assert not got.numpy()[empty].any()
