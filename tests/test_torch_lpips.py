"""The port's LPIPS (wheat3dgs_tpu_torch/ops/lpips.py) against the JAX
package's (wheat3dgs_tpu/ops/lpips.py).

- synthesize_lpips_weights writes the same arrays as JAX's, for every net
  (both draw from np.random.default_rng(seed) in one order): exactly.
- The distance on the same weights file and the same seeded images, at
  64x64 and at 75x67 (an odd size: SqueezeNet's ceil-mode pools keep a
  partial last window; AlexNet's 11x11 stride-4 conv needs >= 63 px), for
  one pair, a batch of one and a batch of two (against JAX per pair):
  within 1e-5 relative (float32 convolutions summed in another order).
- SqueezeNet's pool, F.max_pool2d(3, 2, ceil_mode=True), against JAX's
  right/bottom-padded reduce_window at sizes whose remainder is nonzero:
  exactly.
- is_untrained and _detect_net as JAX's, with and without the markers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wheat3dgs_tpu.ops import lpips as JL
from wheat3dgs_tpu_torch.ops import lpips as TL

NETS = ["vgg", "alex", "squeeze"]
REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small convolutions, many test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips_w")
    paths = {}
    for net in NETS:
        paths[net] = str(root / f"{net}.npz")
        TL.synthesize_lpips_weights(paths[net], net, seed=0)
    return paths


@pytest.mark.parametrize("net", NETS)
def test_synthesized_weights_equal_jax(net, weights, tmp_path):
    ref = str(tmp_path / "jax.npz")
    JL.synthesize_lpips_weights(ref, net, seed=0)
    a, b = dict(np.load(weights[net])), dict(np.load(ref))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    other = str(tmp_path / "seed1.npz")
    TL.synthesize_lpips_weights(other, net, seed=1)
    assert not np.array_equal(np.load(other)["features.0.weight"],
                              a["features.0.weight"])


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, np.float32)
    y = np.clip(x + rng.normal(0, 0.15, shape).astype(np.float32), 0, 1)
    return x, y


@pytest.mark.parametrize("size", [(64, 64), (75, 67)])
@pytest.mark.parametrize("net", NETS)
def test_lpips_matches_jax(net, size, weights):
    h, w = size
    j_fn = JL.load_lpips(weights[net])
    t_fn = TL.load_lpips(weights[net], device="cpu")
    assert t_fn.net == net
    x, y = _pair((2, 3, h, w), seed=h + w)
    want = [float(j_fn(jnp.asarray(x[i]), jnp.asarray(y[i])))
            for i in range(2)]
    assert all(v > 0 for v in want)
    one = t_fn(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    assert one.shape == ()
    assert float(one) == pytest.approx(want[0], rel=REL)
    batch1 = t_fn(torch.from_numpy(x[:1]), torch.from_numpy(y[:1]))
    assert batch1.shape == ()
    assert float(batch1) == pytest.approx(
        float(j_fn(jnp.asarray(x[:1]), jnp.asarray(y[:1]))), rel=REL)
    batch2 = t_fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert batch2.shape == (2,)
    np.testing.assert_allclose(batch2, want, rtol=REL, atol=0)
    assert float(t_fn(torch.from_numpy(x[0]), torch.from_numpy(x[0]))) == \
        pytest.approx(0.0, abs=1e-8)


@pytest.mark.parametrize("hw", [(30, 30), (31, 24), (16, 10)])
def test_ceil_pool_matches_jax(hw):
    x = np.random.default_rng(hw[0]).normal(
        size=(2, 5, *hw)).astype(np.float32)
    assert (hw[0] - 3) % 2 or (hw[1] - 3) % 2
    want = np.asarray(JL._maxpool(jnp.asarray(x), k=3, s=2, ceil=True))
    got = F.max_pool2d(torch.from_numpy(x), 3, 2, ceil_mode=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net", NETS)
def test_untrained_flag_and_net_detection(net, weights, tmp_path):
    data = dict(np.load(weights[net]))
    assert TL.is_untrained(weights[net]) is JL.is_untrained(weights[net]) \
        is True
    assert TL._detect_net(data) == JL._detect_net(data) == net
    # Without the markers (a converted checkpoint): the keys decide, and
    # the file counts as trained.
    bare = {k: v for k, v in data.items() if not k.startswith("__")}
    path = str(tmp_path / "bare.npz")
    np.savez(path, **bare)
    assert TL.is_untrained(path) is JL.is_untrained(path) is False
    assert TL._detect_net(bare) == JL._detect_net(bare) == net
