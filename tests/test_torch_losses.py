"""Parity of the port's losses and metrics (wheat3dgs_tpu_torch.ops.losses)
with the JAX package's (wheat3dgs_tpu/ops/losses.py).

Seeded numpy images go to both. Tolerances: values within rel 1e-5
(float32, another summation order; SSIM's blur is a depthwise conv2d here
and a shift-and-add there), and the SSIM gradient within 1e-4 of its max
|g| (autograd through the conv2d blur here, JAX's analytic backward
there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu.ops import losses as JL
from wheat3dgs_tpu_torch.ops import losses as TL


def _images(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    # b: a noisy, blurred-ish copy so SSIM is neither 0 nor 1.
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(3, 37, 50), (2, 3, 24, 31)])
def test_values_match_jax(shape):
    a, b = _images(shape)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("l1_loss", "l2_loss", "mse", "psnr"):
        got = getattr(TL, name)(ta, tb).numpy()
        want = np.asarray(getattr(JL, name)(ja, jb))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    for avg in (True, False):
        got = TL.ssim(ta, tb, size_average=avg).numpy()
        want = np.asarray(JL.ssim(ja, jb, size_average=avg))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(TL.photometric_loss(ta, tb)) == pytest.approx(
        float(JL.photometric_loss(ja, jb)), rel=1e-5)
    # Identical images: SSIM 1.
    assert float(TL.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = _images((3, 29, 41), seed=1)
    want = np.asarray(jax.grad(lambda x: JL.ssim(x, jnp.asarray(b)))(
        jnp.asarray(a)))
    ta = torch.tensor(a, requires_grad=True)
    got = torch.autograd.grad(TL.ssim(ta, torch.tensor(b)), ta)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_photometric_loss_gradient_matches_jax():
    a, b = _images((3, 20, 26), seed=2)
    want = np.asarray(jax.grad(
        lambda x: JL.photometric_loss(x, jnp.asarray(b), 0.2))(
            jnp.asarray(a)))
    ta = torch.tensor(a, requires_grad=True)
    got = torch.autograd.grad(TL.photometric_loss(ta, torch.tensor(b), 0.2),
                              ta)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
