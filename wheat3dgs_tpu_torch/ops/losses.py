"""Training losses and image metrics (reference: utils/loss_utils.py,
utils/image_utils.py).

Counterpart of wheat3dgs_tpu/ops/losses.py. SSIM uses the reference's
11-tap Gaussian window (sigma 1.5) as a separable depthwise blur with SAME
zero padding, and C1 = 0.01^2, C2 = 0.03^2 (utils/loss_utils.py:23-63).
The blur is two depthwise `conv2d` calls (an 11x1 then a 1x11 window);
the package turns cuDNN's TF32 off (`wheat3dgs_tpu_torch/__init__.py`), so
they run in float32. Its gradient is autograd's through the same
convolutions: the JAX package's analytic SSIM backward
(losses.py:90-134) is an optimisation of XLA's shift-and-add transpose on
the TPU and gives the same gradient. Images are (C, H, W) or (B, C, H, W)
in [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()


def mse(pred, gt):
    """Per-image mean squared error: (B,) for (B, C, H, W), (1,) else."""
    b = pred.shape[0] if pred.dim() == 4 else 1
    return ((pred - gt) ** 2).reshape(b, -1).mean(-1)


def psnr(pred, gt):
    """PSNR per image; inputs (C, H, W) -> scalar or (B, C, H, W) -> (B,),
    in [0, 1] (reference: utils/image_utils.py:17-19)."""
    out = 20.0 * torch.log10(1.0 / torch.sqrt(mse(pred, gt)))
    return out if pred.dim() == 4 else out[0]


def _gaussian_window(window_size: int, sigma: float,
                     device) -> torch.Tensor:
    """The normalised window, computed in float64 on `device` and cast
    once: no host-to-device copy, which a CUDA graph capture of the
    training step would refuse."""
    xs = torch.arange(window_size, dtype=torch.float64,
                      device=device) - window_size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).to(torch.float32)


def _depthwise_blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable depthwise blur of (B, C, H, W), SAME zero padding."""
    c = img.shape[1]
    taps = window.shape[0]
    pad = taps // 2
    kh = window.reshape(1, 1, taps, 1).expand(c, 1, taps, 1)
    kw = window.reshape(1, 1, 1, taps).expand(c, 1, 1, taps)
    out = F.conv2d(img, kh, padding=(pad, 0), groups=c)
    return F.conv2d(out, kw, padding=(0, pad), groups=c)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int) -> torch.Tensor:
    window = _gaussian_window(window_size, 1.5, img1.device)
    mu1 = _depthwise_blur(img1, window)
    mu2 = _depthwise_blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity, matching the reference's windowed SSIM.
    (C, H, W) or (B, C, H, W); size_average=True -> the mean over
    everything, else per image."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    m = _ssim_map(img1, img2, window_size)
    if size_average:
        return m.mean()
    out = m.mean(dim=(1, 2, 3))
    return out[0] if squeeze else out


def photometric_loss(pred, gt, lambda_dssim: float = 0.2):
    """(1-λ)·L1 + λ·(1-SSIM) — the 3DGS training loss
    (reference: train_vanilla_3dgs.py:74-76)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))
