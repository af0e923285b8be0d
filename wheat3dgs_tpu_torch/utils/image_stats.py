"""Texture statistics and PSNR of RGB images (numpy, values in [0, 1]).

They tell which of two ground truths an image was rendered against: the
mean absolute step between horizontal neighbours and the mean standard
deviation inside 8x8 blocks both grow with a scene's per-point colour
noise (io/synthetic.py's color_noise), while PSNR counts every pixel.
"""

from __future__ import annotations

import numpy as np

BLOCK = 8


def unit(img) -> np.ndarray:
    """An 8-bit (H, W, 3) image as float64 in [0, 1]."""
    return np.asarray(img, np.float64) / 255.0


def as_png(img) -> np.ndarray:
    """A float (H, W, 3) image quantized as the generator and render_sets
    write it (clip, scale by 255, truncate), back in [0, 1]."""
    return unit((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))


def h_step(img: np.ndarray) -> float:
    """Mean absolute difference of horizontally adjacent pixels."""
    return float(np.abs(np.diff(img, axis=1)).mean())


def block_std(img: np.ndarray, block: int = BLOCK) -> float:
    """Mean over channels and block x block tiles of the tile's standard
    deviation (edge rows and columns past a whole tile are dropped)."""
    h, w = (img.shape[0] // block) * block, (img.shape[1] // block) * block
    tiles = img[:h, :w].reshape(h // block, block, w // block, block, -1)
    return float(tiles.std(axis=(1, 3)).mean())


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """ops/losses.psnr of two (H, W, 3) images."""
    import torch

    from ..ops.losses import psnr as psnr_t

    return float(psnr_t(torch.from_numpy(a), torch.from_numpy(b)))


def texture(img: np.ndarray) -> dict:
    return {"h_step": h_step(img), "block_std": block_std(img)}
