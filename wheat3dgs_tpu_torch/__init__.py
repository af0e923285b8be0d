"""wheat3dgs_tpu_torch — the PyTorch/CUDA port of wheat3dgs_tpu for NVIDIA
Hopper (H100).

The JAX package `wheat3dgs_tpu` is the reference: this package keeps its
module names, on-disk formats and numerics, and imports nothing from it.
Every Pallas kernel the JAX package runs on the TPU becomes a hand-written
CUDA kernel here (`csrc/`, bound in `ops/cuda_raster.py`), each with a plain
PyTorch version beside it that the CPU tests use.

Conventions:
- float32 throughout, never TF32. Matmuls: this package leaves
  `torch.backends.cuda.matmul.allow_tf32` at its default (False), so
  projection's `hom @ w2c.T` is exact float32 as in the JAX reference
  (`ops/projection.py`). Convolutions: SSIM's blur is a depthwise
  `conv2d` (`ops/losses.py`), and cuDNN runs float32 convolutions in TF32
  by default, so importing the package sets
  `torch.backends.cudnn.allow_tf32 = False`.
- The device is explicit. Entry points take `device` (`--device` on the
  CLI), default "cuda", and raise when no card is present and the caller
  did not ask for "cpu". There is no silent CPU fallback.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
