"""The prof_scan probe: a chain of row prefix scans over one block, with
its CUDA kernel (csrc/scan_probe.cu).

Counterpart of scripts/prof_scan.py::make(kind), the micro-benchmark of
the compositors' lane-axis prefix scan: `steps` times over a (rows, 128)
float32 block, s = each row's inclusive prefix sum along its 128 values,
then x = s * (1 / max(1, max |s|)) with the max over the whole block.
Three kinds compute the scan: "matmul" (the product with the 0/1
upper-triangular matrix), "cumsum" (a running sum) and "roll" (7
log-shift roll-and-add steps).

`scan_probe` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import launch

KINDS = ("matmul", "cumsum", "roll")
LANES = 128          # values per row (the TPU block's lane width)
ROWS_PER_BLOCK = 8   # the kernel's rows per block (one warp each)


def _step(x: torch.Tensor, kind: str) -> torch.Tensor:
    c = x.shape[1]
    if kind == "matmul":
        idx = torch.arange(c, device=x.device)
        tri = (idx[:, None] <= idx[None, :]).to(x.dtype)
        s = x @ tri
    elif kind == "cumsum":
        s = torch.cumsum(x, dim=1)
    elif kind == "roll":
        s = x
        lane = torch.arange(c, device=x.device)[None, :]
        k = 1
        while k < c:
            s = s + torch.where(lane >= k, torch.roll(s, k, 1),
                                torch.zeros_like(s))
            k *= 2
    else:
        raise ValueError(f"unknown scan kind {kind!r} (one of {KINDS})")
    return s * (1.0 / torch.clamp(s.abs().max(), min=1.0))


def scan_probe_plain(x: torch.Tensor, kind: str, steps: int) -> torch.Tensor:
    """Plain PyTorch version: the probe's loop, one step at a time."""
    for _ in range(steps):
        x = _step(x, kind)
    return x


def scan_probe(x: torch.Tensor, kind: str, steps: int) -> torch.Tensor:
    """(rows, 128) float32 -> the block after `steps` scans of `kind`."""
    if kind not in KINDS:
        raise ValueError(f"unknown scan kind {kind!r} (one of {KINDS})")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if x.device.type == "cpu":
        return scan_probe_plain(x, kind, steps)
    if x.device.type != "cuda":
        raise ValueError(f"scan_probe: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"scan_probe: expected (rows, {LANES}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    rows = x.shape[0]
    if rows == 0 or rows % ROWS_PER_BLOCK:
        raise ValueError(f"scan_probe: rows must be a positive multiple of "
                         f"{ROWS_PER_BLOCK}, got {rows}")
    x = x.contiguous()
    out = torch.empty_like(x)
    # Per-block partial maxima of two consecutive steps.
    partial = torch.empty((2, rows // ROWS_PER_BLOCK), dtype=torch.float32,
                          device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch("scan_probe", [p, i, i, i, p, p],
           (x.data_ptr(), rows, KINDS.index(kind), steps,
            partial.data_ptr(), out.data_ptr()), x.device)
    return out
