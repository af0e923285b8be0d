"""Times the prof_scan probe: a chain of row prefix scans in one kernel.

Counterpart of scripts/prof_scan.py: for each kind of scan (matmul,
cumsum, roll), one launch of the probe kernel runs STEPS scans of a
(P, C) = (1024, 128) float32 block of 0.001s (ops/scan_probe.py,
csrc/scan_probe.cu) and the time per scan is printed; then the same loop
in plain PyTorch with torch.cumsum, as a library yardstick. Times come
from CUDA events around REPS launches (loops) after two of warm-up, queued
behind a spin on the card (utils/cuda_timing), so that a launch shorter
than its Python wrapper is timed on the card and not on the host.

    python -m wheat3dgs_tpu_torch.apps.prof_scan [--device cpu]

With --device cpu the probe runs its plain version on the host clock.
Returns {kind: us per scan, "torch.cumsum loop": us per scan}.
"""

from __future__ import annotations

import sys
import time
from argparse import ArgumentParser

import torch

from .. import resolve_device
from ..ops.scan_probe import KINDS, scan_probe
from ..utils.cuda_timing import cuda_time_ms

P, C, STEPS = 1024, 128, 256
REPS = 5


def cumsum_loop(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The probe's loop with torch.cumsum as the scan (the yardstick)."""
    for _ in range(steps):
        s = torch.cumsum(x, dim=1)
        x = s * (1.0 / torch.clamp(s.abs().max(), min=1.0))
    return x


def time_us_per_scan(fn, device: torch.device) -> float:
    """Microseconds per scan of `fn` (STEPS scans a call): on the card
    REPS timed calls; on the host one, after one warm-up call."""
    if device.type == "cuda":
        return cuda_time_ms(fn, REPS) * 1e3 / STEPS
    fn()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e6 / STEPS


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    x = torch.full((P, C), 0.001, dtype=torch.float32, device=device)
    where = "" if device.type == "cuda" else ", cpu plain version"
    out = {}
    for kind in KINDS:
        out[kind] = time_us_per_scan(lambda: scan_probe(x, kind, STEPS),
                                     device)
        print(f"{kind:8s} {out[kind]:8.2f} us/scan ({P}x{C}{where})",
              flush=True)
    lib = "torch.cumsum loop"
    out[lib] = time_us_per_scan(lambda: cumsum_loop(x, STEPS), device)
    print(f"{lib} {out[lib]:8.2f} us/scan ({P}x{C})", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
