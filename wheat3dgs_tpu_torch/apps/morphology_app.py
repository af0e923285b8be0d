"""Wheat-head morphology CLI (reference: wheatheadsmorphology/main.py).

Counterpart of the root `wheatheadsmorphology/main.py`:

    python -m wheat3dgs_tpu_torch.apps.morphology_app -c config.yaml \
        [--device cuda|cpu]

The JAX CLI defaults `-c` to the config.yaml beside its own file; the
port ships no config, so `-c` is required. The clusterers' and SOR's
distance work runs on `--device` (default cuda; raises without a card
unless asked for cpu).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .. import resolve_device
from ..morphology import load_config, run_pipeline


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Run the wheat-head morphology pipeline")
    p.add_argument("-c", "--config", type=Path, required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu on request)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return run_pipeline(load_config(args.config), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
