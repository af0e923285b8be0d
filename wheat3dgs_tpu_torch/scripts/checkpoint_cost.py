"""What the checkpoint writes cost a training run, from its metrics.jsonl.

    python wheat3dgs_tpu_torch/scripts/checkpoint_cost.py MODEL/metrics.jsonl \
        [--every 1000]

train_vanilla logs a line every 100 iterations with the rate of that
window; a checkpoint written after iteration c lands in the window that
ends at c + 100. Its cost is that window's time less the median of the
windows ending at c, c + 200 and c + 300 (the same densify schedule, no
write). Prints one JSON object: each checkpoint's excess in seconds, their
sum and median, and the logged windows' total time.
"""

from __future__ import annotations

import json
import sys
from argparse import ArgumentParser

import numpy as np


def checkpoint_cost(rows: list, every: int = 1000) -> dict:
    times = {r["iter"]: (r["iter"] - p["iter"]) / r["iters_per_sec"]
             for p, r in zip(rows, rows[1:]) if "iters_per_sec" in r}
    step = rows[1]["iter"] - rows[0]["iter"] if len(rows) > 1 else 100
    excess = {}
    for c in range(every, rows[-1]["iter"], every):
        near = [times[i] for i in (c, c + 2 * step, c + 3 * step)
                if i in times]
        if c + step in times and near:
            excess[c] = times[c + step] - float(np.median(near))
    return {"excess_s": excess, "sum_s": sum(excess.values()),
            "median_s": float(np.median(list(excess.values())))
            if excess else 0.0,
            "windows_s": sum(times.values()), "windows": len(times)}


def main(argv=None) -> dict:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("metrics")
    parser.add_argument("--every", type=int, default=1000)
    args = parser.parse_args(argv)
    with open(args.metrics) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    rows = [r for r in rows if "iters_per_sec" in r]
    out = checkpoint_cost(rows, args.every)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
