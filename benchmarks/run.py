"""Run one cell of the benchmark of the PyTorch/CUDA port, once.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (`wheat3dgs_tpu_torch/`)
and `BENCHMARK.json`. Prints one JSON line on stdout (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1)
and each compared number beside its limit as the last lines of stderr.
Exits non-zero, printing no result, without enough CUDA devices or when
JAX or the JAX package was loaded. See benchlib/harness.py.
"""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
