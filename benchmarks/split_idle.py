"""Run one cell traced, with the program's own spans on, and split its idle
time by what the host was doing.

    python3 benchmarks/split_idle.py --workload <name> --seed <n> \
        --seconds <s>

from the root of a checkout, as run.py (always --trace 1). Prints run.py's
result line with a `split` record (benchlib/spans.py): the window's idle
share under the graph runner's, the step's and the schedule's spans and
under none (`idle_graph.train`, `idle_eager.train`, `idle_schedule.train`,
`idle_unspanned.train`, adding up to idle_share.train), the blocking reads
per 100 plot-iterations (`host_reads.train`), the idle seconds and the
seconds of each span; the breakdown's idle gaps carry the span open at
their middle. A program without the spans runs too: its idle time is then
all `idle_unspanned.train` and it counts no reads.
"""

import time

T_START = time.time()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import harness, spans  # noqa: E402


def main(argv) -> int:
    out = spans.run(argv, t_start=T_START)
    if out is None:
        return 2
    bad = harness.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
