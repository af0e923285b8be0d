"""schedule_share.train (layer Schedule; moves train_it_s).

The share of the traced window spent beyond each block's steps at the
window's median replayed step time, over the blocks the schedule makes
costly: those that end at a densify, those that captured their step again
(after a densify, an SH change or a budget rung) and single eager steps.
Reads the benchmark's synchronised host spans around each block.
"""

import statistics


def read(run):
    plain = [s / k for k, kind, s in run["blocks"] if kind == "replayed"]
    if not plain:
        return None
    per_step = statistics.median(plain)
    extra = sum(max(0.0, s - k * per_step) for k, kind, s in run["blocks"]
                if kind != "replayed")
    return 100.0 * extra / run["window_s"]
