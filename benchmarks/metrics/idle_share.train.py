"""idle_share.train (layer Device; moves train_it_s).

The share of the traced window in which no activity runs on the card: one
minus the union of the device's kernels, copies and sets in the
torch.profiler trace over the window's length.
"""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
