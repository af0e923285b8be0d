"""step_mfu.train (layer Step; moves train_it_s).

The operations a training step needs (benchlib/work.py, counted from the
sampled states and views of the traced window), times the plot-iterations
per second of the window, over the H100's float32 peak.
"""

from benchlib import work


def read(run):
    if not run["work"] or not run["trace"]:
        return None
    ops = sum(work.step_ops(w["weighted"], w["alive"], w["pixels"],
                            w["sh_degree"]) for w in run["work"])
    per_it = ops / len(run["work"])
    rate = run["plot_iterations"] / run["window_s"]
    return 100.0 * per_it * rate / work.PEAK_FLOPS
