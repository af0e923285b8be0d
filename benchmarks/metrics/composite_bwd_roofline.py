"""composite_bwd_roofline (layer Kernels; moves train_it_s).

The least time of the backward replay (benchlib/work.py) over its mean
device time per call in the trace.
"""

from benchlib import work


def read(run):
    return work.kernel_roofline(run, "composite_bwd", r"composite_bwd_kernel")
