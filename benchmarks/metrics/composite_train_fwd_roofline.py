"""composite_train_fwd_roofline (layer Kernels; moves train_it_s).

The least time of the training forward compositor (benchlib/work.py: the
weighted pairs' operations or the bytes its inputs and outputs need,
whichever bounds) over its mean device time per call in the trace.
"""

from benchlib import work


def read(run):
    return work.kernel_roofline(run, "composite_train_fwd",
                                r"composite_fwd_kernel<\d+, true")
