"""capture_share.train (layer Graph runner; moves train_it_s).

The seconds the program's StepGraph spent capturing its step during the
window (`StepGraph.capture_seconds` of the captures made there) over the
window's seconds.
"""


def read(run):
    return 100.0 * sum(run["captures_s"]) / run["window_s"]
