"""The benchmark's harness: scene generation (scene.py), the program's
training drivers (drive.py), the check against the reference (check.py),
the work counts (work.py), the trace's reading (tracing.py) and one run of
a cell (harness.py)."""
