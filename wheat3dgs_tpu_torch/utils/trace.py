"""The program's own spans and counters, for a profiler that the caller runs.

Spans name what the host is doing at the training loop's boundaries
(`training.Trainer`, `training_graph.StepGraph`), so that a trace of the
device's idle time can say which host work it waited on. The caller that
runs `torch.profiler` switches them on with `on()` after the profiler
starts and off with `off()` before it stops (the training CLI's
`--profile`; `benchmarks/split_idle.py`):

- `span(name)` is one shared `contextlib.nullcontext()` while the switch
  is off (a flag check), and a `torch.profiler.record_function` range named
  "w3dgs/<name>" while it is on: the range sits on the profiler's clock,
  inside whatever range contains it. Spans live in the profiler's memory
  until it stops; nothing here writes a file or keeps a clock of its own.
- `count(name, n)` always counts, into a process-wide dict that
  `counters()` copies: `host_reads` counts the training path's blocking
  device-to-host reads.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

PREFIX = "w3dgs/"

_on = False
_off_span = contextlib.nullcontext()
_counts: Dict[str, int] = {}


def on() -> None:
    """Record spans from now on (call after the profiler starts)."""
    global _on
    _on = True


def off() -> None:
    """Stop recording spans (call before the profiler stops)."""
    global _on
    _on = False


def span(name: str):
    """A context manager around one boundary's work: the profiler's range
    "w3dgs/<name>" while spans are on, else the shared null context."""
    if not _on:
        return _off_span
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counts)
