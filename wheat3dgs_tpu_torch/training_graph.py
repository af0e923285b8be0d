"""Blocks of training steps replayed from a CUDA graph.

The port's counterpart of the `lax.scan` in wheat3dgs_tpu/training.py::
train_step_scan: K steps between two host touch points. The step is a few
hundred small launches (projection, SH, the prologue, the kernels, SSIM,
autograd, Adam), so on the card its host clock is several times its device
time; a graph records the step's launches once and replays them with one
host call.

`StepGraph` runs a step function K times. The step reads everything that
changes from step to step from device tensors that stay put (the caller's
table of view picks and scalars, a device counter it advances), so the
same launches serve every step of a block and every block that follows:
- on the CPU (only when the caller asks for it, as the tests do) it calls
  the step K times;
- on a CUDA device, when the key has changed (new state tensors, budget,
  SH degree or image size: anything whose address or shape the recorded
  launches bake in), it releases the stale graph, runs the block's first
  step eagerly on the capture stream (the warm-up capture asks for, a
  real step), captures one step and replays it for the rest of the block;
  with the key unchanged every step of the block is a replay. A capture
  that fails raises; nothing falls back to eager steps.

The kernels' launch counters (`ops/cuda_build.launches`) count a launch
when Python calls its wrapper, i.e. once at capture. The capture's counts
are taken back (the capture ran nothing) and added again on every replay,
so the counters stay true per executed step.

With the program's spans on (`utils/trace.py`) a run records
"graph.release" where a graph is dropped, "graph.warmup" around the eager
warm-up step, "graph.capture" around what `capture_seconds` times and
"graph.replay" around the replays.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Hashable, List

import torch

from .ops import cuda_build
from .utils import trace


class StepGraph:
    """One live CUDA graph of a step function, keyed by what it bakes in.
    Counts its captures, the seconds each took (warm-up step excluded) and
    its replays."""

    def __init__(self):
        self.graph = None
        self.key = None
        self.per_replay: dict = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds: List[float] = []

    def release(self) -> None:
        """Drop the graph (and with it its private memory pool)."""
        if self.graph is not None:
            with trace.span("graph.release"):
                self.graph = None
        self.key = None
        self.per_replay = {}

    def run(self, step: Callable[[], None], n: int, key: Hashable,
            device: torch.device) -> None:
        """Run `step` n times: eagerly on the CPU, from the graph keyed
        `key` on a CUDA device (capturing it first on a miss)."""
        if device.type != "cuda":
            for _ in range(n):
                step()
            return
        done = 0
        if self.graph is None or key != self.key:
            self.release()
            self._capture(step, device)
            self.key = key
            done = 1
        with trace.span("graph.replay"):
            for _ in range(n - done):
                self.graph.replay()
        replays = n - done
        self.replays += replays
        for k, c in self.per_replay.items():
            cuda_build.launches[k] += c * replays

    def _capture(self, step: Callable[[], None], device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with trace.span("graph.warmup"), torch.cuda.stream(side):
            step()                      # the warm-up: a real step
        with trace.span("graph.capture"):
            t0 = time.perf_counter()
            before = dict(cuda_build.launches)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side):
                    step()
            finally:
                counted = dict(cuda_build.launches)
                cuda_build.launches.update(before)  # the capture ran nothing
            torch.cuda.current_stream(device).wait_stream(side)
            self.per_replay = {k: counted[k] - before[k] for k in before
                               if counted[k] != before[k]}
            self.graph = graph
            self.captures += 1
            self.capture_seconds.append(time.perf_counter() - t0)


@contextlib.contextmanager
def eager_steps():
    """Run every StepGraph's steps one by one, on any device, for the
    duration: the kernels' plain versions read the host, so an all-plain
    run on the card cannot be captured."""
    saved = StepGraph.run

    def run(self, step, n, key, device):
        for _ in range(n):
            step()

    StepGraph.run = run
    try:
        yield
    finally:
        StepGraph.run = saved
