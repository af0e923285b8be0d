"""Kernel timing on the card and the roofline bounds the timings are held to.

Used by the profiling apps (`apps/prof_scan.py`, `apps/profile_*.py`) and
by `chip_smoke.py`; nothing on a user's path calls it.

`cuda_time_ms` times calls with CUDA events and queues them behind a spin
of ~10 ms on the card, so the events time the card's work and not the
host's enqueueing (a short kernel's Python wrapper takes tens of
microseconds). `graphed` captures a call as a CUDA graph, to time a chain
of library calls without the host's launches between them.
"""

from __future__ import annotations

import subprocess

import torch

# Card clock cycles of the spin that timed launches queue behind.
SPIN_CYCLES = 20_000_000

# H100 SXM published peaks (NVIDIA data sheet), used for the bound columns.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """The card's time per call of fn: CUDA events around `reps` calls,
    after `warmup` calls, queued behind the spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graphed(fn):
    """fn captured once as a CUDA graph (after two warm-up calls on a side
    stream, as capture asks); returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def bound(bytes_moved: float, flops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the float32 peak."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_bound(entries, t_total, feat_numel, nv, w, h, visited, weighted):
    """composite_fwd's bound: the live keys, tile bounds, feature table and
    image; 14 ops per visited (pixel, entry) pair, 4 + 2 (1 + nv) per
    weighted pair."""
    return bound(entries * 8 + t_total * 8 + feat_numel * 4
                 + (1 + nv) * w * h * 4,
                 visited * 14 + weighted * (4 + 2 * (1 + nv)))


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi rc {out.returncode}: "
                           f"{out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
