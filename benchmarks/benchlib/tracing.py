"""The traced run's readings from torch.profiler and the benchmark's own
host spans.

Spans are `record_function` ranges named "bench/<label>" around each
block, so they sit on the profiler's clock beside
the device's activities. `summarize` reads the profiler's raw events once:
the union of every device activity (kernels, copies, sets) over the traced
window gives busy_s; each kernel name's time and call count; the longest
idle gaps of the union, each named by the span open at its middle.
"""

from __future__ import annotations

import bisect
import collections
import re

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN = "bench/"


def start():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def span(kind: str):
    return record_function(SPAN + kind)


def summarize(prof, label=str, top: int = 10) -> dict:
    """busy_s, window_s, per-kernel (seconds, calls) and the breakdown's
    two lists from a stopped profiler; `label` names a gap from the label
    of the span open at its middle."""
    dev_ev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The spans' mirrors on the device's timeline are no work.
            if e.duration_ns() > 0 and not e.name().startswith(SPAN):
                dev_ev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()))
        elif e.name().startswith(SPAN):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()[len(SPAN):]))
    if not dev_ev or not spans:
        return {}
    t0 = min(s[0] for s in spans)
    t1 = max(s[1] for s in spans)
    dev_ev.sort()
    busy = 0
    gaps = []
    cur_s, cur_e = None, None
    by_name = collections.defaultdict(lambda: [0, 0])
    for s, e, name in dev_ev:
        by_name[name][0] += e - s
        by_name[name][1] += 1
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            elif s > t0:
                gaps.append((s - t0, t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if t1 > cur_e:
            gaps.append((t1 - cur_e, cur_e, t1))
    spans.sort()
    starts = [s[0] for s in spans]

    def open_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            return label(spans[i][2])
        return "between_blocks"

    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    merged = collections.defaultdict(float)
    for k, v in ops:
        merged[short_name(k)] += v[0] / 1e9
    ops = sorted(merged.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": {k: (v[0] / 1e9, v[1]) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [[open_at((a + b) // 2), g / 1e9]
                          for g, a, b in gaps[:top]],
        },
    }


def short_name(name: str) -> str:
    """A device op's name without its return type, anonymous namespaces and
    argument list, at most 160 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160]


def kernel_time(kernels: dict, pattern: str):
    """(seconds, calls) of the kernels whose name matches `pattern`."""
    rx = re.compile(pattern)
    secs = calls = 0
    for name, (s, n) in kernels.items():
        if rx.search(name):
            secs += s
            calls += n
    return secs, calls
