"""The program's own spans in a traced run: the window's idle time split
by what the host was doing.

The port names its host work at the schedule's, the step's and the graph
runner's boundaries (`wheat3dgs_tpu_torch/utils/trace.py`: profiler
ranges "w3dgs/<name>", switched on by whoever runs the profiler) and
counts its blocking reads (`host_reads`). `summarize` reads a stopped
profiler as `tracing.summarize` does, with the program's ranges left out
of the device's activity, so every key it shares reads as without them (a
range's mirror on the device's timeline spans the kernels launched inside
it, gaps included, and would count as busy). It adds:

- `idle_by_span`: the seconds of the window's idle time (the complement of
  the union of device activity that gives busy_s) under each innermost
  program span open over them, by exact intersection of intervals, and
  under none (`NONE`); they add up to window_s - busy_s;
- `spans`: each program span name's seconds and count in the trace;
- the breakdown's idle gaps named "<block kind>/<span open at the gap's
  middle>" where a program span is open there, else as before.

`layers` turns `idle_by_span` into the per-layer metrics this split
defines, which add up to idle_share.train. `run` is harness.run with the
program's spans on over the traced window and this `summarize` in
`tracing.summarize`'s place, from the outside (see split_idle.py): the
harness runs, unchanged, a program with spans and one without (whose
idle time is then all NONE).
"""

from __future__ import annotations

import bisect
import collections

import torch

from . import tracing

PROGRAM = "w3dgs/"
NONE = "unspanned"
# The per-layer metrics of the split: each program span's layer.
LAYERS = {
    "idle_graph.train": ("graph.capture", "graph.release", "graph.replay"),
    "idle_eager.train": ("graph.warmup", "train.eager_step"),
    "idle_schedule.train": ("train.densify", "train.grow_capacity",
                            "train.occupancy", "train.watchdog"),
    "idle_unspanned.train": (NONE,),
}


def innermost(spans: list, t0: int, t1: int) -> list:
    """[(a, b, name)] covering [t0, t1]: over each piece, the name of the
    program span opened last among those open (the innermost, as spans of
    one thread nest), None where none is open."""
    marks = []
    for i, (s, e, _) in enumerate(spans):
        if e > s:                       # an empty span covers nothing
            marks.append((s, 1, -e, i))
            marks.append((e, 0, 0, i))
    marks.sort()
    segs, open_, prev = [], [], t0
    for t, opens, _, i in marks:
        t = min(max(t, t0), t1)
        if t > prev:
            segs.append((prev, t, spans[open_[-1]][2] if open_ else None))
            prev = t
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
    if t1 > prev:
        segs.append((prev, t1, spans[open_[-1]][2] if open_ else None))
    return segs


def idle_by_span(idle: list, segs: list) -> dict:
    """Nanoseconds of the `idle` intervals under each segment's name (NONE
    for None)."""
    out = collections.defaultdict(int)
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2] or NONE] += hi - lo
            k += 1
    return dict(out)


def summarize(prof, label=str, top: int = 10) -> dict:
    """`tracing.summarize`'s readings of a stopped profiler with the
    program's ranges left out of device activity, plus `idle_by_span` and
    `spans`, and the idle gaps named by the program span open at their
    middle. One pass over the events, as tracing.summarize makes (a second
    pass costs a traced run of the cell ~20 s)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev_ev, blocks, mine = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # The spans' mirrors on the device's timeline are no work.
            if (e.duration_ns() > 0 and not name.startswith(tracing.SPAN)
                    and not name.startswith(PROGRAM)):
                dev_ev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               name))
        elif name.startswith(tracing.SPAN):
            blocks.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name[len(tracing.SPAN):]))
        elif name.startswith(PROGRAM):
            mine.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         name[len(PROGRAM):]))
    if not dev_ev or not blocks:
        return {}
    t0 = min(s[0] for s in blocks)
    t1 = max(s[1] for s in blocks)
    dev_ev.sort()
    busy = 0
    idle = []
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
                idle.append((cur_e, s))
            elif s > t0:
                idle.append((t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if t1 > cur_e:
            idle.append((cur_e, t1))
    blocks.sort()
    starts = [s[0] for s in blocks]
    segs = innermost(sorted(mine), t0, t1)
    seg_starts = [s[0] for s in segs]

    def open_at(t):
        i = bisect.bisect_right(starts, t) - 1
        kind = (label(blocks[i][2]) if i >= 0 and t < blocks[i][1]
                else "between_blocks")
        inner = segs[bisect.bisect_right(seg_starts, t) - 1][2]
        return f"{kind}/{inner}" if inner else kind

    gaps = sorted(((b - a, a, b) for a, b in idle), reverse=True)
    merged = collections.defaultdict(float)
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        merged[tracing.short_name(k)] += v[0] / 1e9
    ops = sorted(merged.items(), key=lambda kv: -kv[1])
    totals = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in mine:
        totals[name][0] += (e - s) / 1e9
        totals[name][1] += 1
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": {k: (v[0] / 1e9, v[1]) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [[open_at((a + b) // 2), g / 1e9]
                          for g, a, b in gaps[:top]],
        },
        "idle_by_span": {k: v / 1e9 for k, v in
                         idle_by_span(idle, segs).items()},
        "spans": {k: tuple(v) for k, v in totals.items()},
    }


def layers(summary: dict, plot_its: int, host_reads: int) -> dict:
    """The split's per-layer metrics: each layer's idle seconds over the
    window (%), and host_reads.train, the window's blocking reads per 100
    plot-iterations. Empty without a summary."""
    if not summary or summary["window_s"] <= 0:
        return {}
    by = summary["idle_by_span"]
    out = {m: 100.0 * sum(by.get(n, 0.0) for n in names)
           / summary["window_s"] for m, names in LAYERS.items()}
    if host_reads is not None and plot_its:
        out["host_reads.train"] = 100.0 * host_reads / plot_its
    return out


def _program_trace():
    """The program's span switch and counters, or None for a program
    without them."""
    try:
        from wheat3dgs_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def run(argv, root=None, device=None, t_start=None):
    """harness.run of a traced window with the program's spans on from
    just after the profiler starts to just before it stops, and this
    module's `summarize` in `tracing.summarize`'s place. Returns the
    result line with `split`: `layers`' metrics, the window's host_reads,
    `idle_by_span` and `spans`; None after a refusal."""
    from . import harness

    program = _program_trace()
    seen = {}
    start, base = tracing.start, tracing.summarize

    def reads():
        return None if program is None else program.counters().get(
            "host_reads", 0)

    def start_spans():
        prof = start()
        seen["reads"] = reads()
        if program is not None:
            program.on()
        stop = prof.stop

        def stop_spans():
            if program is not None:
                program.off()
            r = reads()
            seen["reads"] = None if r is None else r - seen["reads"]
            stop()

        prof.stop = stop_spans
        return prof

    def summarize_spans(prof, label=str, top=10):
        seen["summary"] = summarize(prof, label, top)
        return seen["summary"]

    tracing.start, tracing.summarize = start_spans, summarize_spans
    try:
        out = harness.run(list(argv) + ["--trace", "1"], root=root,
                          device=device, t_start=t_start)
    finally:
        tracing.start, tracing.summarize = start, base
        if program is not None:
            program.off()
    if out is None:
        return None
    summary = seen.get("summary") or {}
    out["split"] = {
        "metrics": layers(summary, out["attempted"], seen.get("reads")),
        "host_reads": seen.get("reads"),
        "idle_by_span": summary.get("idle_by_span"),
        "spans": summary.get("spans"),
    }
    return out
