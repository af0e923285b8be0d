"""The split of the idle time by the program's spans (benchlib/spans.py):
on synthetic profiler events against `tracing.summarize`, through the
harness on the tiny cell on the CPU (split_idle.py's path), and on the
card, where a recaptured block's graph spans come in their order and the
capture's span agrees with `StepGraph.capture_seconds`."""

import random
import types

import pytest
import torch

from benchlib import spans, tracing
from test_bench_harness import ROOT, SEED, tiny_tree

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MS = 1_000_000


class Ev:
    """One profiler event as kineto_results.events() gives it."""

    def __init__(self, name, start, end, dev=CPU):
        self._name, self._s, self._d, self._dev = name, start, end - start, dev

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def _prof(events):
    """`events` in the shape a stopped torch.profiler gives them."""
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def _blocks():
    """Two benchmark blocks over 0-100 ms and kernels with gaps at 10-20,
    40-60 and 90-100 ms (busy 60 ms), the blocks' mirrors on the device."""
    ev = [Ev("bench/0", 0, 50 * MS), Ev("bench/1", 50 * MS, 100 * MS),
          Ev("bench/0", 2 * MS, 48 * MS, CUDA)]
    for a, b in ((0, 10), (20, 40), (60, 90)):
        ev.append(Ev(f"kernel_{a}", a * MS, b * MS, CUDA))
    return ev


def _program():
    """Program spans: a capture over 5-45 ms holding a replay over 30-42
    ms, a densify over 55-95 ms holding a growth over 58-62 ms; and their
    mirrors on the device (which span the kernels' gaps)."""
    ev = []
    for name, a, b in (("graph.capture", 5, 45), ("graph.replay", 30, 42),
                       ("train.densify", 55, 95),
                       ("train.grow_capacity", 58, 62)):
        ev.append(Ev(spans.PROGRAM + name, a * MS, b * MS))
    ev.append(Ev(spans.PROGRAM + "graph.capture", 0, 40 * MS, CUDA))
    ev.append(Ev(spans.PROGRAM + "train.densify", 40 * MS, 90 * MS, CUDA))
    return ev


def _label(s):
    return ["recaptured", "densify"][int(s)]


def _shared(out):
    return {k: v for k, v in out.items()
            if k not in ("idle_by_span", "spans")}


def _random(seed):
    """Six blocks over 0-600 ms with random kernels of four names (some
    overlapping, some outside the window, some of zero length) and random
    nested program spans with their mirrors: (events without the program's
    ranges, the program's ranges)."""
    rng = random.Random(seed)
    ev = [Ev(f"bench/{b}", 100 * b * MS, 100 * (b + 1) * MS)
          for b in range(6)]
    for _ in range(60):
        a = rng.randrange(-20, 620) * MS
        ev.append(Ev(f"k{rng.randrange(4)}", a,
                     a + rng.choice([0, 1, 2, 5, 9]) * MS, CUDA))
    prog = []
    for _ in range(8):
        a = rng.randrange(0, 560)
        b = a + rng.randrange(1, 40)
        c = rng.randrange(a, b)
        prog += [Ev(spans.PROGRAM + "outer", a * MS, b * MS),
                 Ev(spans.PROGRAM + "inner", c * MS,
                    rng.randrange(c, b + 1) * MS),
                 Ev(spans.PROGRAM + "outer", a * MS, b * MS, CUDA)]
    return ev, prog


@pytest.mark.parametrize("seed", ["fixed", 1, 2, 3])
def test_without_program_spans_reads_as_tracing(seed):
    ev = _blocks() if seed == "fixed" else _random(seed)[0]
    label = _label if seed == "fixed" else str
    old = tracing.summarize(_prof(ev), label=label)
    new = spans.summarize(_prof(ev), label=label)
    assert _shared(new) == old
    assert new["idle_by_span"] == {spans.NONE: pytest.approx(
        old["window_s"] - old["busy_s"], abs=1e-12)}
    assert new["spans"] == {}
    if seed == "fixed":
        assert old["busy_s"] == pytest.approx(0.060)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_program_spans_leave_the_readings(seed):
    """With random program spans: every shared key reads as the trace
    without the program's ranges does, each gap's label begins with its
    old one, and the idle seconds add up to window - busy."""
    ev, prog = _random(seed)
    old = tracing.summarize(_prof(ev), label=str)
    new = spans.summarize(_prof(ev + prog), label=str)
    gaps = new["breakdown"]["idle_gaps"]
    old_gaps = old["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == [g[1] for g in old_gaps]
    assert [g[0].split("/")[0] for g in gaps] == [g[0] for g in old_gaps]
    assert dict(_shared(new), breakdown=dict(
        new["breakdown"], idle_gaps=old_gaps)) == old
    assert sum(new["idle_by_span"].values()) == pytest.approx(
        new["window_s"] - new["busy_s"], abs=1e-12)


def test_program_spans_split_the_idle_time():
    ev = _blocks() + _program()
    new = spans.summarize(_prof(ev), label=_label)
    # The program's mirrors are no work: every shared key reads as the
    # trace without the program's ranges does, the gaps' lengths too.
    old = tracing.summarize(_prof(_blocks()), label=_label)
    gaps = new["breakdown"]["idle_gaps"]
    old_gaps = old["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == [g[1] for g in old_gaps]
    new_b = dict(new["breakdown"], idle_gaps=old_gaps)
    assert dict(_shared(new), breakdown=new_b) == old
    assert not any(k.startswith(spans.PROGRAM) for k in new["kernels"])
    assert tracing.summarize(_prof(ev), label=_label)["busy_s"] > 0.060
    # Exact intersections: 10-20 under the capture; 40-42 under the
    # replay, 42-45 under the capture, 45-55 under none, 55-58 under the
    # densify, 58-60 under the growth; 90-95 under the densify and 95-100
    # under none.
    by = new["idle_by_span"]
    assert by == pytest.approx({"graph.capture": 0.013,
                                "graph.replay": 0.002, spans.NONE: 0.015,
                                "train.densify": 0.008,
                                "train.grow_capacity": 0.002})
    assert sum(by.values()) == pytest.approx(
        new["window_s"] - new["busy_s"], abs=1e-12)
    assert new["spans"]["graph.capture"] == (pytest.approx(0.040), 1)
    # Gaps by length (ties: the later first): 40-60 (its middle 50 under
    # no program span), 90-100 (middle 95: the densify span ends there),
    # 10-20 (under the capture), each labelled by its block first.
    assert gaps == [["densify", pytest.approx(0.020)],
                    ["densify", pytest.approx(0.010)],
                    ["recaptured/graph.capture", pytest.approx(0.010)]]
    m = spans.layers(new, 100, 7)
    idle = 100.0 * (1 - new["busy_s"] / new["window_s"])
    assert sum(v for k, v in m.items() if k.startswith("idle_")) == (
        pytest.approx(idle, abs=1e-9))
    assert m["idle_graph.train"] == pytest.approx(15.0)
    assert m["idle_schedule.train"] == pytest.approx(10.0)
    assert m["idle_eager.train"] == 0.0
    assert m["host_reads.train"] == 7.0


@pytest.mark.parametrize("program", [True, False])
def test_split_through_the_harness(tmp_path, monkeypatch, program):
    """The tiny cell traced with the spans on, and with a program that has
    none (as the parent commit): the harness's own result and readings
    stand, the switch is off afterwards and the reads are the window's."""
    from wheat3dgs_tpu_torch.utils import trace

    if not program:
        monkeypatch.setattr(spans, "_program_trace", lambda: None)
    out = spans.run(["--workload", "plot12_densify", "--seed", str(SEED),
                     "--seconds", "1.5"], root=tiny_tree(tmp_path),
                    device="cpu")
    assert out["correct"], out["checks"]
    assert "capture_share.train" in out["metrics"]
    assert trace.span("x") is trace.span("y")
    reads = out["split"]["host_reads"]
    assert (reads > 0) if program else reads is None


@pytest.mark.gpu
def test_recaptured_block_on_the_card():
    """A block whose state tensors moved (as after a densify) releases the
    graph, runs the warm-up step, captures and replays, in that order; the
    capture's span agrees with capture_seconds within 2%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from benchlib import harness
    from benchlib.scene import make_plot
    from wheat3dgs_tpu_torch.config import OptimizationParams
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.training import Trainer
    from wheat3dgs_tpu_torch.utils import trace

    dev = torch.device("cuda")
    cell = harness.Cell(ROOT, "plot12_densify")
    s = dict(cell.config["scene"], width=400, height=300)
    plot = make_plot(s, 7, dev)
    tr = Trainer(G.create_from_pcd(plot.points, plot.colors, 3, device=dev),
                 OptimizationParams(), plot.extent, sh_degree=3)
    views = [0, 1, 2, 3]
    tr.step_block(1, views, plot.cam_stack, plot.gt, plot.width,
                  plot.height, n_steps=4)
    tr.state = G.map_tensors(torch.clone, tr.state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace.on()
        with tracing.span("0"):
            tr.step_block(5, views, plot.cam_stack, plot.gt, plot.width,
                          plot.height, n_steps=4)
            torch.cuda.synchronize()
        trace.off()
    assert tr.graph.captures == 2
    host = sorted((e for e in prof.events() if e.device_type == CPU),
                  key=lambda e: e.time_range.start)
    graph = [e.name for e in host
             if e.name.startswith(spans.PROGRAM + "graph.")]
    assert graph == [spans.PROGRAM + n for n in (
        "graph.release", "graph.warmup", "graph.capture", "graph.replay")]
    out = spans.summarize(prof, label=lambda _: "recaptured")
    sec, n = out["spans"]["graph.capture"]
    assert n == 1
    assert sec == pytest.approx(tr.graph.capture_seconds[-1], rel=0.02)
    assert sum(out["idle_by_span"].values()) == pytest.approx(
        out["window_s"] - out["busy_s"], abs=1e-9)
