"""The port's spans and counters (wheat3dgs_tpu_torch/utils/trace.py) on
the CPU, under a running torch.profiler:

- with the switch off no "w3dgs/" range is recorded and `span()` is one
  shared null context;
- with it on, a Trainer on a tiny plot driven across a densify records
  the schedule's spans, with "train.grow_capacity" inside
  "train.densify" when the densify grows the capacity;
- `host_reads` counts the reads the schedule executes: one a probe of
  the entry budget, one a watchdog check with telemetry queued, and the
  densify's n_dropped, n_alive (when n_dropped is 0) and, with growth,
  the n_alive that sizes the new capacity.

(StepGraph's spans need a CUDA graph; benchmarks/tests/test_program_spans.py
checks them on the card.)
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_training import H, W, _cams, _port_state, _scene
from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch.config import OptimizationParams as TOpt
from wheat3dgs_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_thread_spans_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    trace.off()
    torch.set_num_threads(n)


def _trainer(grow: bool):
    """A Trainer on 40 splats in 64 slots that densifies at iteration 2:
    every splat hot (threshold 0, so the requests outrun the free slots and
    the capacity grows) or none."""
    cam, jst, gt = _scene()
    opt = dataclasses.replace(
        TOpt(), densify_from_iter=1, densification_interval=2,
        densify_grad_threshold=0.0 if grow else 1e9)
    tr = TT.Trainer(_port_state(jst), opt, 2.0, sh_degree=1,
                    overflow_check_every=1)
    return tr, _cams(cam)[1], torch.as_tensor(gt)


def _drive(tr, cam, gt, its=(1, 2)):
    for it in its:
        tr.step(it, cam, gt, W, H)


def _spans(prof) -> list:
    """(name, start, end) of every program range, in start order."""
    return sorted(((e.name[len(trace.PREFIX):], e.time_range.start,
                    e.time_range.end) for e in prof.events()
                   if e.name.startswith(trace.PREFIX)),
                  key=lambda s: s[1])


def test_spans_off_record_nothing():
    tr, cam, gt = _trainer(grow=False)
    trace.off()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(tr, cam, gt)
        s = trace.span("graph.capture")
    assert tr.last_densify is not None and tr.last_densify[0] == 2
    assert _spans(prof) == []
    assert isinstance(s, contextlib.nullcontext)
    assert trace.span("train.densify") is s


@pytest.mark.parametrize("grow", [False, True])
def test_spans_on_name_the_schedule(grow):
    tr, cam, gt = _trainer(grow)
    cap = tr.state.capacity
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.on()
        _drive(tr, cam, gt)
        trace.off()
    assert (tr.state.capacity > cap) == grow
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert {"train.eager_step", "train.occupancy", "train.watchdog",
            "train.densify"} <= set(names), names
    assert names.count("train.eager_step") == 2
    assert names.count("train.densify") == 1
    assert ("train.grow_capacity" in names) == grow
    if grow:
        (_, d0, d1), = [s for s in spans if s[0] == "train.densify"]
        (_, g0, g1), = [s for s in spans if s[0] == "train.grow_capacity"]
        assert d0 <= g0 and g1 <= d1


@pytest.mark.parametrize("grow", [False, True])
def test_host_reads_count_the_reads(grow, monkeypatch):
    """The counter's window delta against the reads the schedule's calls
    made, counted from the calls themselves."""
    tr, cam, gt = _trainer(grow)
    made = {"probe": 0, "watchdog": 0}
    probe, check = TT.Trainer._refresh_occupancy, TT.Trainer._check_overflow

    def refresh(self, *a):
        made["probe"] += 1
        return probe(self, *a)

    def watchdog(self, *a):
        made["watchdog"] += self._pending_overflow is not None
        return check(self, *a)

    monkeypatch.setattr(TT.Trainer, "_refresh_occupancy", refresh)
    monkeypatch.setattr(TT.Trainer, "_check_overflow", watchdog)
    cap = tr.state.capacity
    before = trace.counters().get("host_reads", 0)
    _drive(tr, cam, gt, its=(1, 2, 3))
    got = trace.counters()["host_reads"] - before
    info = tr.last_densify[1]
    densify = 1 + (int(info["n_dropped"]) == 0) + (tr.state.capacity > cap)
    assert made == {"probe": 2, "watchdog": 2}
    assert got == made["probe"] + made["watchdog"] + densify
    assert (int(info["n_dropped"]) > 0) == grow
