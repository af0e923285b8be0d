"""The port's bench (wheat3dgs_tpu_torch/apps/bench.py) against the repo's
bench.py.

- Schedule: both benches run on one tiny scene written by the JAX
  generator (WHEAT3DGS_BENCH_SCENE, WHEAT3DGS_BENCH_ITERS=140), each with
  its Trainer replaced by a stub that records every `step` and
  `step_block` call: the iteration, the views (mapped to train-view
  indices through the camera stack) and the entry budget. bench.py's TPU
  health probe returns True, its compilation-cache settings are not
  applied, its config reports the Pallas backend (as on a TPU, so it runs
  its three budget-rung blocks), and its render calls are stubbed (the
  stub state cannot feed them). The two call sequences, the
  OptimizationParams and the Trainer's other arguments must be equal.
- The port's bench for real at 64x48 on the CPU: one JSON line on stdout
  with bench.py's keys, every value finite and positive.
"""

import dataclasses
import importlib.util
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["metric", "value", "unit", "vs_baseline", "mean_ms", "median_ms",
        "n_splats", "render_fps"]
ITERS = 140


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from wheat3dgs_tpu.io.synthetic import make_synthetic_colmap_scene

    d = str(tmp_path_factory.mktemp("bench") / "scene")
    make_synthetic_colmap_scene(d, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=300, seed=0,
                                with_masks=False)
    return d


@pytest.fixture
def bench_env(monkeypatch, scene_dir):
    monkeypatch.setenv("WHEAT3DGS_BENCH_SCENE", scene_dir)
    monkeypatch.setenv("WHEAT3DGS_BENCH_ITERS", str(ITERS))
    monkeypatch.delenv("WHEAT3DGS_BENCH_W", raising=False)
    monkeypatch.delenv("WHEAT3DGS_BENCH_H", raising=False)


def _recording_trainer(calls, to_array, metrics):
    """A Trainer stand-in that records its arguments and each step /
    step_block call, and returns fixed metrics."""

    class Stub:
        def __init__(self, state, opt, extent, sh_degree=3, config=None,
                     **kw):
            calls.append(("init", dataclasses.asdict(opt), float(extent),
                          sh_degree, kw))
            self.state, self.opt = state, opt
            self.config = config
            self.max_sh_degree = sh_degree
            self.active_sh_degree = 0
            self.overflow_events = 0
            self.cams = []

        def step(self, it, cam, gt_image, width, height):
            self.cams.append(to_array(cam[0]))
            calls.append(("step", it, len(self.cams) - 1,
                          self.active_sh_degree, (width, height)))
            return metrics()

        def step_block(self, it0, view_idx, cam_stacks, gt_stack, width,
                       height, n_steps):
            calls.append(("block", it0, [int(v) for v in view_idx],
                          n_steps, int(self.config.entry_budget),
                          self.active_sh_degree, (width, height)))
            self.stack = to_array(cam_stacks[0])
            return metrics()

    return Stub


def _views(calls, stub):
    """Replace each step's recorded camera by its train-view index."""
    out = []
    for c in calls:
        if c[0] == "step":
            hit = [i for i, m in enumerate(stub.stack)
                   if np.array_equal(m, stub.cams[c[2]])]
            assert len(hit) == 1
            c = (c[0], c[1], hit[0]) + c[3:]
        out.append(c)
    return out


def _run_jax(monkeypatch, capsys):
    import wheat3dgs_tpu.render.pipeline as JP
    import wheat3dgs_tpu.training as JT

    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    jb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jb)
    calls, made = [], []

    def metrics():
        return {"loss": jnp.float32(0.1), "n_alive": jnp.int32(7),
                "psnr": jnp.float32(30.0)}

    base = _recording_trainer(calls, np.asarray, metrics)

    class JStub(base):
        def __init__(self, *a, config=None, **kw):
            super().__init__(*a, config=dataclasses.replace(
                config, backend="pallas"), **kw)
            made.append(self)

    real_update = jax.config.update
    monkeypatch.setattr(jb, "wait_tpu_healthy", lambda budget_s: True)
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs") else real_update(k, v))
    monkeypatch.setattr(JT, "Trainer", JStub)
    probes = []
    monkeypatch.setattr(JP, "adapt_config", lambda state, cam, w, h, config,
                        cams=None: probes.append(len(cams)) or config)
    monkeypatch.setattr(JP, "render_fwd_jit", lambda *a, **k:
                        types.SimpleNamespace(color=jnp.zeros(())))
    jb.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return _views(calls, made[0]), probes, json.loads(line)


def _run_port(monkeypatch, capsys):
    from wheat3dgs_tpu_torch.apps import bench as tb
    from wheat3dgs_tpu_torch.render import pipeline as TP

    calls, made = [], []

    def metrics():
        return {"loss": torch.tensor(0.1), "n_alive": torch.tensor(7),
                "psnr": torch.tensor(30.0)}

    base = _recording_trainer(calls, lambda t: t.numpy(), metrics)

    class TStub(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    probes = []
    real_adapt = TP.adapt_config

    def adapt(state, cam, w, h, config, cams=None):
        probes.append(len(cams))
        return real_adapt(state, cam, w, h, config, cams=cams)

    monkeypatch.setattr(tb, "Trainer", TStub)
    monkeypatch.setattr(tb, "adapt_config", adapt)
    tb.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return _views(calls, made[0]), probes, json.loads(line)


def test_bench_draws_and_schedule_match_jax(monkeypatch, capsys, bench_env):
    j_calls, j_probes, j_line = _run_jax(monkeypatch, capsys)
    t_calls, t_probes, t_line = _run_port(monkeypatch, capsys)
    steps = [c for c in t_calls if c[0] == "step"]
    blocks = [c for c in t_calls if c[0] == "block"]
    # 100 warm-up steps + the SH step, three rung blocks at the warm-up
    # iteration, then (140 - 100) / 20 timed windows.
    assert len(steps) == 101 and len(blocks) == 3 + 2
    assert [b[1] for b in blocks] == [100, 100, 100, 101, 121]
    assert len({s[2] for s in steps}) > 1
    assert [b[4] for b in blocks[:3]] == [0, 131072, 163840]
    assert t_calls[0][1]["densify_until_iter"] == ITERS - 100
    assert t_calls == j_calls
    assert t_probes == j_probes
    assert list(t_line) == list(j_line) == KEYS
    assert t_line["n_splats"] == j_line["n_splats"] == 7


def test_bench_runs_on_cpu(capsys, bench_env, monkeypatch):
    from wheat3dgs_tpu_torch.apps import bench as tb

    # The windows' times, to hold `value` and `vs_baseline` to the rate
    # they were both rounded from (as bench.py rounds each from it:
    # round(value / 60, 3) misses round(rate / 60, 3) for ~8% of rates).
    runs = []
    train = tb.train

    def recording_train(*args, **kw):
        runs.append(train(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(tb, "train", recording_train)
    out = tb.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == out and list(got) == KEYS
    assert got["metric"] == "train_iters_per_sec" and got["unit"] == "it/s"
    for k in KEYS[1:2] + KEYS[3:]:
        assert math.isfinite(got[k]) and got[k] > 0, k
    ips = 1.0 / float(np.median(runs[0][-1]))
    assert got["value"] == round(ips, 2)
    assert got["vs_baseline"] == round(ips / 60.0, 3)


def test_bench_refuses_without_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wheat3dgs_tpu_torch.apps import bench as tb

    monkeypatch.setenv("WHEAT3DGS_BENCH_SCENE", str(tmp_path / "scene"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([])
    assert not (tmp_path / "scene").exists()
