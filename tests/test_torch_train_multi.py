"""The port's multi-plot training app (wheat3dgs_tpu_torch.apps.train_multi)
against the JAX package's, on the CPU.

- The schedule: both apps' training() with the step and densify_and_prune
  replaced by stubs. The step stub records each iteration's view picks
  (found from the cameras), the shared capacity, each plot's live count
  and largest opacity; the densify stub marks 300 free slots live (200
  once max_screen is 20, after the first opacity reset) and reports the
  requests beyond the free slots as dropped. The two apps must record the
  same sequence: the same picks, densify events, capacity doublings and
  opacity resets, and the same SH ramp (the step built for each degree).
- The port's app for real on two tiny plots with --device cpu: the output
  tree, metrics_multi.jsonl's keys, per-plot live counts that diverge with
  a doubling of the capacity, PLYs that JAX's load_ply reads, the reset
  branch, and both source selectors.
- The mesh factoring over the devices (JAX's rule).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu.apps import train_multi as JA
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.models import serialization as JS
from wheat3dgs_tpu_torch import config as tcfg
from wheat3dgs_tpu_torch.apps import train_multi as TA
from wheat3dgs_tpu_torch.models import gaussians as TG


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: tiny tensors, where torch's thread pool only
    adds barrier waits on a machine loaded by parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_plots(base, pids):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for pid, (ground, per_head) in pids.items():
            make_synthetic_colmap_scene(
                str(base / f"plot_{pid}"), plot_id=pid, width=32, height=24,
                n_heads=1, pts_per_head=per_head, ground_pts=ground,
                seed=pid, with_masks=False, device="cpu")
    finally:
        torch.set_num_threads(n)
    return base


@pytest.fixture(scope="module")
def plots(tmp_path_factory):
    """Two plots of different sizes (280 and 75 initial points)."""
    return _make_plots(tmp_path_factory.mktemp("multi") / "plots",
                       {461: (500, 60), 463: (120, 30)})


def _read_log(model_base):
    with open(os.path.join(model_base, "metrics_multi.jsonl")) as f:
        return [json.loads(line) for line in f]


# --- the schedule against JAX's ---------------------------------------------


def _banks(plot_dirs):
    from wheat3dgs_tpu_torch.scene import Scene

    return [Scene(tcfg.ModelParams(source_path=d), load_images=False,
                  device="cpu").cam_stack("train")[0].numpy()
            for d in plot_dirs]


def _picks(w2c, banks):
    out = []
    for p, bank in enumerate(banks):
        row = []
        for b in range(w2c.shape[1]):
            hits = [v for v in range(len(bank))
                    if np.array_equal(bank[v], w2c[p, b])]
            assert len(hits) == 1
            row.append(hits[0])
        out.append(tuple(row))
    return tuple(out)


def _record(alive, opacity_logit, w2c, banks, calls):
    alive = np.asarray(alive)
    opac = 1.0 / (1.0 + np.exp(-np.asarray(opacity_logit, np.float64)))
    calls.append(("step", len([c for c in calls if c[0] == "step"]) + 1,
                  _picks(np.asarray(w2c), banks), alive.shape[1],
                  tuple(int(x) for x in alive.sum(1)),
                  tuple(round(float(x), 4) for x in opac.max(1))))


def _jax_stubs(monkeypatch, banks, calls):
    def factory(sh, w, h, opt, config):
        calls.append(("build", sh))

        def step(states, w2c, *args):
            it, n = int(args[-2]), states.alive.shape[0]
            _record(states.alive, states.params.opacity_logit, w2c, banks,
                    calls)
            assert calls[-1][1] == it
            return states, {"loss": np.zeros(n), "psnr": np.zeros(n),
                            "n_alive": np.asarray(states.alive.sum(1))}
        return step

    def densify(st, key, thr, min_opacity, extent, max_screen, pd):
        add = 300 if max_screen == 0.0 else 200
        free = ~st.alive
        new = st.alive | (free & (jnp.cumsum(free) <= add))
        return dataclasses.replace(st, alive=new), {
            "n_dropped": jnp.maximum(add - free.sum(), 0),
            "n_alive": new.sum()}

    monkeypatch.setattr(JA, "multi_plot_step", factory)
    monkeypatch.setattr(JG, "densify_and_prune", densify)


def _port_stubs(monkeypatch, banks, calls):
    class Step:
        def __init__(self, sh, w, h, opt, config):
            self.sh_degree = sh
            calls.append(("build", sh))

        def __call__(self, states, cams, gts, bg, scalars):
            _record(states.alive, states.params.opacity_logit, cams[0],
                    banks, calls)
            n = states.alive.shape[0]
            return states, {"loss": torch.zeros(n), "psnr": torch.zeros(n),
                            "n_alive": states.alive.sum(1)}

    def densify(st, thr, min_opacity, extent, max_screen, pd,
                generator=None):
        add = 300 if max_screen == 0.0 else 200
        free = ~st.alive
        new = st.alive | (free & (torch.cumsum(free, 0) <= add))
        return dataclasses.replace(st, alive=new), {
            "n_dropped": torch.clamp(add - free.sum(), min=0),
            "n_alive": new.sum()}

    monkeypatch.setattr(TA, "multi_plot_step", Step)
    monkeypatch.setattr(TG, "densify_and_prune", densify)


@pytest.mark.parametrize("case", ["events", "sh_ramp"])
def test_schedule_matches_jax(case, plots, tmp_path, monkeypatch):
    dirs = [str(plots / "plot_461"), str(plots / "plot_463")]
    banks = _banks(dirs)
    flags = {"events": ["--iterations", "60", "--densify_from_iter", "5",
                        "--densification_interval", "10",
                        "--densify_until_iter", "55",
                        "--opacity_reset_interval", "25"],
             "sh_ramp": ["--iterations", "1001",
                         "--densify_from_iter", "10000"]}[case]
    argv = ["--source_paths", *dirs, "--views_per_step", "2", "--quiet",
            "--sh_degree", "1"] + flags
    out = []
    for name, stubs, app, extra in (("jax", _jax_stubs, JA, []),
                                    ("port", _port_stubs, TA,
                                     ["--device", "cpu"])):
        calls = []
        stubs(monkeypatch, banks, calls)
        app.main(argv + ["--model_base", str(tmp_path / name)] + extra)
        out.append(calls)
    jax_calls, port_calls = out
    assert port_calls == jax_calls
    steps = [c for c in port_calls if c[0] == "step"]
    assert len(steps) == int(flags[1])
    if case == "events":
        caps = [c[3] for c in steps]
        assert caps[0] == 1024 and max(caps) == 2048      # one doubling
        assert len({c[4] for c in steps}) > 3              # densify events
        assert steps[0][5][0] > 0.09 and steps[-1][5][0] <= 0.0101  # reset
    else:
        assert [c for c in port_calls if c[0] == "build"] == [
            ("build", 0), ("build", 1)]
        assert port_calls.index(("build", 1)) == 1000   # before step 1000


# --- the port's app for real ------------------------------------------------


def test_train_multi_divergent_plots_double_the_capacity(plots, tmp_path):
    model_base = str(tmp_path / "models")
    _, states = TA.main([
        "--source_paths", str(plots / "plot_461"), str(plots / "plot_463"),
        "--model_base", model_base, "--iterations", "40",
        "--densify_from_iter", "5", "--densification_interval", "10",
        "--densify_until_iter", "40", "--densify_grad_threshold", "1e-9",
        "--opacity_reset_interval", "10000", "--sh_degree", "1",
        "--views_per_step", "2", "--max_per_tile", "256", "--quiet",
        "--device", "cpu"])
    recs = _read_log(model_base)
    assert [r["iter"] for r in recs] == [40]
    last = recs[-1]
    assert set(last) == {"iter", "loss", "psnr", "n_alive", "elapsed_s"}
    assert len(last["loss"]) == len(last["psnr"]) == 2
    assert all(np.isfinite(last["loss"])) and min(last["psnr"]) > 10
    n_alive = last["n_alive"]
    assert states.alive.shape[1] >= 2048 and max(n_alive) > 1024, n_alive
    assert n_alive[0] > 1.5 * n_alive[1], n_alive
    assert states.adam.step == 40
    for pid, n in zip((461, 463), n_alive):
        d = os.path.join(model_base, f"plot_{pid}")
        assert {"cfg_args", "cameras.json", "input.ply",
                "point_cloud"} <= set(os.listdir(d))
        st, sh = JS.load_ply(os.path.join(d, "point_cloud", "iteration_40",
                                          "point_cloud.ply"))
        assert sh == 1 and int(st.num_alive) == n


def test_train_multi_reset_branch_from_source_base(tmp_path):
    base = _make_plots(tmp_path / "plots", {465: (160, 40)})
    (tmp_path / "plots" / "not_a_plot").mkdir()
    model_base = str(tmp_path / "models")
    _, states = TA.main([
        "--source_base", str(base), "--model_base", model_base,
        "--iterations", "50", "--densify_from_iter", "10",
        "--densification_interval", "20", "--densify_until_iter", "45",
        "--opacity_reset_interval", "30", "--sh_degree", "0", "--quiet",
        "--device", "cpu"])
    last = _read_log(model_base)[-1]
    assert len(last["loss"]) == 1 and np.isfinite(last["loss"]).all()
    assert last["n_alive"][0] > 20
    # The reset at 30 clamped every opacity to 0.01; 20 steps since then.
    assert float(torch.sigmoid(states.params.opacity_logit).max()) < 0.3
    assert sorted(os.listdir(model_base)) == ["metrics_multi.jsonl",
                                              "plot_465"]
    assert os.path.exists(os.path.join(model_base, "plot_465", "point_cloud",
                                       "iteration_50", "point_cloud.ply"))


@pytest.mark.parametrize("n_plots,views,n_dev,want", [
    (2, 4, 8, (2, 4)), (3, 2, 8, (1, 2)), (7, 2, 8, (1, 2)),
    (4, 1, 8, (4, 1)), (2, 2, 1, (1, 1)), (6, 3, 4, (2, 1))])
def test_mesh_factors_follow_jax(n_plots, views, n_dev, want):
    assert TA.mesh_factors(n_plots, views, n_dev) == want
