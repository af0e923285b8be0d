"""The port's densification decisions and their log, on the CPU.

- `models.gaussians.densify_masks` (densify_and_prune's per-splat
  decisions, which chip_smoke's decision phase compares between the
  kernels and their plain versions): its counts equal the counts of JAX's
  densify_and_prune on the same state, with and without the world-size
  prune, exactly, and its statistic is grad_accum / denom.
- The training CLI logs each densify to metrics.jsonl (`densify`:
  densify_and_prune's counts, the entry budget, the block's
  entries_total, the overflow events, the capacity), and
  scripts/densify_trace.py's `run` (default, and with `--plain --eager`,
  which on the CPU runs the same plain code step by step) gives equal
  records; `compare` puts two runs side by side. `--tpu_knn` initializes
  the scales from ops/knn.knn_mean_sq_dist_bf16 and restores the exact
  kNN after; `--bf16_grads` sums bfloat16-rounded entry gradients and
  restores the segment sum after.
- The CLI's block schedule ends a block at every densify iteration of
  the reference schedule (train_vanilla_3dgs.py: every 100 from 600 to
  10,900) with or without checkpoint iterations; JAX's rule, which the
  port kept before, ran 14 of the 104 without them.
- `cuda_raster.plain_kernels` and `training_graph.eager_steps` route and
  restore.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_train_model import _jax_state, _to_port
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops import cuda_raster as CR
from wheat3dgs_tpu_torch import training_graph as TGR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts",
                     "densify_trace.py")
KEYS = {"n_clone", "n_split", "n_pruned", "n_pruned_opacity", "n_dropped",
        "n_alive", "entry_budget", "entries_total", "overflow_events",
        "capacity"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace_module():
    spec = importlib.util.spec_from_file_location("densify_trace", TRACE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("max_screen", [0.0, 20.0])
def test_densify_masks_count_as_jax_densify(max_screen):
    jst = _jax_state(n=12, cap=32, seed=4)
    kw = dict(grad_threshold=2e-4, min_opacity=0.005, extent=2.0,
              max_screen_size=max_screen, percent_dense=0.01)
    _, jinfo = JG.densify_and_prune(jst, jax.random.PRNGKey(0), **kw)
    tst = _to_port(jst)
    m = TG.densify_masks(tst, **kw)
    assert int(m["clone"].sum()) == int(jinfo["n_clone"])
    assert int(m["split"].sum()) == int(jinfo["n_split"])
    assert int(m["prune"].sum()) == int(jinfo["n_pruned"])
    assert int(m["prune_opacity"].sum()) == int(jinfo["n_pruned_opacity"])
    assert int(m["hot"].sum()) == int(jinfo["n_clone"] + jinfo["n_split"])
    seen = tst.denom > 0
    np.testing.assert_array_equal(
        m["stat"][seen].numpy(), (tst.grad_accum / tst.denom)[seen].numpy())
    assert not bool(m["stat"][~seen].any())
    _, tinfo = TG.densify_and_prune(tst, **kw)
    for k, v in jinfo.items():
        assert int(tinfo[k]) == int(v), k


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("densify") / "scene")
    make_synthetic_colmap_scene(out, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=300,
                                with_masks=False, device="cpu")
    return out


def test_cli_densify_records_and_trace(tiny_scene, tmp_path, capsys):
    tr = _trace_module()
    args = ["-s", tiny_scene, "--device", "cpu", "--iterations", "60",
            "--densify_from_iter", "10", "--densification_interval", "20",
            "--densify_grad_threshold", "0.00002", "--test_iterations",
            "60", "--save_iterations", "60"]
    runs = {}
    for name, flags in (("default", []), ("plain", ["--plain", "--eager"])):
        model = str(tmp_path / name)
        runs[name] = tr.run(flags + ["--", "-m", model] + args)
    assert sorted(runs["default"]) == [20, 40, 60]
    assert runs["plain"] == runs["default"]
    before = 210           # points3D: half of the 420 generated points
    for it, rec in sorted(runs["default"].items()):
        assert set(rec) == KEYS
        assert rec["n_alive"] == (before - rec["n_pruned"] - rec["n_split"]
                                  + rec["n_clone"] + 2 * rec["n_split"]
                                  - rec["n_dropped"])
        assert rec["entries_total"] > 0 and rec["overflow_events"] == 0
        before = rec["n_alive"]
    log = tmp_path / "default" / "metrics.jsonl"
    recs = [json.loads(ln) for ln in open(log)]
    assert [r["iter"] for r in recs if "densify" in r] == [20, 40, 60]
    capsys.readouterr()
    table = tr.compare([f"a={log}",
                        f"b={tmp_path / 'plain' / 'metrics.jsonl'}"])
    assert [row[0] for row in table] == [20, 40, 60]
    assert all(row[-1] == 1.0 for row in table)
    assert "a test psnr" in capsys.readouterr().out


def test_trace_tpu_knn_initializes_from_the_tpu_distance(tiny_scene,
                                                        tmp_path):
    from wheat3dgs_tpu_torch.ops import knn as TK

    tr = _trace_module()
    pts = np.random.default_rng(3).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    cols = np.full((300, 3), 0.5, np.float32)
    with tr.tpu_knn("cpu"):
        st = TG.create_from_pcd(pts, cols, 0, device="cpu")
    want = np.log(np.sqrt(np.maximum(TK.knn_mean_sq_dist_bf16(pts), 1e-7)))
    np.testing.assert_allclose(st.params.log_scales[:300, 0].numpy(), want,
                               rtol=1e-6)
    assert TG.knn_mean_sq_dist is TK.knn_mean_sq_dist
    recs = tr.run(["--tpu_knn", "--", "-s", tiny_scene, "-m",
                   str(tmp_path / "m"), "--device", "cpu", "--iterations",
                   "20", "--densify_from_iter", "10",
                   "--densification_interval", "20", "--test_iterations",
                   "20", "--save_iterations", "20"])
    assert sorted(recs) == [20]


def test_trace_bf16_grads_rounds_the_entry_gradients(tiny_scene, tmp_path):
    tr = _trace_module()
    vals = torch.randn(40, 4, generator=torch.Generator().manual_seed(0))
    start = torch.tensor([0, 7, 20], dtype=torch.int32)
    end = torch.tensor([7, 20, 40], dtype=torch.int32)
    segsum = CR.segsum
    with tr.bf16_grads():
        got = CR.segsum(vals, start, end)
    assert CR.segsum is segsum
    want = CR.segsum_plain(vals.to(torch.bfloat16).float(), start, end)
    assert torch.equal(got, want)
    assert not torch.equal(got, CR.segsum_plain(vals, start, end))
    recs = tr.run(["--bf16_grads", "--", "-s", tiny_scene, "-m",
                   str(tmp_path / "m"), "--device", "cpu", "--iterations",
                   "20", "--densify_from_iter", "10",
                   "--densification_interval", "20", "--test_iterations",
                   "20", "--save_iterations", "20"])
    assert sorted(recs) == [20]


def test_plain_kernels_and_eager_steps_restore():
    kernel = CR.composite_bwd
    with CR.plain_kernels():
        for k in CR.KERNELS:
            assert getattr(CR, k) is getattr(CR, k + "_plain")
    assert CR.composite_bwd is kernel
    run = TGR.StepGraph.run
    calls = []
    with TGR.eager_steps():
        TGR.StepGraph().run(lambda: calls.append(1), 3, None,
                            torch.device("cuda"))
    assert calls == [1, 1, 1] and TGR.StepGraph.run is run


@pytest.mark.parametrize("ckpts", [False, True])
def test_block_schedule_ends_at_every_densify(ckpts):
    from wheat3dgs_tpu_torch.apps.train_vanilla import block_len
    from wheat3dgs_tpu_torch.config import OptimizationParams

    opt = OptimizationParams(iterations=30_000)
    events = {7000, 15_000, 30_000}
    if ckpts:
        events |= set(range(1000, 30_001, 1000))
    it, ends = 1, []
    while it <= opt.iterations:
        k = block_len(it, opt, events)
        assert 1 <= k <= 50
        ends.append(it + k - 1)
        it += k
    assert ends[-1] == opt.iterations
    want = [i for i in range(opt.densify_from_iter + 1,
                             opt.densify_until_iter)
            if i % opt.densification_interval == 0]
    assert len(want) == 104
    assert [e for e in ends if e in set(want)] == want
    # Every log iteration ends a block too, and each opacity reset.
    assert set(range(100, 30_001, 100)) <= set(ends)
