"""The port's resumable segmentation loop (seg/pipeline.py, loop_state.npz),
held to an uninterrupted run as tests/test_seg.py holds the JAX package's.

A run is stopped at a consistent checkpoint halfway through the shuffled
masks (the `_stop_after_masks` hook) and rerun into the same directory. It
must write the same head count, results.csv rows, ply/ files and 2DSeg maps,
exactly, as one run from the start. The scene is the port's generator at
64x48 (3 heads, masks included) with its stand-in model, on the CPU.
"""

import csv
import os

import numpy as np
import pytest
import torch

from wheat3dgs_tpu_torch import config as tcfg
from wheat3dgs_tpu_torch.io import synthetic as TY
from wheat3dgs_tpu_torch.render.pipeline import adapt_config


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Many small torch ops on the CPU: two threads, so the suite's parallel
    workers do not oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_and_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("segresume")
    scene_dir, model_dir = str(root / "scene"), str(root / "model")
    kw = dict(n_heads=3, pts_per_head=100, ground_pts=500, seed=3)
    TY.make_synthetic_colmap_scene(scene_dir, width=64, height=48,
                                   device="cpu", **kw)
    TY.write_stand_in_model(model_dir, scene_dir, device="cpu", **kw)
    return scene_dir, model_dir


def _context(scene_dir, model_dir):
    from wheat3dgs_tpu_torch.apps.run_3d_seg_app import build_context
    from wheat3dgs_tpu_torch.scene import Scene

    scene = Scene(tcfg.ModelParams(source_path=scene_dir,
                                   model_path=model_dir),
                  load_iteration=-1, shuffle=False, device="cpu")
    w, h = scene.image_size
    config = adapt_config(
        scene.gaussians, scene.cam_arrays("train", 0), w, h,
        cams=[scene.cam_arrays("train", i)
              for i in range(len(scene.data.train))])
    return build_context(scene, config)


def _rows(base):
    with open(os.path.join(base, "results.csv")) as f:
        return list(csv.reader(f))


def test_run_segmentation_resume(scene_and_model, tmp_path):
    from wheat3dgs_tpu_torch.seg.pipeline import load_pt, run_segmentation

    ctx = _context(*scene_and_model)
    full = run_segmentation(ctx, str(tmp_path / "full"), "r", verbose=False)
    stop = sum(len(p) for p in ctx.mask_paths) // 2
    part = run_segmentation(ctx, str(tmp_path / "resumed"), "r",
                            verbose=False, _stop_after_masks=stop)
    assert part["interrupted_at"] == stop
    assert 0 < part["num_heads"] <= full["num_heads"]
    # A fresh context, as after a restart: only the files carry the state.
    res = run_segmentation(_context(*scene_and_model),
                           str(tmp_path / "resumed"), "r", verbose=False)
    assert "interrupted_at" not in res
    assert res["num_heads"] == full["num_heads"] >= 2
    assert _rows(res["out_dir"]) == _rows(full["out_dir"])
    for sub in ("ply", "2DSeg"):
        assert sorted(os.listdir(os.path.join(res["out_dir"], sub))) == \
            sorted(os.listdir(os.path.join(full["out_dir"], sub)))
    for f in os.listdir(os.path.join(full["out_dir"], "2DSeg")):
        np.testing.assert_array_equal(
            load_pt(os.path.join(res["out_dir"], "2DSeg", f)),
            load_pt(os.path.join(full["out_dir"], "2DSeg", f)))
