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


def _counting_find_match(monkeypatch):
    """Count run_segmentation's calls of find_match_device."""
    from wheat3dgs_tpu_torch.seg import pipeline as TP

    calls = []
    real = TP.find_match_device

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(TP, "find_match_device", counted)
    return calls


def test_run_segmentation_without_resume_starts_afresh(
        scene_and_model, tmp_path, monkeypatch):
    """resume=False ignores a loop_state.npz (JAX's run_segmentation
    resume flag): the rerun lifts every mask again and finds what one run
    from the start finds."""
    from wheat3dgs_tpu_torch.seg.pipeline import run_segmentation

    ctx = _context(*scene_and_model)
    calls = _counting_find_match(monkeypatch)
    full = run_segmentation(ctx, str(tmp_path / "full"), "r", verbose=False)
    n_full = len(calls)
    stop = sum(len(p) for p in ctx.mask_paths) // 2
    run_segmentation(ctx, str(tmp_path / "again"), "r", verbose=False,
                     _stop_after_masks=stop)
    assert os.path.exists(os.path.join(tmp_path, "again", "wheat-head", "r",
                                       "loop_state.npz"))
    del calls[:]
    res = run_segmentation(_context(*scene_and_model),
                           str(tmp_path / "again"), "r", verbose=False,
                           resume=False)
    assert len(calls) == n_full
    assert res["num_heads"] == full["num_heads"]
    # The same rows; an overlap head's letter counts the img/ dirs already
    # there (find_new_mask_dir), as JAX's does, so it may come later.
    assert [[r[0][:4]] + r[1:] for r in _rows(res["out_dir"])] == \
        [[r[0][:4]] + r[1:] for r in _rows(full["out_dir"])]


@pytest.mark.parametrize("rounds", [0, 1, 99])
def test_run_segmentation_max_refine_rounds(rounds, scene_and_model,
                                            tmp_path, monkeypatch, capsys):
    """Each head re-matches at most max_refine_rounds times after its
    first match (JAX's `for _ in range(1, max_refine_rounds + 1)`): one
    find_match per lifted mask, plus exactly `rounds` re-matches per head
    for 0 and 1 (no head can stop sooner than after one), at least one
    per head for 99."""
    from wheat3dgs_tpu_torch.seg.pipeline import run_segmentation

    ctx = _context(*scene_and_model)
    calls = _counting_find_match(monkeypatch)
    capsys.readouterr()
    res = run_segmentation(ctx, str(tmp_path / "seg"), "r", verbose=True,
                           max_refine_rounds=rounds)
    log = capsys.readouterr().out
    lifted = log.count("==== lifting ")
    heads = log.count("==== head ")
    assert heads >= res["num_heads"] >= 1
    refines = len(calls) - lifted
    if rounds < 99:
        assert refines == rounds * heads
    else:
        assert refines >= heads
