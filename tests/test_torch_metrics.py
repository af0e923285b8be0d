"""The port's metrics CLI (wheat3dgs_tpu_torch/apps/metrics_app.py)
against the JAX package's, on one small PNG tree with two methods.

Three ways to ask for LPIPS: none (LPIPS null, no note), `auto:vgg` (the
stand-in, with its LPIPS_note) and the WHEAT3DGS_LPIPS_WEIGHTS variable
naming a weights file (here a synthesized squeeze npz, so it carries the
note too). results.json and per_view.json: the same keys, names and
nulls; SSIM and PSNR within 1e-5 relative; LPIPS within 1e-5 relative
(float32 convolutions summed in another order).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from wheat3dgs_tpu.apps import metrics_app as JM
from wheat3dgs_tpu_torch.apps import metrics_app as TM
from wheat3dgs_tpu_torch.ops import lpips as TL

REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics") / "model"
    rng = np.random.default_rng(4)
    for method in ("ours_100", "ours_200"):
        for sub in ("renders", "gt"):
            os.makedirs(root / "test" / method / sub)
        for i in range(2):
            img = rng.random((36, 40, 3))
            noisy = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1)
            for sub, arr in (("gt", img), ("renders", noisy)):
                Image.fromarray((arr * 255).astype(np.uint8)).save(
                    root / "test" / method / sub / f"{i:05d}.png")
    return str(root)


def _run(main, model, argv):
    main(["-m", model] + argv)
    with open(os.path.join(model, "results.json")) as f:
        full = json.load(f)
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)
    return full, per_view


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= REL * abs(b)


@pytest.mark.parametrize("mode", ["none", "auto_vgg", "env"])
def test_metrics_match_jax(model, mode, monkeypatch, tmp_path):
    argv = []
    monkeypatch.delenv("WHEAT3DGS_LPIPS_WEIGHTS", raising=False)
    if mode == "auto_vgg":
        argv = ["--lpips_weights", "auto:vgg"]
    elif mode == "env":
        path = str(tmp_path / "squeeze.npz")
        TL.synthesize_lpips_weights(path, "squeeze", seed=2)
        monkeypatch.setenv("WHEAT3DGS_LPIPS_WEIGHTS", path)
    j_full, j_view = _run(JM.main, model, argv)
    t_full, t_view = _run(TM.main, model, argv + ["--device", "cpu"])

    assert sorted(t_full) == sorted(j_full) == ["ours_100", "ours_200"]
    for method, ref in j_full.items():
        got = t_full[method]
        assert sorted(got) == sorted(ref)
        assert got.get("LPIPS_note") == ref.get("LPIPS_note")
        assert (mode == "none") == (ref["LPIPS"] is None)
        assert ("LPIPS_note" in ref) == (mode != "none")
        for k in ("SSIM", "PSNR", "LPIPS"):
            assert _close(got[k], ref[k]), (method, k, got[k], ref[k])
        assert sorted(t_view[method]) == sorted(j_view[method])
        for k, per in j_view[method].items():
            assert sorted(t_view[method][k]) == sorted(per) == \
                ["00000.png", "00001.png"]
            for name, v in per.items():
                assert _close(t_view[method][k][name], v), (method, k, name)


def test_metrics_skip_eval_outputs(model, monkeypatch, tmp_path):
    """eval_wheatgs_app writes test/{segmentation,overlay}/ PNGs beside
    the method dirs. The port's metrics app skips dirs without renders/
    and scores the methods as before; JAX's stops on them, so the root
    eval.sh fails on a model that has been through run_wheat_3dgs.sh."""
    import shutil

    monkeypatch.delenv("WHEAT3DGS_LPIPS_WEIGHTS", raising=False)
    j_full, _ = _run(JM.main, model, [])
    tree = str(tmp_path / "model")
    shutil.copytree(model, tree)
    for sub in ("segmentation", "overlay"):
        os.makedirs(os.path.join(tree, "test", sub))
        Image.fromarray(np.zeros((36, 40, 3), np.uint8)).save(
            os.path.join(tree, "test", sub, "plot_000_11.png"))
    t_full, _ = _run(TM.main, tree, ["--device", "cpu"])
    assert sorted(t_full) == sorted(j_full)
    for method, ref in j_full.items():
        for k in ("SSIM", "PSNR"):
            assert _close(t_full[method][k], ref[k]), (method, k)
    with pytest.raises(FileNotFoundError):
        JM.main(["-m", tree])
