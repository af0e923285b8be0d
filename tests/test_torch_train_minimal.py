"""The port's minimal trainer (apps/train_minimal.py) against the repo's
root test.py, the JAX package's minimal training script.

Both CLIs run 12 iterations from `seed_everything(0)` on a tiny scene made
by the port's generator (10 train views, so the view stack refills once):
- the train views they draw, in order, are equal (`random.randint` pops
  from a stack refilled when empty);
- the first step's loss agrees within rel 1e-4, the tolerance of
  tests/test_torch_training.py (JAX's Trainer on its XLA backend with the
  port's 32-pixel tiles and caps that crop nothing, as there), and the
  losses of the first 5 steps within rel 1e-3: the scene's black points
  put colour channels within an ulp of the SH colour clamp at 0, where
  the two packages' rounding falls on either side; a channel clamped in
  one and not the other gets a zero gradient in one and a non-zero one
  in the other, and Adam's first update moves it by a full learning rate
  (sh_dc 0.0025) in one package only;
- the saved trees hold the same files: input.ply and cameras.json equal,
  cfg_args equal but for the model path and data_device's default, and
  each saved point_cloud.ply with the same splat count and header.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from wheat3dgs_tpu import scene as JS
from wheat3dgs_tpu import training as JT
from wheat3dgs_tpu.io.ply import read_ply
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu_torch import scene as TS
from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch.apps import train_minimal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("train_minimal") / "scene")
    make_synthetic_colmap_scene(out, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=300,
                                device="cpu")
    return out


def _root_test_py():
    spec = importlib.util.spec_from_file_location(
        "root_minimal_trainer", os.path.join(ROOT, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(monkeypatch, scene_cls, trainer_cls):
    views, losses = [], []
    cam_arrays, step = scene_cls.cam_arrays, trainer_cls.step

    def rec_cam(self, split, idx):
        views.append(idx)
        return cam_arrays(self, split, idx)

    def rec_step(self, *a, **k):
        m = step(self, *a, **k)
        losses.append(float(m["loss"]))
        return m

    monkeypatch.setattr(scene_cls, "cam_arrays", rec_cam)
    monkeypatch.setattr(trainer_cls, "step", rec_step)
    return views, losses


def test_train_minimal_matches_root_test_py(tiny_scene, tmp_path,
                                            monkeypatch):
    common = ["-s", tiny_scene, "--iterations", str(ITERS),
              "--save_iterations", "5", "--quiet"]
    jinit = JT.Trainer.__init__

    def xla_init(self, *a, **k):
        # Caps that crop nothing in this scene, kept for every view (the
        # XLA backend's occupancy probe would size them from view 1 alone).
        k.setdefault("config", JConfig(tile=32, max_tiles_per_gauss=64,
                                       max_per_tile=512, backend="xla"))
        k.setdefault("adaptive_occupancy", False)
        jinit(self, *a, **k)

    monkeypatch.setattr(JT.Trainer, "__init__", xla_init)
    jviews, jlosses = _record(monkeypatch, JS.Scene, JT.Trainer)
    jdir = str(tmp_path / "jax")
    _root_test_py().main(common + ["-m", jdir])

    tviews, tlosses = _record(monkeypatch, TS.Scene, TT.Trainer)
    tdir = str(tmp_path / "port")
    train_minimal.main(common + ["-m", tdir, "--device", "cpu"])

    assert len(tviews) == ITERS and tviews == jviews
    assert sorted(tviews[:10]) == list(range(10))     # one full epoch
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-4)
    np.testing.assert_allclose(tlosses[:5], jlosses[:5], rtol=1e-3)
    assert np.isfinite(tlosses).all()

    def tree(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert tree(tdir) == tree(jdir) == sorted([
        "cameras.json", "cfg_args", "input.ply",
        os.path.join("point_cloud", "iteration_5", "point_cloud.ply"),
        os.path.join("point_cloud", f"iteration_{ITERS}",
                     "point_cloud.ply")])
    for f in ("input.ply",):
        assert open(os.path.join(tdir, f), "rb").read() == open(
            os.path.join(jdir, f), "rb").read()
    jc = json.load(open(os.path.join(jdir, "cameras.json")))
    tc = json.load(open(os.path.join(tdir, "cameras.json")))
    assert [c["img_name"] for c in tc] == [c["img_name"] for c in jc]
    np.testing.assert_allclose([c["position"] for c in tc],
                               [c["position"] for c in jc], rtol=1e-6)
    # Equal up to the model path and ModelParams.data_device's default.
    assert open(os.path.join(tdir, "cfg_args")).read().replace(
        tdir, "M").replace("data_device='cuda'", "D") == open(
        os.path.join(jdir, "cfg_args")).read().replace(jdir, "M").replace(
        "data_device='tpu'", "D")
    for it in (5, ITERS):
        p = os.path.join("point_cloud", f"iteration_{it}", "point_cloud.ply")
        jv, tv = read_ply(os.path.join(jdir, p)), read_ply(
            os.path.join(tdir, p))
        assert list(tv) == list(jv)
        assert len(tv["x"]) == len(jv["x"]) > 0


def test_train_minimal_refuses_without_card(tiny_scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_minimal.main(["-s", tiny_scene, "-m", str(tmp_path / "m")])
