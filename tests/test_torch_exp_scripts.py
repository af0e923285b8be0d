"""The port's full-length harnesses against the repo's:
wheat3dgs_tpu_torch/scripts/exp_bench2.sh against scripts/exp_bench2.sh,
and wheat3dgs_tpu_torch/scripts/exp_seg_envelope.py against
scripts/exp_seg_envelope.py.

- exp_bench2: both scripts run under bash with a stub `python` first on
  PATH that logs each call (as tests/test_torch_pipeline_scripts.py
  does). The port's calls are the root script's, in order, each app the
  port's with `--device`; the JAX watchdog's training call becomes
  apps/train_vanilla with the watchdog's checkpoint cadence (and, when a
  checkpoint exists, --start_checkpoint on the latest one), and
  metrics.py runs with the `auto:vgg` LPIPS stand-in. The port's
  generator call passes COLOR_NOISE and KNN (0.15 and exact by default);
  other values change those arguments only, and with the default SCENE
  or MODEL the script exits non-zero before it runs anything.
- exp_seg_envelope: the label-transfer scoring of the port's script and
  of the JAX script (--skip_train --skip_seg, SEG_SCENE / SEG_MODEL) on
  one tiny scene segmented by the port's run_3d_seg_app on the CPU:
  every number of the two envelope_report.json files equal. The port's
  training command takes the watchdog's cadence and resumes from the
  latest checkpoint.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_pipeline_scripts import APPS, PORT_SCRIPTS, _run_logged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cadence(iters, every=1000):
    """scripts/train_watchdog.py's --checkpoint_iterations."""
    return sorted(set(range(every, iters + 1, every)) | {iters})


def _port_call(root_call, device, iters, resume, noise="0.15",
               knn="exact"):
    argv = root_call["argv"]
    if argv == ["-"]:
        code = root_call["stdin"].replace(
            "from wheat3dgs_tpu.io", "from wheat3dgs_tpu_torch.io").replace(
            "with_masks=False)", f"with_masks=False,\n    color_noise={noise},"
            f' knn="{knn}", device="{device}")')
        return {"argv": ["-"], "stdin": code}
    if argv[0] == "scripts/train_watchdog.py":
        extra = ["--checkpoint_iterations", *map(str, _cadence(iters))]
        if resume:
            extra += ["--start_checkpoint", resume]
        return {"argv": ["-m", "wheat3dgs_tpu_torch.apps.train_vanilla",
                         *argv[1:], *extra, "--device", device]}
    if argv[0] == "metrics.py":
        argv = argv + ["--lpips_weights", "auto:vgg"]
    return {"argv": ["-m", f"wheat3dgs_tpu_torch.apps.{APPS[argv[0]]}",
                     *argv[1:], "--device", device]}


def _saves(model, iters=(7000, 15000, 30000)):
    """Stand-in saves for the renders to read (the port skips a save that
    is missing)."""
    for it in iters:
        d = model / "point_cloud" / f"iteration_{it}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "point_cloud.ply").write_text(
            "ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
            "end_header\n")


@pytest.mark.parametrize("iters,checkpoint", [
    (None, None), ("3000", None), (None, 12000)])
@pytest.mark.parametrize("device", ["cpu", None])
def test_port_exp_bench2_calls_match_root(tmp_path, iters, checkpoint,
                                          device):
    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    n = int(iters or 30000)
    _saves(tmp_path / "model", (7000, 15000, n))
    resume = None
    if checkpoint:
        for it in (checkpoint - 1000, checkpoint):
            (tmp_path / "model" / f"chkpnt{it}.npz").write_bytes(b"")
        resume = f"{model}/chkpnt{checkpoint}.npz"
    env = {"SCENE": scene, "MODEL": model} | (
        {"ITERS": iters} if iters else {})
    root = _run_logged(tmp_path, os.path.join(ROOT, "scripts",
                                              "exp_bench2.sh"), [], **env)
    port = _run_logged(tmp_path, os.path.join(PORT_SCRIPTS, "exp_bench2.sh"),
                       [], **env | ({"DEVICE": device} if device else {}))
    assert len(root) == 6
    assert port == [_port_call(c, device or "cuda", n, resume) for c in root]


@pytest.mark.parametrize("scene", [{"COLOR_NOISE": "0.05"},
                                   {"KNN": "bfloat16"},
                                   {"COLOR_NOISE": "0.05", "KNN": "bfloat16"}])
def test_port_exp_bench2_scene_reaches_the_generator(tmp_path, scene):
    env = {"SCENE": str(tmp_path / "scene"), "MODEL": str(tmp_path / "model")}
    _saves(tmp_path / "model")
    root = _run_logged(tmp_path, os.path.join(ROOT, "scripts",
                                              "exp_bench2.sh"), [], **env)
    port = _run_logged(tmp_path, os.path.join(PORT_SCRIPTS, "exp_bench2.sh"),
                       [], **env, **scene)
    assert port == [_port_call(c, "cuda", 30000, None,
                               noise=scene.get("COLOR_NOISE", "0.15"),
                               knn=scene.get("KNN", "exact"))
                    for c in root]


@pytest.mark.parametrize("scene", [{"COLOR_NOISE": "0.05"},
                                   {"KNN": "bfloat16"}])
@pytest.mark.parametrize("own", [(), ("SCENE",), ("MODEL",)])
def test_port_exp_bench2_refuses_other_scene_on_default_dirs(tmp_path, own,
                                                             scene):
    """COLOR_NOISE=0.05 or KNN=bfloat16 with the default SCENE or MODEL
    (which would reuse the default scene or model cached there): a
    non-zero exit that names both variables, before any python call or
    directory is made."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "python"
    stub.write_text(f"#!/bin/bash\necho called >> {tmp_path}/calls\n")
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               **scene, **{k: str(tmp_path / k.lower()) for k in own})
    for k in ("SCENE", "MODEL"):
        if k not in own:
            env.pop(k, None)
    before = os.path.exists(os.path.join(ROOT, "output", "exp_bench2"))
    out = subprocess.run(["bash", os.path.join(PORT_SCRIPTS,
                                               "exp_bench2.sh")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=30)
    assert out.returncode != 0
    assert "SCENE" in out.stderr and "MODEL" in out.stderr
    assert "color noise" not in out.stdout
    assert not (tmp_path / "calls").exists()
    assert sorted(os.listdir(tmp_path)) == ["bin"]
    assert os.path.exists(os.path.join(ROOT, "output",
                                       "exp_bench2")) == before


def test_port_exp_bench2_parses():
    out = subprocess.run(["bash", "-n", os.path.join(PORT_SCRIPTS,
                                                     "exp_bench2.sh")],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr


def _envelope_module():
    spec = importlib.util.spec_from_file_location(
        "port_exp_seg_envelope",
        os.path.join(PORT_SCRIPTS, "exp_seg_envelope.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("checkpoint,resumes", [
    (None, False), (3000, True), (15000, None)])
def test_envelope_train_cmd_resumes(tmp_path, checkpoint, resumes):
    env = _envelope_module()
    if checkpoint:
        for it in (1000, checkpoint):
            (tmp_path / f"chkpnt{it}.npz").write_bytes(b"")
    cmd = env.train_cmd("scene", str(tmp_path), 15000, "cpu")
    if resumes is None:
        assert cmd is None
        return
    flags = ["-s", "scene", "-m", str(tmp_path), "--eval", "--resolution",
             "1", "--iterations", "15000", "--test_iterations", "15000",
             "--save_iterations", "15000", "--checkpoint_iterations",
             *map(str, _cadence(15000))]
    if resumes:
        flags += ["--start_checkpoint",
                  str(tmp_path / f"chkpnt{checkpoint}.npz")]
    assert cmd == [sys.executable, "-m",
                   "wheat3dgs_tpu_torch.apps.train_vanilla", *flags,
                   "--device", "cpu"]
    assert env.seg_cmd("scene", "model", "cpu")[1:] == [
        "-m", "wheat3dgs_tpu_torch.apps.run_3d_seg_app", "-s", "scene",
        "-m", "model", "--exp_name", "envelope", "--iou_threshold", "0.6",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def segmented(tmp_path_factory):
    """A tiny scene with masks and its stand-in model, segmented into the
    `envelope` experiment by the port's run_3d_seg_app on the CPU."""
    from wheat3dgs_tpu_torch.apps import run_3d_seg_app
    from wheat3dgs_tpu_torch.io.synthetic import (make_synthetic_colmap_scene,
                                                  write_stand_in_model)

    base = tmp_path_factory.mktemp("envelope")
    scene, model = str(base / "scene"), str(base / "model")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        make_synthetic_colmap_scene(scene, width=64, height=48, n_heads=3,
                                    pts_per_head=80, ground_pts=400, seed=3,
                                    device="cpu")
        write_stand_in_model(model, scene, 3, 80, 400, 3, device="cpu")
        run_3d_seg_app.main(["-s", scene, "-m", model, "--exp_name",
                             "envelope", "--device", "cpu", "--quiet"])
    finally:
        torch.set_num_threads(threads)
    return scene, model


@pytest.mark.parametrize("note", [None, "partial"])
def test_envelope_scoring_matches_jax(monkeypatch, segmented, note):
    scene, model = segmented
    env = {"SEG_SCENE": scene, "SEG_MODEL": model, "SEG_HEADS": "3"}
    report = os.path.join(model, "wheat-head", "envelope",
                          "envelope_report.json")
    args = ["--skip_train", "--skip_seg", "--seg_wall", "12.5"] + (
        ["--note", note] if note else [])
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "exp_seg_envelope.py"), *args],
        env=dict(os.environ, **env), capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    with open(report) as f:
        want = json.load(f)
    os.remove(report)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _envelope_module().main(args + ["--device", "cpu"])
    with open(report) as f:
        assert json.load(f) == got
    assert got == want
    assert got["n_discovered"] >= 2 and got["per_head"]
    assert got["seg_wall_s"] == 12.5 and got["note"] == note


def test_envelope_refuses_without_card(monkeypatch, tmp_path):
    """Asked for the default device, the harness raises before it writes
    a scene."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setenv("SEG_SCENE", str(tmp_path / "scene"))
    monkeypatch.setenv("SEG_MODEL", str(tmp_path / "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _envelope_module().main([])
    assert not (tmp_path / "scene").exists()


def test_checkpoint_cost_finds_the_writes(tmp_path):
    """checkpoint_cost.py on a made-up log: 0.1 s a 100-iteration window,
    +0.25 s in each window after a multiple of 1000; the test lines are
    skipped."""
    rows = []
    for it in range(100, 5100, 100):
        t = 0.1 + (0.25 if it % 1000 == 100 and it > 1000 else 0.0)
        rows.append({"iter": it, "iters_per_sec": 100 / t, "loss": 0.1})
        if it == 3000:
            rows.append({"iter": it, "test_psnr": 30.0})
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    out = subprocess.run(
        [sys.executable, os.path.join(PORT_SCRIPTS, "checkpoint_cost.py"),
         str(path)], capture_output=True, text=True, check=True)
    got = json.loads(out.stdout)
    assert sorted(got["excess_s"]) == ["1000", "2000", "3000", "4000"]
    assert all(v == pytest.approx(0.25) for v in got["excess_s"].values())
    assert got["median_s"] == pytest.approx(0.25)
    assert got["sum_s"] == pytest.approx(1.0)
    assert got["windows"] == 49
    assert got["windows_s"] == pytest.approx(49 * 0.1 + 4 * 0.25)
