"""The port's pipeline scripts (wheat3dgs_tpu_torch/scripts/run_wheat_3dgs.sh
and eval.sh) against the repo's root scripts, and the port's morphology on
heads that its own segmentation wrote.

- Both pairs of scripts run under bash with a stub `python` first on PATH
  that logs each call's argv (and its stdin for `python -`): the port's
  calls are the root scripts' steps, flags and order, each script mapped
  to the port's app with `--device`; step 5's program is the root one on
  the port's package with the device. Both pass `bash -n`.
- run_pipeline on the wh_*.ply heads of the port's run_3d_seg_app on a
  tiny CPU scene, against the JAX package's run_pipeline on the same
  heads, at the reference config and at one scaled to the tiny heads:
  every xlsx cell, the boxes and the merged PLY.
"""

import os
import subprocess
import warnings

import pytest
import torch

from test_torch_morphology_pipeline import REF_CFG, _compare_outputs
from wheat3dgs_tpu.morphology import run_pipeline as j_run
from wheat3dgs_tpu_torch.morphology import run_pipeline as t_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts")
APPS = {"train_vanilla_3dgs.py": "train_vanilla", "render.py": "render_sets",
        "metrics.py": "metrics_app", "run_3d_seg.py": "run_3d_seg_app",
        "eval_wheatgs.py": "eval_wheatgs_app",
        "render_360.py": "render_360_app"}

# The stub `python`: a shell script (an interpreter start per call would
# cost seconds on a loaded machine) that appends each call's arguments,
# each ended by \037, then for `python -` \035 and its stdin, then \036.
STUB = """#!/bin/sh
for a in "$@"; do printf '%s\\037' "$a" >> "$STUB_LOG"; done
if [ "$1" = "-" ]; then printf '\\035' >> "$STUB_LOG"; cat >> "$STUB_LOG"; fi
printf '\\036' >> "$STUB_LOG"
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_logged(tmp_path, script, args, **env):
    """Run `script` under bash with the stub python first on PATH; the
    logged calls."""
    bindir = tmp_path / "bin"
    if not bindir.exists():
        bindir.mkdir()
        stub = bindir / "python"
        stub.write_text(STUB)
        stub.chmod(0o755)
    log = tmp_path / f"{len(list(tmp_path.glob('*.log')))}.log"
    log.write_text("")
    full = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
                STUB_LOG=str(log), **env)
    out = subprocess.run(["bash", script, *args], cwd=tmp_path, env=full,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    calls = []
    for rec in log.read_text().split("\036")[:-1]:
        argv, sep, stdin = rec.partition("\035")
        call = {"argv": argv.split("\037")[:-1]}
        if sep:
            call["stdin"] = stdin
        calls.append(call)
    return calls


def _port_call(root_call, device):
    """The port's counterpart of one of the root scripts' calls."""
    argv = root_call["argv"]
    if argv == ["-"]:
        code = root_call["stdin"].replace(
            "from wheat3dgs_tpu.morphology", "from wheat3dgs_tpu_torch."
            "morphology").replace("\n})\n", f'\n}}, device="{device}")\n')
        return {"argv": ["-"], "stdin": code}
    return {"argv": ["-m", f"wheat3dgs_tpu_torch.apps.{APPS[argv[0]]}",
                     *argv[1:], "--device", device]}


@pytest.mark.parametrize("script,args", [
    ("run_wheat_3dgs.sh", ["data", "model", "exp1", "0.7"]),
    ("run_wheat_3dgs.sh", ["data", "model"]),
    ("eval.sh", ["data", "model", "exp1"]),
])
@pytest.mark.parametrize("device", ["cpu", None])
def test_port_script_calls_match_root_script(tmp_path, script, args, device):
    root = _run_logged(tmp_path, os.path.join(ROOT, script), args,
                       ITERS="30")
    env = {"ITERS": "30"} | ({"DEVICE": device} if device else {})
    port = _run_logged(tmp_path, os.path.join(PORT_SCRIPTS, script), args,
                       **env)
    assert len(root) == (8 if script == "run_wheat_3dgs.sh" else 3)
    assert port == [_port_call(c, device or "cuda") for c in root]
    if script == "run_wheat_3dgs.sh":
        exp = args[2] if len(args) > 2 else "default"
        assert (tmp_path / "model" / "wheat-head" / exp /
                "morphology").is_dir()


@pytest.mark.parametrize("script", ["run_wheat_3dgs.sh", "eval.sh"])
def test_port_scripts_parse(script):
    out = subprocess.run(["bash", "-n", os.path.join(PORT_SCRIPTS, script)],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def seg_heads(tmp_path_factory):
    """The wh_*.ply heads of the port's run_3d_seg_app on the tiny CPU
    scene with a stand-in model."""
    from wheat3dgs_tpu_torch.apps import run_3d_seg_app
    from wheat3dgs_tpu_torch.io.synthetic import (make_synthetic_colmap_scene,
                                                  write_stand_in_model)

    base = tmp_path_factory.mktemp("seg_heads")
    scene, model = str(base / "scene"), str(base / "model")
    # One thread here too: a module fixture runs before _one_thread, and
    # on a loaded machine the segmentation took minutes with eight.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        make_synthetic_colmap_scene(scene, width=64, height=48, n_heads=3,
                                    pts_per_head=80, ground_pts=400, seed=3,
                                    device="cpu")
        write_stand_in_model(model, scene, 3, 80, 400, 3, device="cpu")
        run_3d_seg_app.main(["-s", scene, "-m", model, "--exp_name", "e",
                             "--device", "cpu", "--quiet"])
    finally:
        torch.set_num_threads(threads)
    heads = os.path.join(model, "wheat-head", "e", "ply")
    assert len([f for f in os.listdir(heads) if f.startswith("wh_")]) >= 2
    return heads


@pytest.mark.parametrize("scaled", [False, True])
def test_run_pipeline_matches_jax_on_seg_heads(tmp_path, seg_heads, scaled):
    over = ({"clusterer_definition": {"type": "hdbscan", "min_samples": 5,
                                      "min_cluster_size": 20,
                                      "epsilon_hdbscan": 0.0},
             "sor_parameters": {"k": 20, "std_ratio": 3}} if scaled else {})
    outs = []
    for name, run in (("jax", j_run), ("port", t_run)):
        out = tmp_path / name
        out.mkdir()
        cfg = dict(REF_CFG, data_folder=seg_heads, output_folder=str(out),
                   **over)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            outs.append(run(cfg) if name == "jax" else run(cfg, "cpu"))
    assert _compare_outputs(*outs, rel=None)
    assert os.path.basename(outs[1]).startswith("ply_")
