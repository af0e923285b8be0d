"""The port's envelope family of root harnesses against the repo's root
scripts, and wheat3dgs_tpu_torch/scripts/tpu_numerics.py, on the CPU.

- exp_morph_compare.py: a tiny gt_points.npz (four heads of 700-1,500
  points and a ground), each discovered head a jittered subset of its GT
  head plus outliers, and an envelope report with pairs above and below
  IoU 0.3, an unmatched id and a missing PLY. JAX's script runs first as a
  subprocess (a copy whose /tmp/morph_compare.json is moved into the
  test's directory) and its file is read before the port writes its own:
  the two files are equal, every number and row. `--against` finds no
  difference on the GT side and exits non-zero on one.
- diag_psnr_decline.py: a tiny model trained by the port's CLI and saved
  at two iterations, scored by JAX's script (a subprocess) and the port's:
  n_splats equal, each split's PSNR within DIAG_PSNR_DB. On the CPU JAX's
  inference_config picks its padded-tile path at 16-px tiles and the port
  renders the entry stream at 32 px, so the images may differ by the
  tile-size effect (ROADMAP C; 7e-4 dB at most on this model); JAX reports
  no demand there, so the port's demand / budget is held to <= 1 on its
  side only. Both print the same verdict.
- exp_seg_sweep.py: JAX's sweep (a subprocess) and the port's on one
  JAX-written scene and "trained" model at IoU 0.5 and 0.6. JAX's sweep
  renders at its default 16-px tiles, the port at 32 px; on this scene
  the tile size moves nothing: per threshold the same JSON line but the
  wall time, the same report and the same results.csv rows (the Gaussian
  count within 1%, as test_torch_seg_eval holds run_segmentation). The
  0.6 row is also held to the port's own run_3d_seg_app at its default
  threshold (the same head count, results.csv and head PLYs, its report
  the label transfer of the app's artifacts).
- exp_seg360_morph.sh and exp_round5_final.sh: both pairs run under bash
  with a stub `python` first on PATH that logs each call
  (test_torch_pipeline_scripts._run_logged). The JAX scripts run from a
  copy whose /tmp paths are moved into the test's directory (JAX's chain
  also copies its report into its own docs/quality). The port's calls are
  JAX's, in order, each app the port's with `--device`, the same
  morphology YAML; the watchdog's seg call is the seg app (through
  tpu_numerics.py off the default numerics); the skips on an existing
  checkpoint or segmentation are JAX's.
- exp_seg_envelope.py: off the default SEG_KNN / SEG_BF16_GRADS / SEG_SEED
  its training and seg commands go through tpu_numerics.py with the
  matching flags, and the default SEG_SCENE or SEG_MODEL is refused;
  `--per_gt` reads a report by ground-truth head.
- tpu_numerics.py: train_seed(n) changes a densify step's split noise and
  train_seed(0) is the default; the runner enters every patch around the
  app's main and restores them; bf16_grads rounds the rows as JAX's
  astype(bfloat16).astype(float32), bit for bit (ties to even, subnormals,
  infinities); the runner trains a tiny scene.
- Asked for the default device without a card, every new script and the
  runner raise before they write anything.
"""

import ast
import csv
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_pipeline_scripts import APPS, PORT_SCRIPTS, _run_logged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
# Mean PSNR of a split, JAX's 16-px padded tiles against the port's 32-px
# entry stream (the tile-size effect on a 64x48 view; 7e-4 dB measured).
DIAG_PSNR_DB = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"port_{name}", os.path.join(PORT_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_copy(tmp_path, *names):
    """Copies of the root scripts `names` under tmp_path/jax/scripts, each
    /tmp/ path moved to tmp_path/jaxtmp/."""
    d = tmp_path / "jax" / "scripts"
    d.mkdir(parents=True, exist_ok=True)
    (tmp_path / "jaxtmp").mkdir(exist_ok=True)
    for n in names:
        text = open(os.path.join(ROOT, "scripts", n)).read()
        (d / n).write_text(text.replace("/tmp/", f"{tmp_path}/jaxtmp/"))
    return d


# --- exp_morph_compare ---------------------------------------------------

def _head(rng, n, center):
    axis = np.array([0.1, 0.05, 1.0])
    axis /= np.linalg.norm(axis)
    t = rng.normal(0, 1.0, n)
    return (center + axis[None] * (t[:, None] * 0.09)
            + rng.normal(0, 0.025, (n, 3)))


@pytest.fixture(scope="module")
def morph_inputs(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.ply import write_ply

    rng = np.random.default_rng(5)
    base = tmp_path_factory.mktemp("morph")
    scene, model = base / "scene", base / "model"
    scene.mkdir()
    sizes = {1: 700, 2: 1500, 3: 1000, 4: 900}
    pts = [np.c_[rng.uniform(-1, 1, (3000, 2)), rng.normal(0, 0.02, 3000)]]
    ids = [np.zeros(3000, np.int32)]
    for h, n in sizes.items():
        pts.append(_head(rng, n, np.array([0.4 * h - 1.0, 0.2, 0.45])))
        ids.append(np.full(n, h, np.int32))
    pts = np.concatenate(pts).astype(np.float32)
    ids = np.concatenate(ids)
    np.savez_compressed(scene / "gt_points.npz", points=pts, head_id=ids)
    exp = model / "wheat-head" / "envelope"
    for pred, gt in ((1, 1), (2, 2), (3, 3), (4, 4)):
        own = pts[ids == gt]
        keep = own[rng.random(len(own)) < 0.85]
        keep = keep + rng.normal(0, 0.004, keep.shape)
        out = rng.uniform(-0.6, 0.6, (40, 3)) + own.mean(0)
        xyz = np.concatenate([keep, out]).astype(np.float32)
        write_ply(str(exp / "ply" / f"wh_{pred:04d}.ply"),
                  {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]})
    per_head = [
        {"pred_id": 1, "gt_id": 1, "iou": 0.52},
        {"pred_id": 2, "gt_id": 2, "iou": 0.31},
        {"pred_id": 3, "gt_id": 3, "iou": 0.77},
        {"pred_id": 4, "gt_id": 4, "iou": 0.21},    # under 0.3: skipped
        {"pred_id": 5, "gt_id": -1, "iou": 0.0},    # unmatched
        {"pred_id": 6, "gt_id": 1, "iou": 0.45},    # no PLY
    ]
    with open(exp / "envelope_report.json", "w") as f:
        json.dump({"per_head": per_head}, f)
    return str(scene), str(model)


def test_morph_compare_matches_jax(morph_inputs, tmp_path, monkeypatch):
    scene, model = morph_inputs
    d = _jax_copy(tmp_path, "exp_morph_compare.py")
    env = dict(JAX_ENV, SEG_SCENE=scene, SEG_MODEL=model, EXP="envelope")
    out = subprocess.run([sys.executable, str(d / "exp_morph_compare.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    with open(tmp_path / "jaxtmp" / "morph_compare.json") as f:
        want = json.load(f)
    for k in ("SEG_SCENE", "SEG_MODEL"):
        monkeypatch.setenv(k, env[k])
    mc = _script("exp_morph_compare")
    port = str(tmp_path / "port.json")
    got = mc.main(["--out", port, "--device", "cpu"])
    with open(port) as f:
        assert json.load(f) == got
    assert got == want
    assert got["n_pairs"] == 3 and sorted(r["gt_id"] for r in got["rows"]) \
        == [1, 2, 3]
    assert all(r["n_gt"] > 402 for r in got["rows"])
    # The ground truth held to another run's file.
    mc.main(["--out", port, "--device", "cpu", "--against", port])
    other = dict(want, rows=[dict(r) for r in want["rows"]])
    other["rows"][1]["gt_width"] += 1e-5
    bad = tmp_path / "other.json"
    bad.write_text(json.dumps(other))
    with pytest.raises(SystemExit):
        mc.main(["--out", port, "--device", "cpu", "--against", str(bad)])
    shared, diff = mc.gt_mismatches(got["rows"], other["rows"])
    assert shared == [1, 2, 3] and diff == [
        (2, "width", got["rows"][1]["gt_width"],
         other["rows"][1]["gt_width"])]


# --- diag_psnr_decline ---------------------------------------------------

@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """A tiny scene and the port's CLI run saved at iterations 20 and 40."""
    from wheat3dgs_tpu_torch.apps import train_vanilla
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    base = tmp_path_factory.mktemp("diag")
    scene, model = str(base / "scene"), str(base / "model")
    torch.set_num_threads(1)
    make_synthetic_colmap_scene(scene, width=64, height=48, n_heads=2,
                                pts_per_head=60, ground_pts=300,
                                with_masks=False, device="cpu")
    train_vanilla.main(["-s", scene, "-m", model, "--eval", "--iterations",
                        "40", "--densify_from_iter", "10",
                        "--densification_interval", "20",
                        "--test_iterations", "40", "--save_iterations",
                        "20", "40", "--device", "cpu", "--quiet"])
    return scene, model


def _diag_rows(text):
    return [ast.literal_eval(ln) for ln in text.splitlines()
            if ln.startswith("{'iteration'")]


def test_diag_psnr_decline_matches_jax(saved_model, capsys):
    _, model = saved_model
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "diag_psnr_decline.py"),
         "-m", model, "--iterations", "20", "40"],
        env=JAX_ENV, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    want = _diag_rows(out.stdout)
    capsys.readouterr()
    got = _script("diag_psnr_decline").main(
        ["-m", model, "--iterations", "20", "40", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert _diag_rows(printed) == got
    assert [r["iteration"] for r in got] == [20, 40] == [
        r["iteration"] for r in want]
    for g, w in zip(got, want):
        assert g["n_splats"] == w["n_splats"]
        for split in ("train", "test"):
            assert abs(g[f"{split}_psnr"] - w[f"{split}_psnr"]) \
                <= DIAG_PSNR_DB, (split, g, w)
            assert 0 < g[f"{split}_demand_over_budget"] <= 1.0
            assert w[f"{split}_demand_over_budget"] == 0.0
    verdict = [ln for ln in out.stdout.splitlines()
               if ln.startswith("VERDICT")]
    assert verdict and verdict[0] in printed
    assert "| iteration | n_splats | train PSNR |" in printed


@pytest.mark.parametrize("tr,te,crop,h", [
    ((40.0, 42.0), (38.0, 37.0), 0.8, "(H1)"),
    ((40.0, 42.0), (38.0, 37.0), 1.2, "(H2)"),
    ((40.0, 39.0), (38.0, 37.0), 0.8, "(H3)"),
    ((40.0, 40.1), (38.0, 38.2), 0.8, "stale-budget"),
])
def test_diag_verdict_is_jax_rule(tr, te, crop, h):
    rows = [{"train_psnr": a, "test_psnr": b,
             "train_demand_over_budget": crop,
             "test_demand_over_budget": 0.5} for a, b in zip(tr, te)]
    assert h in _script("diag_psnr_decline").verdict(rows)


# --- exp_seg_sweep -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A JAX-written scene with masks and a JAX-written "trained" model
    (the generator's splats, no head ids), as test_torch_seg_eval's."""
    import dataclasses

    import jax.numpy as jnp

    from wheat3dgs_tpu import config as jcfg
    from wheat3dgs_tpu.io import synthetic as JY
    from wheat3dgs_tpu.models import serialization as JSer

    root = tmp_path_factory.mktemp("sweep")
    scene_dir, model_dir = str(root / "scene"), str(root / "model")
    kw = dict(width=64, height=48, n_heads=3, pts_per_head=100,
              ground_pts=500, seed=3)
    JY.make_synthetic_colmap_scene(scene_dir, **kw)
    state = JY._build_gt_scene(kw["width"], kw["height"], 12, kw["n_heads"],
                               kw["pts_per_head"], kw["ground_pts"],
                               kw["seed"], 2.2, 40.0, None)[4]
    state = dataclasses.replace(state,
                                instance_id=jnp.zeros_like(state.instance_id))
    JSer.save_ply(state, os.path.join(model_dir, "point_cloud",
                                      "iteration_100", "point_cloud.ply"))
    jcfg.save_cfg_args(model_dir, jcfg.ModelParams(source_path=scene_dir,
                                                   model_path=model_dir))
    return scene_dir, model_dir


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_seg_sweep_matches_app_and_jax(jax_scene, tmp_path, monkeypatch):
    from wheat3dgs_tpu_torch.apps import run_3d_seg_app

    scene, model = jax_scene
    models = {k: str(tmp_path / k) for k in ("jax", "port", "app")}
    for m in models.values():
        shutil.copytree(model, m)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "exp_seg_sweep.py"),
         "--thresholds", "0.5,0.6"],
        env=dict(JAX_ENV, SEG_SCENE=scene, SEG_MODEL=models["jax"]),
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    want = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    monkeypatch.setenv("SEG_SCENE", scene)
    monkeypatch.setenv("SEG_MODEL", models["port"])
    got = _script("exp_seg_sweep").main(["--thresholds", "0.5,0.6",
                                         "--device", "cpu"])
    assert [r["iou_threshold"] for r in got] == [0.5, 0.6] == [
        r["iou_threshold"] for r in want]
    for g, w in zip(got, want):
        exp = f"env_iou{int(round(g['iou_threshold'] * 100)):02d}"
        base = {k: os.path.join(m, "wheat-head", exp)
                for k, m in models.items()}
        assert list(g) == list(w) and {
            k: v for k, v in g.items() if k != "seg_wall_s"} == {
            k: v for k, v in w.items() if k != "seg_wall_s"}
        reps = {}
        for k in ("jax", "port"):
            with open(os.path.join(base[k], "envelope_report.json")) as f:
                reps[k] = {k2: v for k2, v in json.load(f).items()
                           if k2 != "seg_wall_s"}
        assert reps["port"] == reps["jax"] and reps["port"]["per_head"]
        j_rows = _csv(os.path.join(base["jax"], "results.csv"))
        t_rows = _csv(os.path.join(base["port"], "results.csv"))
        assert len(t_rows) == len(j_rows) >= 3
        for a, b in zip(j_rows[1:], t_rows[1:]):
            assert b[:3] == a[:3]
            assert abs(int(b[3]) - int(a[3])) <= 0.01 * int(a[3])

    # The sweep's shared SegContext against the app at its default 0.6.
    app = run_3d_seg_app.main(["-s", scene, "-m", models["app"],
                               "--exp_name", "env_iou60", "--device", "cpu",
                               "--quiet"])
    assert got[1]["n_discovered"] == app["num_heads"] >= 2
    assert _csv(os.path.join(base["port"], "results.csv")) == _csv(
        os.path.join(base["app"], "results.csv"))
    assert sorted(os.listdir(os.path.join(base["port"], "ply"))) == \
        sorted(os.listdir(os.path.join(base["app"], "ply")))
    _, seen, rows, claimed, dup = _script(
        "exp_seg_envelope").label_transfer(scene, base["app"])
    assert reps["port"]["per_head"] == [
        {"pred_id": r[0], "gt_id": r[1], "iou": round(r[2], 4),
         "precision": round(r[3], 4), "recall": round(r[4], 4),
         "splat_purity": round(r[5], 4)} for r in rows]
    assert (reps["port"]["n_discovered"], reps["port"]["n_matched_gt"],
            reps["port"]["duplicate_id_count"]) == (len(seen), len(claimed),
                                                    dup)


# --- the chain scripts under a stub python -------------------------------

def _morph_yaml(calls):
    """The config file each logged morphology call names, read now."""
    for c in calls:
        if "--config" in c["argv"] or "-c" in c["argv"]:
            i = c["argv"].index("--config" if "--config" in c["argv"]
                                else "-c")
            return open(c["argv"][i + 1]).read()
    return None


def _seg360_port(call, device, yaml_path):
    argv = call["argv"]
    app = os.path.basename(argv[0])
    if app == "main.py":
        return {"argv": ["-m", "wheat3dgs_tpu_torch.apps.morphology_app",
                         "-c", yaml_path, "--device", device]}
    return {"argv": ["-m", f"wheat3dgs_tpu_torch.apps.{APPS[app]}",
                     *argv[1:], "--device", device]}


def _model_tree(tmp_path):
    scene, model = tmp_path / "scene", tmp_path / "model"
    scene.mkdir(exist_ok=True)
    exp = model / "wheat-head" / "envelope"
    (exp / "ply").mkdir(parents=True, exist_ok=True)
    (exp / "envelope_report.json").write_text("{}")
    return str(scene), str(model)


@pytest.mark.parametrize("device", ["cpu", None])
def test_seg360_morph_calls_match_root(tmp_path, device):
    scene, model = _model_tree(tmp_path)
    d = _jax_copy(tmp_path, "exp_seg360_morph.sh")
    out_dir = str(tmp_path / "morph_out")
    env = {"SEG_SCENE": scene, "SEG_MODEL": model, "MORPH_OUT": out_dir,
           "FRAMES": "20", "HEAD_FRAMES": "10"}
    root = _run_logged(tmp_path, str(d / "exp_seg360_morph.sh"), [], **env)
    want_yaml = _morph_yaml(root)
    port = _run_logged(tmp_path, os.path.join(PORT_SCRIPTS,
                                              "exp_seg360_morph.sh"), [],
                       **env, **({"DEVICE": device} if device else {}))
    yaml_path = os.path.join(out_dir, "morph_envelope3.yaml")
    assert len(root) == 3
    assert port == [_seg360_port(c, device or "cuda", yaml_path)
                    for c in root]
    assert open(yaml_path).read() == want_yaml


def _round5_port(call, device, numerics, model):
    """The port's counterpart of one of JAX's chain calls."""
    argv = call["argv"]
    name = os.path.basename(argv[0])
    if name == "exp_seg_envelope.py":
        return {"argv": [os.path.join(PORT_SCRIPTS, name), *argv[1:],
                         "--iters", "15000", "--device", device]}
    if name == "seg_watchdog.py":
        seg = argv[argv.index("run_3d_seg.py") + 1:]
        lead = ["-m", "wheat3dgs_tpu_torch.apps.run_3d_seg_app"]
        if numerics:
            lead = [os.path.join(PORT_SCRIPTS, "tpu_numerics.py")] + (
                ["--bf16_grads"] if numerics["SEG_BF16_GRADS"] == "1"
                else []) + ["--", "wheat3dgs_tpu_torch.apps.run_3d_seg_app"]
        return {"argv": [*lead, *seg, "--device", device]}
    if name == "exp_morph_compare.py":
        return {"argv": [os.path.join(PORT_SCRIPTS, name), "--out",
                         os.path.join(model, "wheat-head", "envelope",
                                      "morph_compare.json"),
                         "--device", device]}
    return _seg360_port(call, device, os.path.join(
        model, "wheat-head", "envelope", "morph_envelope_results",
        "morph_envelope3.yaml"))


def _wall_free(calls):
    """The calls with step 3's --seg_wall value (a wall time) blanked."""
    out = []
    for c in calls:
        a = list(c["argv"])
        if "--skip_train" in a:
            a[a.index("--seg_wall") + 1] = "S"
        out.append({"argv": a})
    return out


@pytest.mark.parametrize("done", ["nothing", "trained", "segmented"])
@pytest.mark.parametrize("numerics", [
    None, {"SEG_KNN": "bfloat16", "SEG_BF16_GRADS": "1", "SEG_SEED": "0"},
    {"SEG_KNN": "exact", "SEG_BF16_GRADS": "0", "SEG_SEED": "2"}])
@pytest.mark.parametrize("device", ["cpu", None])
def test_round5_chain_calls_match_root(tmp_path, device, numerics, done):
    scene, model = _model_tree(tmp_path)
    if done in ("trained", "segmented"):
        open(os.path.join(model, "chkpnt15000.npz"), "w").close()
    if done == "segmented":
        open(os.path.join(model, "wheat-head", "envelope", "gaussians.ply"),
             "w").close()
    d = _jax_copy(tmp_path, "exp_round5_final.sh", "exp_seg360_morph.sh")
    (d.parent / "docs" / "quality").mkdir(parents=True)
    env = {"SEG_SCENE": scene, "SEG_MODEL": model}
    root = _run_logged(tmp_path, str(d / "exp_round5_final.sh"), [], **env)
    port = _run_logged(tmp_path, os.path.join(PORT_SCRIPTS,
                                              "exp_round5_final.sh"), [],
                       **env, **(numerics or {}),
                       **({"DEVICE": device} if device else {}))
    assert len(root) == {"nothing": 7, "trained": 6, "segmented": 5}[done]
    assert _wall_free(port) == _wall_free(
        [_round5_port(c, device or "cuda", numerics, model)
         for c in root])


@pytest.mark.parametrize("script", ["exp_seg360_morph.sh",
                                    "exp_round5_final.sh"])
def test_chain_scripts_parse(script):
    out = subprocess.run(["bash", "-n", os.path.join(PORT_SCRIPTS, script)],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr


# --- exp_seg_envelope's numerics -----------------------------------------

@pytest.mark.parametrize("knn,bf16,seed,train_flags,seg_flags", [
    ("bfloat16", "1", "0", ["--tpu_knn", "--bf16_grads", "--seed", "0"],
     ["--bf16_grads"]),
    ("bfloat16", "0", "0", ["--tpu_knn", "--seed", "0"], []),
    ("exact", "1", "2", ["--bf16_grads", "--seed", "2"], ["--bf16_grads"]),
    ("exact", "0", "1", ["--seed", "1"], []),
])
def test_envelope_numerics_route_through_runner(tmp_path, monkeypatch, knn,
                                                bf16, seed, train_flags,
                                                seg_flags):
    env = _script("exp_seg_envelope")
    monkeypatch.setenv("SEG_KNN", knn)
    monkeypatch.setenv("SEG_BF16_GRADS", bf16)
    monkeypatch.setenv("SEG_SEED", seed)
    monkeypatch.setenv("SEG_SCENE", str(tmp_path / "scene"))
    monkeypatch.setenv("SEG_MODEL", str(tmp_path / "model"))
    s = env.settings()
    num = env.numerics(s)
    assert num == {"knn": knn, "bf16_grads": bf16 == "1", "seed": int(seed)}
    runner = os.path.join(PORT_SCRIPTS, "tpu_numerics.py")
    default_train = env.train_cmd("scene", str(tmp_path), 15000, "cpu")
    cmd = env.train_cmd("scene", str(tmp_path), 15000, "cpu", num)
    assert cmd == [sys.executable, runner, *train_flags, "--",
                   "wheat3dgs_tpu_torch.apps.train_vanilla",
                   *default_train[3:]]
    assert env.seg_cmd("scene", "model", "cpu", num) == [
        sys.executable, runner, *seg_flags, "--",
        "wheat3dgs_tpu_torch.apps.run_3d_seg_app",
        *env.seg_cmd("scene", "model", "cpu")[3:]]
    assert env.numerics_note(num) == (f"tpu_numerics: knn={knn}, "
                                      f"bf16_grads={bf16}, seed={seed}")
    for var in ("SEG_SCENE", "SEG_MODEL"):
        monkeypatch.delenv(var)
        with pytest.raises(SystemExit, match="needs its own SEG_SCENE"):
            env.main(["--device", "cpu"])
        monkeypatch.setenv(var, str(tmp_path / var))
    assert not (tmp_path / "scene").exists()


def test_envelope_per_gt_reading(tmp_path, capsys):
    rows = [{"pred_id": 1, "gt_id": 3, "iou": 0.6},
            {"pred_id": 2, "gt_id": 3, "iou": 0.02},
            {"pred_id": 3, "gt_id": 5, "iou": 0.3},
            {"pred_id": 4, "gt_id": -1, "iou": 0.0}]
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"per_head": rows}))
    got = _script("exp_seg_envelope").main(["--per_gt", str(path)])
    assert got == {str(path): {
        "ids": 4, "unmatched": 1, "fragments": 2, "gt_best_iou_mean": 0.45,
        "gt_best_iou_median": 0.45, "gt_best_iou_ge_0.5": 1}}
    assert str(path) in capsys.readouterr().out


def test_envelope_default_numerics_and_bad_knn(monkeypatch):
    env = _script("exp_seg_envelope")
    for k in ("SEG_KNN", "SEG_BF16_GRADS", "SEG_SEED"):
        monkeypatch.delenv(k, raising=False)
    assert env.numerics(env.settings()) is None
    monkeypatch.setenv("SEG_KNN", "float16")
    with pytest.raises(SystemExit, match="exact or bfloat16"):
        env.numerics(env.settings())


# --- tpu_numerics --------------------------------------------------------

def _split_means(patch):
    from test_torch_train_model import _jax_state, _to_port
    from wheat3dgs_tpu_torch.config import OptimizationParams
    from wheat3dgs_tpu_torch.models import gaussians as TG
    from wheat3dgs_tpu_torch.training import Trainer

    st = _to_port(_jax_state(n=12, cap=32, seed=4))
    with patch:
        tr = Trainer(st, OptimizationParams(), 2.0)
    new, info = TG.densify_and_prune(tr.state, 2e-4, 0.005, 2.0, 0.0, 0.01,
                                     generator=tr.generator)
    assert int(info["n_split"]) > 0
    return new.params.means


def test_train_seed_changes_the_split_noise():
    import contextlib

    from test_torch_train_model import _jax_state, _to_port
    from wheat3dgs_tpu_torch.config import OptimizationParams
    from wheat3dgs_tpu_torch.training import Trainer

    tn = _script("tpu_numerics")
    default = _split_means(contextlib.nullcontext())
    assert torch.equal(_split_means(tn.train_seed(0)), default)
    assert not torch.equal(_split_means(tn.train_seed(1)), default)
    # A seed the caller passes wins.
    st = _to_port(_jax_state(n=12, cap=32, seed=4))
    with tn.train_seed(1):
        tr = Trainer(st, OptimizationParams(), 2.0, seed=5)
    assert tr.generator.initial_seed() == 5


def test_runner_enters_and_restores_every_patch(monkeypatch):
    from wheat3dgs_tpu_torch.models import gaussians as TG
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops import knn as TK
    from wheat3dgs_tpu_torch.training import Trainer

    tn = _script("tpu_numerics")
    before = (TG.knn_mean_sq_dist, CR.segsum, Trainer.__init__)
    seen = {}

    def fake_main(argv):
        pts = np.random.default_rng(1).uniform(-1, 1, (64, 3)).astype(
            np.float32)
        seen["argv"] = argv
        seen["knn"] = np.array_equal(TG.knn_mean_sq_dist(pts),
                                     TK.knn_mean_sq_dist_bf16(pts))
        seen["segsum"] = CR.segsum is not before[1]
        seen["init"] = Trainer.__init__ is not before[2]
        return "done"

    fake = type(sys)("wheat3dgs_tpu_torch.apps.fake_app")
    fake.main = fake_main
    monkeypatch.setitem(sys.modules, "wheat3dgs_tpu_torch.apps.fake_app",
                        fake)
    assert tn.main(["--tpu_knn", "--bf16_grads", "--seed", "3", "--",
                    "apps.fake_app", "--device", "cpu", "-x"]) == "done"
    assert seen == {"argv": ["--device", "cpu", "-x"], "knn": True,
                    "segsum": True, "init": True}
    assert (TG.knn_mean_sq_dist, CR.segsum, Trainer.__init__) == before
    assert tn.main(["--", "wheat3dgs_tpu_torch.apps.fake_app"]) == "done"
    assert seen["argv"] == [] and not seen["segsum"] and not seen["init"]
    with pytest.raises(SystemExit):
        tn.main(["--seed", "1", "--", "ops.cuda_raster"])
    with pytest.raises(SystemExit):
        tn.main(["--seed", "1"])


def test_bf16_grads_round_as_jax():
    import jax.numpy as jnp

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    tn = _script("tpu_numerics")
    rng = np.random.default_rng(7)
    rows = (rng.normal(size=(64, 15))
            * 10.0 ** rng.integers(-30, 30, (64, 1))).astype(np.float32)
    bits = rows.view(np.uint32)
    bits[:8] = (bits[:8] & 0xFFFF0000) | 0x8000       # ties to even
    bits[8:12] = (bits[8:12] & 0xFFFF0000) | 0x7FFF
    rows[12] = np.float32(1e-40)                       # subnormals
    rows[13, :3] = [np.inf, -np.inf, 3.4e38]
    seen = []

    def recording(vals, start, end):
        seen.append(vals.numpy().copy())
        return vals[:1]

    start = torch.arange(64, dtype=torch.int32)
    with mock.patch.object(CR, "segsum", recording), tn.bf16_grads():
        CR.segsum(torch.as_tensor(rows), start, start + 1)
    (got,) = seen
    want = np.asarray(jnp.asarray(rows).astype(jnp.bfloat16).astype(
        jnp.float32))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(got, rows)


def test_runner_trains_a_tiny_scene(saved_model, tmp_path):
    scene, _ = saved_model
    tn = _script("tpu_numerics")
    trainer, _ = tn.main(["--tpu_knn", "--bf16_grads", "--seed", "1", "--",
                          "apps.train_vanilla", "-s", scene, "-m",
                          str(tmp_path / "m"), "--iterations", "20",
                          "--test_iterations", "20", "--save_iterations",
                          "20", "--device", "cpu", "--quiet"])
    assert trainer.generator.initial_seed() == 1
    assert (tmp_path / "m" / "point_cloud" / "iteration_20").is_dir()


# --- no card -------------------------------------------------------------

@pytest.mark.parametrize("name,argv", [
    ("diag_psnr_decline", ["-s", "{tmp}/scene", "-m", "{tmp}/model"]),
    ("exp_morph_compare", ["--out", "{tmp}/model/mc.json"]),
    ("exp_seg_sweep", []),
    ("tpu_numerics", ["--tpu_knn", "--bf16_grads", "--", "apps.train_vanilla",
                      "-s", "{tmp}/scene", "-m", "{tmp}/model"]),
])
def test_new_scripts_refuse_without_card(tmp_path, monkeypatch, name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setenv("SEG_SCENE", str(tmp_path / "scene"))
    monkeypatch.setenv("SEG_MODEL", str(tmp_path / "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script(name).main([a.format(tmp=tmp_path) for a in argv])
    assert not os.listdir(tmp_path)
