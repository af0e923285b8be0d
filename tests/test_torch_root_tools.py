"""The root tools with no tensor work, ported without pandas or matplotlib
(ROADMAP A14): wheat3dgs_tpu_torch/scripts/summarize_results.py and
wheat3dgs_tpu_torch/apps/vis_cam.py.

- summarize_results: its two CSVs byte-equal to the root
  summarize_results.py's (pandas, run as a subprocess) over one plot_*
  layout with three `ours` plots (one without results.json, one without
  point_cloud/), a nerfstudio method with two timestamped runs and .ckpt
  files, a method with a single plot (a NaN std), integer and missing
  scores; its stdout's messages the root script's; both exit with "no
  results found" on a layout with nothing in it.
- vis_cam: `frustum_corners` equal to the root script's over random
  poses; each camera centre's pixel in its split's colour; the PNG
  decodes at its size with more than the background in it.
- Both take no --device and run with no card (CUDA_VISIBLE_DEVICES
  empty), as processes in which pandas and matplotlib cannot be imported;
  no module of the port imports matplotlib (the AST scan of
  test_torch_imports.py, here for matplotlib).
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "wheat3dgs_tpu_torch")
PORT_SUMMARIZE = os.path.join(PORT, "scripts", "summarize_results.py")
# A process in which pandas and matplotlib cannot be imported.
BLOCKED = ("import runpy, sys; sys.modules.update(pandas=None, "
           "matplotlib=None); sys.argv = sys.argv[1:]; ")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(base):
    """plot_1..plot_3 with `ours` results (plot_2 without point_cloud/,
    plot_3 without results.json), nerfacto runs under plot_1 and plot_2
    (two timestamped runs each; the later one counts), splatfacto under
    plot_1 only."""
    ours = {"plot_1": {"ours_7000": {"PSNR": 30.5, "SSIM": 0.9, "LPIPS": 0.2},
                       "ours_30000": {"PSNR": 33.123456789012345,
                                      "SSIM": 0.951, "LPIPS": 0.0123}},
            "plot_2": {"ours_30000": {"PSNR": 31, "SSIM": 0.94,
                                      "LPIPS": None}}}
    for p in ("plot_1", "plot_2", "plot_3"):
        (base / p).mkdir(parents=True)
        if p in ours:
            (base / p / "results.json").write_text(json.dumps(ours[p]))
    pc = base / "plot_1" / "point_cloud" / "iteration_30000"
    pc.mkdir(parents=True)
    (pc / "point_cloud.ply").write_bytes(b"\0" * 123457)
    runs = {("plot_1", "nerfacto"): [
                ("2024-01-02_030405", {"psnr": 25.0, "ssim": 0.8,
                                       "lpips": 0.3, "fps": 2.5}, [1000]),
                ("2024-03-02_030405", {"psnr": 26.25, "ssim": 0.81,
                                       "lpips": 0.29, "fps": 3}, [2000, 7])],
            ("plot_2", "nerfacto"): [
                ("2023-12-31_235959", {"psnr": 24.5, "ssim": 0.79,
                                       "lpips": 0.31, "fps": 3}, []),
                ("2024-02-01_000000", {"psnr": 27.75, "ssim": 0.83,
                                       "lpips": 0.27, "fps": 4}, [555])],
            ("plot_1", "splatfacto"): [
                ("2024-05-06_070809", {"psnr": 28.0, "ssim": 0.85,
                                       "lpips": 0.2}, [4096])]}
    for (plot, method), rs in runs.items():
        for stamp, res, ckpts in rs:
            d = base / plot / method / stamp
            (d / "nerfstudio_models").mkdir(parents=True)
            (d / "test_results.json").write_text(json.dumps(
                {"results": res}))
            for i, n in enumerate(ckpts):
                (d / "nerfstudio_models" / f"step-{i}.ckpt").write_bytes(
                    b"\0" * n)
        (base / plot / method / "not_a_run").mkdir()


def _run(cmd, cwd=ROOT, **env):
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, **env))


@pytest.mark.parametrize("methods", [
    ["ours"], ["ours", "nerfacto", "splatfacto"],
    ["nerfacto", "ours", "splatfacto", "instant-ngp"]])
def test_summarize_results_csvs_byte_equal_to_root(tmp_path, methods):
    base = tmp_path / "plots"
    _layout(base)
    outs = {}
    for name, script, lead in (
            ("root", os.path.join(ROOT, "summarize_results.py"), []),
            ("port", PORT_SUMMARIZE,
             ["-c", BLOCKED + "runpy.run_path(sys.argv[0], "
                              "run_name='__main__')"])):
        out = tmp_path / name
        proc = _run([sys.executable, *lead, script, "-b", str(base),
                     "--methods", *methods, "-o", str(out)],
                    CUDA_VISIBLE_DEVICES="")
        assert proc.returncode == 0, proc.stderr
        outs[name] = (out, proc.stdout.splitlines())
    for f in ("results_per_scene.csv", "results_summary.csv"):
        root = (outs["root"][0] / f).read_bytes()
        assert (outs["port"][0] / f).read_bytes() == root, f
    # The skip messages and the last line are the root script's; the
    # table between them is laid out by each on its own.
    msgs = [ln for ln in outs["root"][1]
            if ln.startswith(("results.json not found", "Method "))]
    assert msgs and outs["port"][1][:len(msgs)] == msgs
    assert outs["port"][1][-1] == outs["root"][1][-1].replace(
        str(outs["root"][0]), str(outs["port"][0]))


def test_summarize_results_nothing_found(tmp_path):
    (tmp_path / "plots" / "plot_1").mkdir(parents=True)
    for script in (os.path.join(ROOT, "summarize_results.py"),
                   PORT_SUMMARIZE):
        proc = _run([sys.executable, script, "-b", str(tmp_path / "plots"),
                     "-o", str(tmp_path / "out")])
        assert proc.returncode == 1
        assert proc.stderr.strip().splitlines()[-1] == "no results found"
        assert "results.json not found for plot_1" in proc.stdout


def test_summarize_results_statistics_as_pandas():
    """The mean and std of the summary agree with pandas' groupby on values
    where the summation order shows (a float sum that is not exact)."""
    import pandas as pd

    mod = _load(PORT_SUMMARIZE, "port_summarize")
    rng = np.random.default_rng(4)
    for _ in range(200):
        n = int(rng.integers(1, 12))
        vals = list(rng.normal(size=n) * 10.0 ** rng.integers(-8, 9, n))
        if n > 2:
            vals[1] = None
        s = pd.Series([np.nan if v is None else v for v in vals])
        g = s.groupby(np.zeros(n)).agg(["mean", "std"]).iloc[0]
        for got, want in ((mod.group_mean(vals), g["mean"]),
                          (mod.group_std(vals), g["std"])):
            assert (np.isnan(got) and np.isnan(want)) or got == want


def test_frustum_corners_equal_root():
    root = _load(os.path.join(ROOT, "vis_cam.py"), "root_vis_cam")
    from wheat3dgs_tpu_torch.apps import vis_cam
    from wheat3dgs_tpu_torch.utils import graphics

    rng = np.random.default_rng(0)
    for _ in range(50):
        q = rng.normal(size=4)
        w2c = np.eye(4)
        w2c[:3, :3] = graphics.qvec_to_rotmat(q / np.linalg.norm(q))
        w2c[:3, 3] = rng.normal(size=3) * 5
        scale = float(rng.uniform(0.05, 1.0))
        assert np.array_equal(vis_cam.frustum_corners(w2c, scale),
                              root.frustum_corners(w2c, scale))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("viscam") / "scene")
    make_synthetic_colmap_scene(out, width=32, height=24, n_cams=14,
                                n_heads=1, pts_per_head=40, ground_pts=160,
                                with_masks=False, device="cpu")
    return out


def test_camera_centres_in_their_split_colour(scene):
    from wheat3dgs_tpu_torch.apps import vis_cam
    from wheat3dgs_tpu_torch.io import colmap

    _, extr, points = colmap.load_colmap_model(
        os.path.join(scene, "sparse", "0"))
    image, centres = vis_cam.draw_cameras(extr, points)
    assert image.size == vis_cam.SIZE and len(centres) == 14
    pix = np.asarray(image)
    splits = set()
    for name, (x, y) in centres.items():
        test = vis_cam.camera_id(name) > 10
        splits.add(test)
        want = vis_cam.RED if test else vis_cam.BLUE
        assert tuple(pix[int(round(y)), int(round(x))]) == want, name
        assert 0 <= x < image.size[0] and 0 <= y < image.size[1]
    assert splits == {False, True}


def test_vis_cam_writes_a_png_without_card_or_device(scene, tmp_path):
    from PIL import Image

    from wheat3dgs_tpu_torch.apps import vis_cam

    out = tmp_path / "cams.png"
    proc = _run([sys.executable, "-c",
                 BLOCKED + "runpy.run_module('wheat3dgs_tpu_torch.apps."
                 "vis_cam', run_name='__main__', alter_sys=True)",
                 "vis_cam", "-s", scene, "-o", str(out)],
                CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"wrote {out}"
    png = Image.open(out)
    assert png.format == "PNG" and png.size == vis_cam.SIZE
    colours = np.unique(np.asarray(png.convert("RGB")).reshape(-1, 3),
                        axis=0)
    assert len(colours) > 3
    with pytest.raises(SystemExit):
        vis_cam.main(["-s", scene, "--device", "cpu"])
    mod = _load(PORT_SUMMARIZE, "port_summarize_dev")
    with pytest.raises(SystemExit):
        mod.main(["-b", scene, "--device", "cpu"])


def test_port_imports_no_matplotlib():
    bad = []
    paths = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
             for f in sorted(fs) if f.endswith(".py")]
    paths.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(paths) > 20 and PORT_SUMMARIZE in paths
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read(), filename=path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", "") == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] == "matplotlib"]
    assert not bad, bad
