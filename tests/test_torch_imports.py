"""The port stands alone and never falls back to the CPU on its own.

- An AST scan: no module of wheat3dgs_tpu_torch/, and not chip_smoke.py,
  imports jax or the JAX package (a sys.modules check cannot show this:
  the interpreter here may preload jax), nor sklearn, pandas, pydantic or
  yaml, which the port does not depend on. A line scan of the package's
  shell scripts: none runs or names a module of jax or the JAX package.
- Entry points asked for the default device raise when no card is present
  (the multi-plot trainer among them).
- chip_smoke.py exits non-zero and prints no result without a card, and
  when it stands alone outside the repo.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "wheat3dgs_tpu_torch")


def _port_files():
    for d, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "wheat3dgs_tpu")


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
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
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_port_shell_scripts_run_no_jax():
    """Every line but comments of the package's shell scripts (their
    embedded Python included): no `jax` word, no JAX_PLATFORMS and no
    module path into wheat3dgs_tpu."""
    import re

    scripts = [os.path.join(d, f) for d, _, files in os.walk(PORT)
               for f in sorted(files) if f.endswith(".sh")]
    assert len(scripts) >= 3
    word = re.compile(r"\bjax(lib)?\b|JAX_PLATFORMS|\bwheat3dgs_tpu\.")
    bad = [f"{os.path.relpath(path, ROOT)}:{n} {ln.strip()}"
           for path in scripts
           for n, ln in enumerate(open(path).read().splitlines(), 1)
           if not ln.lstrip().startswith("#") and word.search(ln)]
    assert not bad, bad


def _imports(path: str):
    """(line, module) of every import in the file at `path`."""
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_no_sklearn_pandas_pydantic_yaml():
    bad = [f"{os.path.relpath(path, ROOT)}:{line} {name}"
           for path in _port_files() for line, name in _imports(path)
           if name.split(".")[0] in ("sklearn", "pandas", "pydantic",
                                     "yaml")]
    assert not bad, bad


def test_morphology_and_minimal_trainer_need_card_or_cpu(tmp_path):
    """Both refuse to run without a card unless given --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import numpy as np

    from wheat3dgs_tpu_torch.apps import morphology_app, train_minimal
    from wheat3dgs_tpu_torch.io.ply import write_ply
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # tiny tensors: threads only add waits
    try:
        (tmp_path / "heads").mkdir()
        pts = np.random.default_rng(0).normal(size=(300, 3)).astype("<f4")
        write_ply(str(tmp_path / "heads" / "1.ply"),
                  {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
        (tmp_path / "m.yaml").write_text(
            'data_folder: "heads/"\noutput_folder: "out/"\n'
            'file_format: "ply"\n'
            "subsampling_threshold: 5000\nclusterer_definition:\n"
            '  type: "dbscan"\n  epsilon: 1.0\n  min_samples: 5\n'
            "sor_parameters:\n  k: 20\n  std_ratio: 3\n"
            "splines_smoothing_value: 1\ndistance_percentile: 99\n"
            "get_bboxes: true\nget_processed_pcd: false\n")
        scene = str(tmp_path / "scene")
        make_synthetic_colmap_scene(scene, width=32, height=24, n_heads=1,
                                    pts_per_head=20, ground_pts=60,
                                    device="cpu")
        runs = {morphology_app: ["-c", str(tmp_path / "m.yaml")],
                train_minimal: ["-s", scene, "-m", str(tmp_path / "model"),
                                "--iterations", "2", "--quiet"]}
        for mod, argv in runs.items():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.main(argv)
            mod.main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert len(os.listdir(tmp_path / "out")) == 2     # xlsx + boxes
    assert os.path.exists(tmp_path / "model" / "point_cloud" /
                          "iteration_2" / "point_cloud.ply")


def test_render_sets_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wheat3dgs_tpu_torch.apps import render_sets

    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_sets.main(["-m", str(tmp_path)])


@pytest.mark.parametrize("app", ["run_3d_seg_app", "eval_wheatgs_app",
                                 "prof_scan", "profile_backward",
                                 "profile_forward", "profile_probe"])
def test_seg_and_probe_entry_points_refuse_without_card(tmp_path, app):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    mod = importlib.import_module(f"wheat3dgs_tpu_torch.apps.{app}")
    argv = {"run_3d_seg_app": ["-s", str(tmp_path), "-m", str(tmp_path)],
            "eval_wheatgs_app": ["-m", str(tmp_path)],
            "prof_scan": [],
            "profile_backward": ["--out", str(tmp_path)],
            "profile_forward": ["--out", str(tmp_path)],
            "profile_probe": []}[app]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("app", ["profile_render", "profile_train"])
def test_profile_apps_refuse_without_card(tmp_path, app):
    """The two profilers have no CPU mode: they raise before they write."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    mod = importlib.import_module(f"wheat3dgs_tpu_torch.apps.{app}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("app", ["metrics_app", "render_360_app",
                                 "viewer_app"])
def test_metrics_360_and_viewer_refuse_without_card(tmp_path, app):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    mod = importlib.import_module(f"wheat3dgs_tpu_torch.apps.{app}")
    argv = {"metrics_app": ["-m", str(tmp_path)],
            "render_360_app": ["-m", str(tmp_path), "--exp_name", "e",
                               "--render_type", "field"],
            "viewer_app": ["-s", str(tmp_path), "-m", str(tmp_path)]}[app]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("selector", ["--source_base", "--source_paths"])
def test_train_multi_refuses_without_card(tmp_path, selector):
    """The multi-plot trainer raises before it reads a plot, whichever
    way the plots are named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wheat3dgs_tpu_torch.apps import train_multi

    (tmp_path / "plot_1").mkdir()
    plots = str(tmp_path if selector == "--source_base"
                else tmp_path / "plot_1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_multi.main([selector, plots, "--model_base",
                          str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
