"""The port stands alone and never falls back to the CPU on its own.

- An AST scan: no module of wheat3dgs_tpu_torch/, and not chip_smoke.py,
  imports jax or the JAX package (a sys.modules check cannot show this:
  the interpreter here may preload jax).
- Entry points asked for the default device raise when no card is present.
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
