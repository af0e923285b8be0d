"""CPU tests of the benchmark harness (a tiny copy of each cell through
the harness, with the port's plain kernels), its work count, its reference
against the port, the discovery of new files and the import rules. The
card test at the end holds the TF32 control to `correct` false."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchlib import harness
from reference import raster as R

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "wheat3dgs_tpu"}
SEED = 4294967311


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_tree(dst: Path) -> Path:
    """A checkout-like tree at `dst` whose cell is cut to 64x48; the
    reference schedule densifies every 20, set-up runs iterations 961-980
    and the window (40 iterations at 1.5 s) runs 981-1020, through the SH
    ramp's step to degree 1 at 1000."""
    shutil.copytree(HERE, dst / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = dst / c["file"]
        cfg = json.loads(f.read_text())
        cfg["scene"].update(width=64, height=48, n_heads=2, pts_per_head=60,
                            ground_pts=300)
        f.write_text(json.dumps(cfg))
    f = dst / HERE.name / "traffic" / "ref_schedule.json"
    mix = json.loads(f.read_text())
    mix["optimization"].update(densify_from_iter=10,
                               densification_interval=20)
    mix.update(first_iter=961, window_from_iter=981, window_unit=20,
               window_rate=20)
    f.write_text(json.dumps(mix))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run_cell(root: Path, workload: str, trace: int = 0, seconds: float = 1.5):
    return harness.run(["--workload", workload, "--seed", str(SEED),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       root=root, device="cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tree, trace):
    out = run_cell(tree, "plot12_densify", trace)
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] == 40 and out["failed"] == 0
    if trace == 0:
        assert set(out["metrics"]) == {"train_it_s", "setup_s"}
    else:
        assert "capture_share.train" in out["metrics"]
        assert "schedule_share.train" in out["metrics"]
    assert out["checks"]["densify_mismatch"]["value"] == 0
    assert {"sh_loss_gap", "sh_grad_gap", "sh_change_gap"} <= set(
        out["checks"])


def test_command_needs_a_card(tree):
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "plot12_densify", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("fault", ["state_unchanged", "loss_altered",
                                   "half_the_pixels", "no_clones",
                                   "sh_band_dropped"])
def test_fault_is_incorrect(tree, monkeypatch, fault):
    """With the timed path broken underneath, `correct` comes out false."""
    import control

    control.plant(fault, monkeypatch.setattr)
    out = run_cell(tree, "plot12_densify")
    assert not out["correct"], out["checks"]


def test_knn_is_the_programs():
    """The reference's k-NN (which sizes the plot's splats and the
    reference's start) gives the program's host k-NN's numbers."""
    from reference.step import knn_mean_sq_dist
    from wheat3dgs_tpu_torch.ops.knn import knn_mean_sq_dist as program

    g = np.random.default_rng(3)
    pts = np.concatenate([g.uniform(-1.2, 1.2, (3000, 3)) * [1, 1, 0.02],
                          g.normal(0.4, 0.05, (500, 3))]).astype(np.float32)
    pts[7] = pts[8]
    got = knn_mean_sq_dist(torch.as_tensor(pts), block=512).numpy()
    np.testing.assert_array_equal(got, program(pts))


def _scene(n=40, w=70, h=50, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {
        "means": torch.rand((n, 3), generator=g) * 1.2 - 0.6,
        "quats": torch.randn((n, 4), generator=g),
        "log_scales": torch.rand((n, 3), generator=g) * 1.5 - 3.5,
        "sh_dc": torch.randn((n, 3), generator=g) * 0.5,
        "sh_rest": torch.randn((n, 45), generator=g) * 0.1,
        "opacity_logit": torch.randn((n,), generator=g) * 2.0,
    }
    eye = np.array([0.3, -2.0, 0.8])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    down = -np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = rot, -rot @ eye
    tx, ty = 0.5, 0.5 * h / w
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1], proj[3, 2] = 1 / tx, 1 / ty, 1.0
    proj[2, 2], proj[2, 3] = 100 / 99.99, -1.0 / 99.99
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa
    cam = R.Camera(f(w2c), f(proj @ w2c), f(eye), float(np.float32(tx)),
                   float(np.float32(ty)))
    return params, cam, w, h


def test_weighted_pairs_against_brute_force():
    """The reference's image and weighted-pair count against a direct
    per-pixel walk over every splat in depth order (products, float64)."""
    params, cam, w, h = _scene()
    out = R.render(params, cam, w, h, 3)
    p = out.proj
    order = np.argsort(p.depth.numpy(), kind="stable")
    xy, con = p.xy.numpy()[order], p.conic.numpy()[order]
    op, col = p.opacity.numpy()[order], p.color.numpy()[order]
    rect = p.rect.numpy()[order]
    img = np.zeros((3, h, w))
    weighted = 0
    for py in range(h):
        for px in range(w):
            tx, ty = px // R.TILE, py // R.TILE
            t = 1.0
            for i in range(len(order)):
                if not (rect[i, 0] <= tx < rect[i, 2]
                        and rect[i, 1] <= ty < rect[i, 3]):
                    continue
                dx, dy = xy[i, 0] - px, xy[i, 1] - py
                power = (-0.5 * (con[i, 0] * dx * dx + con[i, 2] * dy * dy)
                         - con[i, 1] * dx * dy)
                if power > 0:
                    continue
                a = min(R.ALPHA_MAX, op[i] * np.exp(power))
                if a < R.ALPHA_MIN:
                    continue
                if t * (1 - a) < R.T_EPS:
                    break
                img[:, py, px] += a * t * col[i]
                weighted += 1
                t *= 1 - a
    assert weighted > 200
    assert abs(out.weighted - weighted) <= 1
    np.testing.assert_allclose(out.image.numpy(), img, atol=2e-5)


def test_reference_against_port_cpu():
    """The reference's image and gradients against the port's CPU path
    (its kernels' plain versions) on one view."""
    from wheat3dgs_tpu_torch.models.gaussians import (GaussianParams,
                                                      state_from_numpy)
    from wheat3dgs_tpu_torch.render.pipeline import RasterConfig, render

    params, cam, w, h = _scene(n=60, seed=1)
    weights = torch.rand((3, h, w), generator=torch.Generator().manual_seed(2))

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    img_r = R.render(leaves, cam, w, h, 3, grad=True).image
    g_r = torch.autograd.grad((img_r * weights).sum(), list(leaves.values()))

    st = state_from_numpy({k: v.numpy() for k, v in params.items()},
                          device="cpu")
    pl = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    st = dataclasses.replace(st, params=GaussianParams(**pl))
    out = render(st, cam.w2c, cam.full_proj, cam.center,
                 torch.tensor(cam.tanfovx), torch.tensor(cam.tanfovy), w, h,
                 3, config=RasterConfig())
    g_p = torch.autograd.grad((out.color * weights).sum(), list(pl.values()))
    np.testing.assert_allclose(out.color.detach().numpy(),
                               img_r.detach().numpy(), atol=1e-5)
    for k, a, b in zip(params, g_p, g_r):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-3 * scale, k


def test_new_files_are_found(tmp_path):
    """A configuration, a mix and a per-layer metric dropped into their
    folders (and a cell naming them in BENCHMARK.json) run with no edit of
    the files already there."""
    root = tiny_tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / HERE.name
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "plot12_1600.json").read_text())
    cfg["name"] = "plot6_small"
    cfg["scene"].update(n_heads=1)
    (here / "configs" / "plot6_small.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "ref_schedule.json").read_text())
    mix.update(densify=False, sh="max", blocks=20)
    (here / "traffic" / "steady20.json").write_text(json.dumps(mix))
    (here / "limits" / "plot6_steady.json").write_text(
        (here / "limits" / "plot12_densify.json").read_text())
    (here / "metrics" / "blocks_seen.py").write_text(
        "def read(run):\n    return float(len(run['blocks']))\n")
    bench["configs"].append(dict(bench["configs"][0], name="plot6_small",
                                 file=f"{HERE.name}/configs/plot6_small.json"))
    bench["workloads"].append({"name": "plot6_steady",
                               "config": "plot6_small", "traffic": "steady20",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "blocks_seen", "unit": "blocks",
                               "better": "higher", "source": "program_span",
                               "layer": "Schedule", "moves": "train_it_s",
                               "workloads": ["plot6_steady"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(root, "plot6_steady", trace=1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["blocks_seen"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_imports():
    """Nothing under the benchmark imports JAX or the JAX package (whole
    top-level names: the port's name begins with the JAX package's), and
    the reference imports nothing of the port or of the harness."""
    files = list(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in (HERE / "reference").rglob("*.py"):
        assert not (_imports(f) & {"wheat3dgs_tpu_torch", "benchlib"}), f


@pytest.mark.gpu
def test_tf32_control_is_incorrect():
    """The reference computed in TF32 in the program's place fails the
    limits (the control of `correct`), on a plot cut to 400x300."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchlib import check
    from benchlib.scene import make_plot

    cell = harness.Cell(ROOT, "plot12_densify")
    s = dict(cell.config["scene"], width=400, height=300)
    plot = make_plot(s, 7, torch.device("cuda"))
    args = ([0, 1, 2], [1, 2, 3], 3, 0, cell.mix, torch.device("cuda"))
    lo = check.reference_steps(plot, *args, low=True)
    hi = check.reference_steps(plot, *args)
    prog = {"losses": [[x] for x in lo["losses"]],
            "grad": {k: [v] for k, v in lo["grad"].items()},
            "change": {k: [v] for k, v in lo["change"].items()}}
    gaps = check.step_gaps(prog, [hi])
    assert any(gaps[k] > cell.limits[k] for k in gaps), gaps
