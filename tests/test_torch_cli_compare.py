"""The port's training CLI against the JAX package's on one scene, on the
CPU: both `apps.train_vanilla` runs get the same arguments (so the same
view picks, random.Random(0), and the same densify schedule), then the
splat count logged every 100 iterations (the count before that
iteration's densify) is compared side by side, and both saved models are
scored (mean PSNR over the test and the train views) by the port's
render_fwd at a budget probed over each split. The JAX CLI's own test
PSNR is printed too, but on the CPU it renders through its XLA backend at
the CLI's fixed max_per_tile, which crops a dense plot.

As a script, the full-length comparison (PERF.md §7, C8 step 3); a run
whose final PLY exists is not trained again:

    python tests/test_torch_cli_compare.py SCENE OUT [--iterations 3600] \
        [train_vanilla flags]

SCENE is made by the port's generator (36 cams at 64x48, 2 heads x 200 +
1200 ground, seed 0) when it lacks points3D. Past 1000 iterations pass
`--checkpoint_iterations 1000 2000 ...`: JAX's block schedule ends no
block at a densify iteration after the SH step at 1000 unless an event
realigns it (the port's densifies on the reference schedule either way).

As a test: both CLIs 200 iterations on a 32x24 scene with a densify every
50 iterations, one thread each; the logged counts within COUNT_REL of
JAX's at every logged iteration and in the saved models (float32 sums in
another order move the odd splat across the densify threshold: 3 of 802
at iteration 200). Their PSNR is not held at this length: a model 200
steps in, scored on one or two test views, moves by up to 1.2 dB when a
few splats densify differently (20.18 / 20.38 dB on the test's scene, a
24-camera one gave 21.81 / 20.61).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT_REL = 0.01
# One thread per process for the test (the machine runs other tests).
ONE_THREAD = {"OMP_NUM_THREADS": "1", "XLA_FLAGS":
              "--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1"}


def make_scene(scene: str, **kw):
    """The comparison's scene, unless `scene` already has points3D."""
    if os.path.exists(os.path.join(scene, "sparse", "0", "points3D.bin")):
        return
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    args = dict(width=64, height=48, n_cams=36, n_heads=2, pts_per_head=200,
                ground_pts=1200, seed=0, with_masks=False, device="cpu")
    make_synthetic_colmap_scene(scene, **{**args, **kw})


def train_both(scene: str, out: str, iterations: int, flags: list,
               env: dict = None) -> dict:
    """Both CLIs on `scene` at once, each as its own process on the CPU
    (with `env` added to its environment), into out/jax and out/port; each
    one's wall seconds."""
    args = ["-s", scene, "--eval", "--iterations", str(iterations),
            "--test_iterations", str(iterations), "--save_iterations",
            str(iterations), "--quiet"] + list(flags)
    ply = os.path.join("point_cloud", f"iteration_{iterations}",
                       "point_cloud.ply")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               **(env or {}))
    runs = {"jax": ["wheat3dgs_tpu.apps.train_vanilla"],
            "port": ["wheat3dgs_tpu_torch.apps.train_vanilla", "--device",
                     "cpu"]}
    os.makedirs(out, exist_ok=True)
    t0, procs = time.perf_counter(), {}
    for name, (module, *extra) in runs.items():
        if os.path.exists(os.path.join(out, name, ply)):
            continue
        with open(os.path.join(out, name + ".log"), "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", module, "-m",
                 os.path.join(out, name)] + args + extra, env=env,
                stdout=log, stderr=subprocess.STDOUT)
    seconds = {}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"the {name} CLI exited {p.returncode}: see "
                               f"{os.path.join(out, name + '.log')}")
        seconds[name] = time.perf_counter() - t0
    return seconds


def report(out: str, scene: str, iterations: int) -> dict:
    """Each logged iteration's counts (jax, port) and each model's saved
    splats, PSNR by the port's render_fwd per split, and CLI test PSNR."""
    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.models.serialization import load_ply
    from wheat3dgs_tpu_torch.ops.losses import psnr
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config, render_fwd
    from wheat3dgs_tpu_torch.scene import Scene

    def rows(name):
        with open(os.path.join(out, name, "metrics.jsonl")) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    logs = {name: rows(name) for name in ("jax", "port")}
    alive = {name: {r["iter"]: r["n_alive"] for r in rs if "loss" in r}
             for name, rs in logs.items()}
    res = {"counts": {it: (alive["jax"][it], alive["port"][it])
                      for it in sorted(set(alive["jax"])
                                       & set(alive["port"]))}}
    sc = Scene(cfg.ModelParams(source_path=scene), device="cpu")
    ply = os.path.join("point_cloud", f"iteration_{iterations}",
                       "point_cloud.ply")
    for name, rs in logs.items():
        st, sh = load_ply(os.path.join(out, name, ply), device="cpu")
        scores = {}
        for split in ("test", "train"):
            group = sc.data.test if split == "test" else sc.data.train
            cams = [sc.cam_arrays(split, i) for i in range(len(group.metas))]
            w, h = group.cameras.width, group.cameras.height
            conf = adapt_config(st, cams[0], w, h, cams=cams)
            vals = [psnr(torch.clamp(render_fwd(st, *c, w, h, sh_degree=sh,
                                                config=conf).color, 0, 1),
                         sc.gt_image(split, i)) for i, c in enumerate(cams)]
            scores[split] = float(torch.stack(vals).mean())
        res[name] = {"saved_splats": int(st.num_alive), "psnr": scores,
                     "cli_test_psnr": {r["iter"]: r["test_psnr"] for r in rs
                                       if "test_psnr" in r}}
    return res


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene")
    ap.add_argument("out")
    ap.add_argument("--iterations", type=int, default=3600)
    args, flags = ap.parse_known_args(argv)
    make_scene(args.scene)
    for name, s in train_both(args.scene, args.out, args.iterations,
                              flags).items():
        print(f"{name} wall: {s:.0f} s")
    res = report(args.out, args.scene, args.iterations)
    print("iter jax_n_alive port_n_alive port/jax")
    for it, (j, p) in res["counts"].items():
        print(it, j, p, round(p / max(j, 1), 4))
    for name in ("jax", "port"):
        r = res[name]
        print(name, "saved splats", r["saved_splats"], "PSNR by the port's "
              "render_fwd", {k: round(v, 4) for k, v in r["psnr"].items()},
              "CLI test psnr", {k: round(v, 4)
                                for k, v in r["cli_test_psnr"].items()})


def test_cli_compare_short_run(tmp_path):
    scene, out = str(tmp_path / "scene"), str(tmp_path / "out")
    make_scene(scene, width=32, height=24, n_cams=12, pts_per_head=60,
               ground_pts=300)
    train_both(scene, out, 200, ["--densify_from_iter", "50",
                                 "--densification_interval", "50",
                                 "--opacity_reset_interval", "150"],
               ONE_THREAD)
    res = report(out, scene, 200)
    assert list(res["counts"]) == [100, 200]
    for it, (j, p) in res["counts"].items():
        assert abs(p - j) <= COUNT_REL * j, \
            f"iteration {it}: JAX {j} splats, the port {p}"
    j, p = res["jax"]["saved_splats"], res["port"]["saved_splats"]
    assert abs(p - j) <= COUNT_REL * j
    for name in ("jax", "port"):
        assert all(v > 15.0 for v in res[name]["psnr"].values()), res[name]


if __name__ == "__main__":
    main()
