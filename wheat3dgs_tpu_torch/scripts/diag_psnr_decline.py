#!/usr/bin/env python
"""Diagnose a test-PSNR decline between saves of a trained model: the
counterpart of the repo's scripts/diag_psnr_decline.py on the PyTorch/CUDA
port.

JAX's benchmark config #2 (docs/REPORT.md:116-152) fell from 37.98 dB at
7k to 35.64 at 30k on the test split. Its hypotheses:

  H1 overfit: the train PSNR rises while the test PSNR falls;
  H2 budget cropping: a render's entry demand over its budget;
  H3 schedule interaction (densify / opacity reset): train and test fall
     together.

For each saved iteration and each split, this renders every view at an
entry budget probed fresh over all of the split's views (render_fwd on
the port's kernels), scores the mean PSNR of the clipped images and the
largest entries_total / entry_budget, then prints JAX's table and its
three-way verdict at its thresholds.

Usage: python wheat3dgs_tpu_torch/scripts/diag_psnr_decline.py
    [-m MODEL] [-s SCENE] [--iterations 7000 15000 30000]
    [--device cuda|cpu]
(-m defaults to the port's exp_bench2.sh model directory, -s to the
source_path in the model's cfg_args.)
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def diagnose(model_path: str, source_path: str, iterations, device) -> list:
    """One row a saved iteration: n_splats, and per split the mean PSNR
    and the largest demand / budget."""
    import torch

    from wheat3dgs_tpu_torch.config import ModelParams
    from wheat3dgs_tpu_torch.ops.losses import psnr
    from wheat3dgs_tpu_torch.render.pipeline import (RasterConfig,
                                                     adapt_config,
                                                     inference_config,
                                                     render_fwd)
    from wheat3dgs_tpu_torch.scene import Scene

    rows = []
    for it in iterations:
        model = ModelParams(source_path=source_path, model_path=model_path,
                            eval=True, resolution=1)
        scene = Scene(model, load_iteration=it, shuffle=False, device=device)
        w, h = scene.image_size
        row = {"iteration": it, "n_splats": int(scene.gaussians.num_alive)}
        for split in ("train", "test"):
            group = scene.data.train if split == "train" else scene.data.test
            n = len(group.metas)
            cams = [scene.cam_arrays(split, i) for i in range(n)]
            config = adapt_config(scene.gaussians, cams[0], w, h,
                                  inference_config(RasterConfig()),
                                  cams=cams)
            vals, crop = [], 0.0
            for i in range(n):
                out = render_fwd(scene.gaussians, *cams[i], w, h,
                                 sh_degree=scene.sh_degree, config=config)
                gt = torch.as_tensor(group.images[i], device=scene.device)
                vals.append(float(psnr(out.color.clamp(0, 1), gt)))
                if out.entries_total is not None:
                    crop = max(crop, float(out.entries_total)
                               / config.entry_budget)
            row[f"{split}_psnr"] = float(np.mean(vals))
            row[f"{split}_demand_over_budget"] = round(crop, 3)
        rows.append(row)
        print(row, flush=True)
    return rows


def verdict(rows) -> str:
    """JAX's verdict over the rows, at its thresholds (0.3 dB)."""
    tr = [r["train_psnr"] for r in rows]
    te = [r["test_psnr"] for r in rows]
    if tr[-1] > tr[0] + 0.3 and te[-1] < te[0] - 0.3:
        return ("VERDICT: train PSNR rises while test falls -> "
                "synthetic-data overfit (H1); no budget cropping observed."
                if all(max(r["train_demand_over_budget"],
                           r["test_demand_over_budget"]) <= 1.0
                       for r in rows)
                else "VERDICT: overfit signature, BUT budget cropping also "
                     "observed — fix the ladder first (H2).")
    if te[-1] < te[0] - 0.3 and tr[-1] <= tr[0] + 0.3:
        return ("VERDICT: train and test both degrade -> schedule "
                "interaction (H3): bisect densify/opacity-reset events.")
    return ("VERDICT: no decline reproduced under fresh budgets -> the "
            "round-3 numbers were a stale-budget artifact (H2).")


def main(argv=None) -> list:
    from wheat3dgs_tpu_torch import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_path", default=os.path.join(
        ROOT, "output", "exp_bench2", "model"))
    ap.add_argument("-s", "--source_path", default=None,
                    help="defaults to the source_path recorded in cfg_args")
    ap.add_argument("--iterations", type=int, nargs="+",
                    default=[7000, 15000, 30000])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.source_path is None:
        with open(os.path.join(args.model_path, "cfg_args")) as f:
            args.source_path = re.search(r"source_path='([^']*)'",
                                         f.read()).group(1)

    rows = diagnose(args.model_path, args.source_path, args.iterations,
                    device)
    print("\n| iteration | n_splats | train PSNR | test PSNR | "
          "max demand/budget |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['iteration']} | {r['n_splats']} | "
              f"{r['train_psnr']:.2f} | {r['test_psnr']:.2f} | "
              f"{max(r['train_demand_over_budget'], r['test_demand_over_budget']):.2f} |")
    print("\n" + verdict(rows))
    return rows


if __name__ == "__main__":
    main()
