#!/usr/bin/env python
"""IoU-threshold sweep of the segmentation pipeline on the envelope scene:
the counterpart of the repo's scripts/exp_seg_sweep.py on the
PyTorch/CUDA port.

One SegContext (seg/pipeline.py) serves every threshold: its mask bits
and per-camera FlashSplat count caches do not depend on the threshold,
so each further threshold costs only its matching renders. Each run
goes to `<model>/wheat-head/env_iou<NN>/` after seed_everything(0), is
scored by exp_seg_envelope.py's label transfer against the generator's
ground truth (its envelope_report.json, with the JAX sweep's keys), and
prints one JSON line.

Usage: [SEG_SCENE=dir] [SEG_MODEL=dir] \\
    python wheat3dgs_tpu_torch/scripts/exp_seg_sweep.py
        [--thresholds 0.5,0.6] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from exp_seg_envelope import label_transfer, settings  # noqa: E402


def score(scene: str, model: str, exp_name: str, seg_wall: float,
          n_gt: int) -> dict:
    """The label-transfer report of one threshold's run (the JAX sweep's
    keys), written to its envelope_report.json."""
    base = os.path.join(model, "wheat-head", exp_name)
    _, seen, rows, claimed, duplicates = label_transfer(scene, base)

    def mean(i):
        return float(np.mean([r[i] for r in rows])) if rows else 0.0

    rep = {
        "n_gt_heads": n_gt, "n_discovered": len(seen),
        "n_matched_gt": len(claimed), "duplicate_id_count": duplicates,
        "mean_iou": mean(2), "mean_precision": mean(3),
        "mean_recall": mean(4), "mean_splat_purity": mean(5),
        "seg_wall_s": seg_wall,
        "per_head": [
            {"pred_id": r[0], "gt_id": r[1], "iou": round(r[2], 4),
             "precision": round(r[3], 4), "recall": round(r[4], 4),
             "splat_purity": round(r[5], 4)} for r in rows],
    }
    with open(os.path.join(base, "envelope_report.json"), "w") as f:
        json.dump(rep, f, indent=1)
    return rep


def main(argv=None) -> list:
    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch import resolve_device
    from wheat3dgs_tpu_torch.apps.run_3d_seg_app import build_context
    from wheat3dgs_tpu_torch.render.pipeline import (RasterConfig,
                                                     adapt_config,
                                                     inference_config)
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.seg.pipeline import run_segmentation
    from wheat3dgs_tpu_torch.utils.general import seed_everything

    ap = argparse.ArgumentParser()
    ap.add_argument("--thresholds", default="0.5")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    s = settings()
    scene_dir, model_dir = s["scene"], s["model"]

    model = cfg.ModelParams(source_path=scene_dir, model_path=model_dir,
                            eval=True, resolution=1)
    scene = Scene(model, load_iteration=-1, shuffle=False, device=device)
    with open(os.path.join(scene_dir, "manifest.json")) as f:
        n_gt = json.load(f)["n_heads"]
    w0, h0 = scene.image_size
    n_train = len(scene.data.train.metas)
    config = adapt_config(
        scene.gaussians, scene.cam_arrays("train", 0), w0, h0,
        inference_config(RasterConfig()),
        cams=[scene.cam_arrays("train", i) for i in range(n_train)])
    ctx = build_context(scene, config)
    eval_names = [m.image_name for m in scene.data.test.metas]
    eval_cams = scene.cam_stack("test") if eval_names else None

    lines = []
    for thr in (float(t) for t in args.thresholds.split(",")):
        exp = f"env_iou{int(round(thr * 100)):02d}"
        seed_everything(0)
        t0 = time.time()
        run_segmentation(ctx, model_dir, exp, iou_threshold=thr,
                         eval_names=eval_names, eval_cams=eval_cams,
                         verbose=False)
        rep = score(scene_dir, model_dir, exp, time.time() - t0, n_gt)
        lines.append({"iou_threshold": thr, **{
            k: v for k, v in rep.items() if k != "per_head"}})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
