#!/usr/bin/env python
"""Benchmark config #4's closer on the PyTorch/CUDA port: the morphology
traits of DISCOVERED heads against the generator's GROUND-TRUTH per-head
point clouds; the counterpart of the repo's scripts/exp_morph_compare.py.

The generator records every point it emits with its head id
(gt_points.npz), so one trait extractor (morphology/traits.py::
compute_traits: length, 99th-percentile width, Qhull volume, inclination,
curvature) scores both sides of each (discovered head -> matched GT head)
pair of the envelope report, and the relative error of each trait says
how faithful splat-based morphology is to the geometry beneath it.

Both sides go through the morphology pipeline's preprocessing first
(subsample to 5000 points at rng 0, the largest HDBSCAN cluster with
CLUSTERER, SOR at k <= 200 and std 3: the envelope config of
exp_seg360_morph.sh), and the spline's smoothing `s` is scale-aware on both
(`_s_val`), as in the JAX script. The clusterers' and SOR's distance work
runs on --device.

Usage: [SEG_SCENE=dir] [SEG_MODEL=dir] [EXP=envelope] \\
    python wheat3dgs_tpu_torch/scripts/exp_morph_compare.py
        [--out PATH] [--device cuda|cpu] [--against JSON]
Writes morph_compare.json (by default in the temporary directory, as the
JAX script writes /tmp/morph_compare.json) and prints the markdown table.
`--against` holds the ground-truth side to another run's file (JAX's
docs/quality/morph_compare.json): every gt_* trait of each gt_id that
both files hold must be equal (both are rounded to 5 decimals); it exits
non-zero otherwise. The ground truth's points do not depend on the kNN or
the colour noise, so the GT side of two runs of one generator is the
same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# The envelope morphology config's clusterer (exp_seg360_morph.sh).
CLUSTERER = {"type": "hdbscan", "min_samples": 15, "min_cluster_size": 250,
             "epsilon_hdbscan": 0.015}
TRAITS = ["length", "width", "volume", "inclination", "curvature"]


def _s_val(pts: np.ndarray) -> float:
    """The spline's smoothing budget at the cloud's own scale: points
    times the variance of the second principal coordinate (scipy's
    s ~ m * sigma^2). The pipeline's fixed s = 1 is a total squared
    residual for the reference's physical units; at the synthetic scene's
    (heads ~0.2 units) it lets the spline chase per-splat noise."""
    from wheat3dgs_tpu_torch.morphology.traits import run_pca

    proj, _ = run_pca(pts)
    return float(len(pts) * np.var(proj[:, 1]))


def preprocess(pts: np.ndarray, device) -> np.ndarray:
    """The morphology pipeline's preprocessing of one head cloud."""
    from wheat3dgs_tpu_torch.morphology.pcp_utils import (
        main_cluster_extraction, statistical_outlier_removal, subsample_pcd)

    pts = subsample_pcd(pts, 5000, rng=np.random.default_rng(0))
    try:
        pts = main_cluster_extraction(pts, CLUSTERER, device=device)
    except Exception:
        pass                     # a degenerate cloud is scored raw
    if len(pts) > 20:
        pts, _ = statistical_outlier_removal(
            pts, k=min(200, len(pts) - 1), std_ratio=3.0, device=device)
    return pts


def compare(scene: str, model: str, exp: str, device) -> tuple:
    """Both sides' traits for every pair of the envelope report at IoU
    >= 0.3, with the relative errors' median and mean per trait (the
    summary), and the relative errors per trait."""
    from wheat3dgs_tpu_torch.io.ply import read_ply
    from wheat3dgs_tpu_torch.morphology.traits import compute_traits

    with open(os.path.join(model, "wheat-head", exp,
                           "envelope_report.json")) as f:
        rep = json.load(f)
    gt = np.load(os.path.join(scene, "gt_points.npz"))
    gt_xyz, gt_id = gt["points"].astype(np.float64), gt["head_id"]
    ply_dir = os.path.join(model, "wheat-head", exp, "ply")

    rows, rels = [], {t: [] for t in TRAITS}
    for h in rep["per_head"]:
        if h["gt_id"] <= 0 or h["iou"] < 0.3:
            continue  # unmatched ids are scored by the seg table already
        pred_path = os.path.join(ply_dir, f"wh_{h['pred_id']:04d}.ply")
        if not os.path.exists(pred_path):
            continue
        d = read_ply(pred_path)
        pred_pts = preprocess(
            np.stack([d["x"], d["y"], d["z"]], 1).astype(np.float64),
            device)
        gt_pts = preprocess(gt_xyz[gt_id == h["gt_id"]], device)
        if len(pred_pts) < 20 or len(gt_pts) < 20:
            continue
        pt = compute_traits(pred_pts, 99, _s_val(pred_pts))
        gt_t = compute_traits(gt_pts, 99, _s_val(gt_pts))
        row = {"pred_id": h["pred_id"], "gt_id": h["gt_id"],
               "iou": h["iou"], "n_pred": len(pred_pts),
               "n_gt": len(gt_pts)}
        for t, pv, gv in zip(TRAITS, pt, gt_t):
            row[t] = round(float(pv), 5)
            row[f"gt_{t}"] = round(float(gv), 5)
            if abs(gv) > 1e-9:
                rels[t].append(abs(pv - gv) / abs(gv))
        rows.append(row)

    return {
        "n_pairs": len(rows),
        "median_rel_err": {t: round(float(np.median(rels[t])), 4)
                           for t in TRAITS if rels[t]},
        "mean_rel_err": {t: round(float(np.mean(rels[t])), 4)
                         for t in TRAITS if rels[t]},
        "rows": rows,
    }, rels


def gt_mismatches(rows: list, other: list) -> tuple:
    """(gt_ids both hold, [(gt_id, trait, ours, theirs)] that differ)."""
    theirs = {r["gt_id"]: r for r in other}
    shared = sorted({r["gt_id"] for r in rows} & set(theirs))
    bad = [(r["gt_id"], t, r[f"gt_{t}"], theirs[r["gt_id"]][f"gt_{t}"])
           for r in rows if r["gt_id"] in theirs for t in TRAITS
           if r[f"gt_{t}"] != theirs[r["gt_id"]][f"gt_{t}"]]
    return shared, bad


def main(argv=None) -> dict:
    from wheat3dgs_tpu_torch import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "morph_compare.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the clusterers (default cuda; "
                         "cpu on request)")
    ap.add_argument("--against", default=None,
                    help="another run's morph_compare.json to hold the "
                         "ground-truth traits to")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = os.path.join(ROOT, "output", "exp_seg_envelope")
    scene = os.environ.get("SEG_SCENE", os.path.join(out_dir, "scene"))
    model = os.environ.get("SEG_MODEL", os.path.join(out_dir, "model"))
    exp = os.environ.get("EXP", "envelope")

    summary, rels = compare(scene, model, exp, device)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"},
                     indent=1))
    print("\n| trait | median rel err | mean rel err |")
    print("|---|---|---|")
    for t in TRAITS:
        if rels[t]:
            print(f"| {t} | {np.median(rels[t]):.1%} | "
                  f"{np.mean(rels[t]):.1%} |")
    print(f"\n{summary['n_pairs']} matched (pred, GT) head pairs; report: "
          f"{args.out}")
    if args.against:
        with open(args.against) as f:
            shared, bad = gt_mismatches(summary["rows"], json.load(f)["rows"])
        print(f"ground truth against {args.against}: {len(shared)} gt_ids "
              f"in both ({shared}), {len(bad)} traits differ {bad}")
        if bad:
            raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
