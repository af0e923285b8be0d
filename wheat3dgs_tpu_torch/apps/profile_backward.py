"""Times the training backward's two kernels at the bench shapes on the card.

    python -m wheat3dgs_tpu_torch.apps.profile_backward [--against DIR]
        [--out output/profile_backward]

Builds the bench plot (the port's synthetic generator, seed 0: 200,000
splats, 12 views at 1600x1200) and its SH-3 stand-in model in a work
directory under --out, takes train view 0 at the entry budget sized over
the train views, and times with CUDA events (utils/cuda_timing: REPS
launches after two of warm-up, queued behind a spin on the card; segsum 5
REPS):
- composite_bwd at 4 value rows (depth + RGB) under the L1 + SSIM loss
  against the view's image, and at 9 (depth + 8 label rows) with seeded
  0/1 planes as the label rows' cotangent (the segmentation lift's shape);
- segsum of each one's rows (10 and 15 columns), and torch.segment_reduce
  of the same rows.
With --against DIR, a `csrc/` directory of another tree (a parent
commit's, say; the same C entry points), each kernel is also built from
DIR, and the two builds run in turns (DIR, this tree, this tree, DIR) on
the same inputs in this process. Prints the card's name and power limit,
then one JSON line. Needs a card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..utils.cuda_timing import cuda_time_ms, smi_line

BENCH = dict(width=1600, height=1200, n_cams=12, n_heads=32,
             pts_per_head=3000, ground_pts=104_000, seed=0)
REPS = 20


def _shapes(scene, dev):
    """The backward's inputs on train view 0: {value rows: (composite_bwd
    arguments, seg_start, seg_end)} at 4 and 9 value rows."""
    from ..ops import cuda_raster as CR
    from ..ops.losses import photometric_loss
    from ..ops.projection import project_gaussians
    from ..render.pipeline import adapt_config

    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    cam = cams[0]
    budget = adapt_config(st, cam, w, h, cams=cams).entry_budget
    out = {}
    for nv, colors in ((4, None), (9, torch.zeros((st.capacity, 8),
                                                  device=dev))):
        with torch.no_grad():
            kw = {"sh": st.sh(), "sh_degree": scene.sh_degree} \
                if colors is None else {"colors": colors}
            splats = project_gaussians(
                st.params.means, st.scales(), st.params.quats, st.opacity(),
                *cam, w, h, **kw)
            plan = CR.alloc_prologue(splats, w, h, budget)
            key, _ = CR.decode_cull(plan)
            skeys, starts, ends, perm = CR.sorted_stream(
                key, plan.t_total, plan.rank_bits, with_perm=True)
            feat = CR.entry_features(splats, plan.order, True, True)
            img, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                               plan.rank_bits, w, h)
        if nv == 4:
            img_v = img.detach().requires_grad_(True)   # background 0
            grad = torch.autograd.grad(photometric_loss(
                img_v[2:5], scene.gt_image("train", 0)),
                img_v)[0].contiguous()
        else:
            rng = np.random.default_rng(0)
            grad = torch.zeros_like(img)
            grad[2:] = torch.as_tensor(
                rng.random((8, h, w)) < 0.3, dtype=torch.float32, device=dev)
        out[nv] = ((skeys, perm, starts, ends, feat, img, stop, grad,
                    plan.rank_bits, w, h), plan.seg_start, plan.seg_end)
    return out


def _run(shapes) -> dict:
    """Times both kernels of the current build at each shape; returns
    {value rows: {...}} with the outputs for cross-build checks."""
    from ..ops import cuda_raster as CR

    res = {}
    for nv, (bargs, seg_start, seg_end) in shapes.items():
        rows = CR.composite_bwd(*bargs)
        sums = CR.segsum(rows, seg_start, seg_end)
        res[nv] = dict(
            composite_bwd_ms=cuda_time_ms(lambda: CR.composite_bwd(*bargs),
                                          REPS),
            segsum_ms=cuda_time_ms(
                lambda: CR.segsum(rows, seg_start, seg_end), REPS * 5),
            rows=rows, sums=sums)
    return res


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default="",
                    help="another tree's csrc/ directory to time in turns")
    ap.add_argument("--out", default=os.path.join("output",
                                                  "profile_backward"))
    args = ap.parse_args(argv)

    from .. import config as cfg
    from .. import resolve_device
    from ..io.synthetic import (make_synthetic_colmap_scene,
                                write_stand_in_model)
    from ..ops import cuda_build
    from ..scene import Scene

    dev = resolve_device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    cuda_build.build(["composite_bwd", "segsum", "composite_fwd",
                      "decode_cull"])
    work = os.path.join(args.out, "work")
    shutil.rmtree(work, ignore_errors=True)
    scene_dir, model_dir = (os.path.join(work, "scene"),
                            os.path.join(work, "model"))
    make_synthetic_colmap_scene(scene_dir, with_masks=False, device=dev,
                                **BENCH)
    write_stand_in_model(model_dir, scene_dir, BENCH["n_heads"],
                         BENCH["pts_per_head"], BENCH["ground_pts"],
                         BENCH["seed"], device=dev)
    scene = Scene(cfg.ModelParams(source_path=scene_dir,
                                  model_path=model_dir),
                  load_iteration=-1, device=dev)
    shapes = _shapes(scene, dev)

    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "reps": REPS, "shapes": {}}
    for nv, (bargs, seg_start, seg_end) in shapes.items():
        report["shapes"][nv] = {
            "slots": bargs[0].shape[0], "ranks": seg_start.shape[0],
            "slots_summed": int(seg_end[-1]), "columns": 6 + nv}
    order = ["this"] if not args.against else ["against", "this", "this",
                                                "against"]
    runs = []
    for which in order:
        if which == "this":
            res = _run(shapes)
        else:
            with cuda_build.sources(args.against):
                res = _run(shapes)
        runs.append((which, res))
    for nv, (bargs, seg_start, seg_end) in shapes.items():
        this = [r[nv] for w, r in runs if w == "this"]
        rows = this[0]["rows"]
        used = int(seg_end[-1])
        offsets = torch.cat([seg_start, seg_end[-1:]]).long()
        entry = report["shapes"][nv]
        entry["library_ms"] = cuda_time_ms(lambda: torch.segment_reduce(
            rows[:used], "sum", offsets=offsets), REPS * 5)
        for which in dict.fromkeys(order):
            sel = [r[nv] for w, r in runs if w == which]
            entry[which] = {k: [s[k] for s in sel]
                            for k in ("composite_bwd_ms", "segsum_ms")}
        if args.against:
            other = [r[nv] for w, r in runs if w == "against"][0]
            col = other["rows"].abs().amax(dim=0).clamp(min=1e-30)
            entry["rows_rel_diff_of_column_max"] = float(
                ((rows - other["rows"]).abs() / col).max())
            col = other["sums"].abs().amax(dim=0).clamp(min=1e-30)
            entry["sums_rel_diff_of_column_max"] = float(
                ((this[0]["sums"] - other["sums"]).abs() / col).max())
        if len(this) > 1:
            entry["repeat_bit_equal"] = bool(
                torch.equal(this[0]["rows"], this[1]["rows"])
                and torch.equal(this[0]["sums"], this[1]["sums"]))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
