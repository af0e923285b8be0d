"""Times the two forward compositors at the bench shapes on the card.

    python -m wheat3dgs_tpu_torch.apps.profile_forward [--against DIR]
        [--out output/profile_forward]

Builds the bench plot (the port's synthetic generator, seed 0: 200,000
splats, 12 views at 1600x1200) and its SH-3 stand-in model in a work
directory under --out, takes train view 0, and times with CUDA events
(utils/cuda_timing: REPS launches after two of warm-up, queued
behind a spin on the card so that the events time the card's work and not
the host's enqueueing):
- composite_fwd alpha-only (0 value rows) of ground-truth head 1 at the
  segmentation's subset budget (the find-&-match renders), with depth
  (1 row) at the scene budget (evaluation's per-head renders), and on the
  full view at 4 rows (depth + RGB, serving);
- composite_train_fwd on the full view at 4 rows (training) and at 9
  (depth + 8 label rows, the segmentation lift);
- composite_fwd on an all-empty stream (every tile's segment empty) at
  1600x1200 and 0 rows: the cost of covering the grid and storing zeros.
Each shape also reports its stream (tiles with entries, the longest tile
segment, entries), the (pixel, entry) pairs of the front-to-back walk and
the bound they set (utils/cuda_timing.fwd_bound, chip_smoke.py's), and
the sub-tile cull's counts (cuda_raster.fwd_block_steps).
With --against DIR[,DIR...], the `csrc/` directories of other trees with
the same C entry points (the parent's, say), composite_fwd.cu is also
built from each and the builds run in turns (each DIR, this tree twice,
each DIR again in reverse) on the same inputs in this process; the report
adds, for each build, the largest difference of its image from this
tree's over the image's largest value, the pixels whose stop differs,
whether its repeats are bit-equal, and its registers and largest spill
(ptxas). Prints the card's name and power limit, a line per shape, then
one JSON line. Needs a card.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..utils.cuda_timing import cuda_time_ms, fwd_bound, smi_line

BENCH = dict(width=1600, height=1200, n_cams=12, n_heads=32,
             pts_per_head=3000, ground_pts=104_000, seed=0)
REPS = 50


def _shapes(scene, scene_dir, dev):
    """{shape name: (kernel name, compositor arguments)} on train view 0."""
    from ..ops import cuda_raster as CR
    from ..ops.projection import project_gaussians
    from ..render.pipeline import adapt_config, subset_stream

    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    cam = cams[0]
    budget = adapt_config(st, cam, w, h, cams=cams).entry_budget
    seg_budget = max(2048, (budget // 8 + 127) // 128 * 128)
    gt = np.load(os.path.join(scene_dir, "gt_points.npz"))["head_id"]
    head = torch.zeros((st.capacity,), dtype=torch.bool, device=dev)
    head[:len(gt)] = torch.as_tensor(gt == 1, device=dev)
    out = {}
    for name, with_depth, b in (("subset_0rows", False, seg_budget),
                                ("subset_1row_scene_budget", True, budget)):
        out[name] = ("composite_fwd",
                     subset_stream(st, cam, head, w, h, b, with_depth)[0])
    with torch.no_grad():
        for nv, colors in ((4, None), (9, torch.zeros((st.capacity, 8),
                                                      device=dev))):
            kw = {"sh": st.sh(), "sh_degree": scene.sh_degree} \
                if colors is None else {"colors": colors}
            splats = project_gaussians(
                st.params.means, st.scales(), st.params.quats, st.opacity(),
                *cam, w, h, **kw)
            plan = CR.alloc_prologue(splats, w, h, budget)
            key, _ = CR.decode_cull(plan)
            skeys, starts, ends = CR.sorted_stream(key, plan.t_total,
                                                   plan.rank_bits)
            feat = CR.entry_features(splats, plan.order, True, True)
            args = (skeys, starts, ends, feat, plan.rank_bits, w, h)
            if nv == 4:
                out["full_4rows"] = ("composite_fwd", args)
                out["train_full_4rows"] = ("composite_train_fwd", args)
            else:
                out["train_lift_9rows"] = ("composite_train_fwd", args)
    skeys, starts, _, feat, rank_bits, _, _ = out["subset_0rows"][1]
    empty = torch.zeros_like(starts)
    out["empty_0rows"] = ("composite_fwd", (skeys, empty, empty, feat,
                                            rank_bits, w, h))
    return out


def _stats(args) -> dict:
    """The stream's shape, walk and bound, and the sub-tile cull's counts
    (with the longest list of kept entries any sub-tile walks)."""
    from ..ops import cuda_raster as CR

    skeys, starts, ends, feat, rank_bits, w, h = args
    lens = (ends - starts).long()
    nv = feat.shape[1] - 6
    _, (visited, weighted) = CR.composite_fwd_plain(*args, with_counts=True)
    kept, walked, kernel_visited = CR.fwd_block_steps(*args)
    keep = CR.fwd_subtile_keep(*args)
    per = torch.zeros((starts.shape[0] + 1, 4), dtype=torch.int64,
                      device=keep.device)
    per.index_add_(0, (skeys >> rank_bits).clamp(max=starts.shape[0]),
                   keep.long())
    bound_ms, bound_by = fwd_bound(
        int(lens.sum()), starts.shape[0], feat.numel(), nv, w, h, visited,
        weighted)
    return {"value_rows": nv, "tiles": starts.shape[0],
            "tiles_with_entries": int((lens > 0).sum()),
            "longest_segment": int(lens.max()), "entries": int(lens.sum()),
            "visited_pairs": visited, "weighted_pairs": weighted,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "cull": {"subtile_pairs_kept": kept,
                     "subtile_pairs_tested": walked,
                     "kernel_visited_pairs": kernel_visited,
                     "longest_kept_list": int(per[:-1].max())}}


def _ptxas() -> dict:
    """Registers and the largest spill of the composite_fwd build just
    made, from its compiler log."""
    import re

    from ..ops import cuda_build

    log = (cuda_build.BUILD_DIR / "composite_fwd.log").read_text()
    return {"registers": sorted({int(r) for r in re.findall(
                r"Used (\d+) registers", log)}),
            "max_spill_store_bytes": max((int(b) for b in re.findall(
                r"(\d+) bytes spill stores", log)), default=0)}


def _run(shapes) -> dict:
    """Each shape's kernel of the current build, timed; {shape: (ms, image,
    stop or None, repeat bit-equal)}."""
    from ..ops import cuda_raster as CR

    res = {}
    for name, (kernel, args) in shapes.items():
        def call(args=args, fn=getattr(CR, kernel)):
            return fn(*args)
        first, again = call(), call()
        torch.cuda.synchronize()
        img, stop = first if isinstance(first, tuple) else (first, None)
        img2 = again[0] if isinstance(again, tuple) else again
        equal = torch.equal(img, img2) and (
            stop is None or torch.equal(stop, again[1]))
        res[name] = (cuda_time_ms(call, REPS), img, stop, equal)
    return res


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default="",
                    help="comma-separated csrc/ directories of other trees "
                         "to time in turns with this one")
    ap.add_argument("--out", default=os.path.join("output",
                                                  "profile_forward"))
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
    # Built first, so that the compiler's log read here is this tree's
    # (none when the build predates this run).
    compiled = cuda_build.build(["composite_fwd", "decode_cull"])
    ptxas = {"this": _ptxas() if "composite_fwd" in compiled else None}
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
    shapes = _shapes(scene, scene_dir, dev)

    others = [d for d in args.against.split(",") if d]
    order = others + ["this", "this"] + others[::-1] if others else ["this"]
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "reps": REPS, "order": order, "ptxas": ptxas, "shapes": {}}
    runs = []
    for which in order:
        with (cuda_build.sources(which) if which != "this"
              else contextlib.nullcontext()):
            if which not in ptxas:
                compiled = cuda_build.build(["composite_fwd"])
                ptxas[which] = _ptxas() if compiled else None
            runs.append((which, _run(shapes)))
    for name, (kernel, sargs) in shapes.items():
        entry = {"kernel": kernel, **_stats(sargs)}
        this = [r[name] for w, r in runs if w == "this"]
        for which in dict.fromkeys(order):
            sel = [r[name] for w, r in runs if w == which]
            e = entry[which] = {"ms": [s[0] for s in sel],
                                "repeat_bit_equal": all(s[3] for s in sel)}
            e["share_of_bound"] = entry["bound_ms"] / min(e["ms"])
            if which == "this":
                e["runs_bit_equal"] = len(this) < 2 or torch.equal(
                    this[0][1], this[1][1])
                continue
            top = float(sel[0][1].abs().max())
            e["image_max_diff_of_max"] = float(
                (this[0][1] - sel[0][1]).abs().max()) / (top if top else 1.0)
            if sel[0][2] is not None:
                e["stop_pixels_differing"] = int(
                    (this[0][2] != sel[0][2]).sum())
        report["shapes"][name] = entry
        print(name, " ".join(f"{w}: {min(entry[w]['ms']):.4f}"
                             for w in dict.fromkeys(order)), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
