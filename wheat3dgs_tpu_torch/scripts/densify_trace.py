"""Densification traces of the port's training CLI, with its kernels or
all-plain, and their comparison.

    python wheat3dgs_tpu_torch/scripts/densify_trace.py run [--plain]
        [--eager] [--xla TILE] [--tpu_knn] [--bf16_grads]
        [--bf16_replay] --
        <apps.train_vanilla arguments>
    python wheat3dgs_tpu_torch/scripts/densify_trace.py compare
        NAME=MODEL/metrics.jsonl ...

`run` trains through `apps.train_vanilla.main` and prints the densify
records it logged (metrics.jsonl's `densify` lines: n_clone, n_split,
n_pruned_opacity, n_pruned, n_alive, the entry budget, the block's
entries_total, the overflow events so far). `--plain` routes the five
rasterizer kernels to their plain versions (`cuda_raster.plain_kernels`);
`--eager` runs every block's steps one by one instead of replaying a CUDA
graph (`training_graph.eager_steps`; the plain versions read the host, so
a plain run on the card needs it). `--xla TILE` trains on the padded-tile
backend (`RasterConfig(backend="xla", tile=TILE)`: autograd's gradients in
place of the hand-written backward) with rungs that crop nothing:
max_tiles_per_gauss (a power of two) and max_per_tile (a rung of
{4, 5, 6, 7} * 2^k) are raised to the uncapped maxima over every train
view at each probe, never lowered, and each densify record carries them.
`--tpu_knn` initializes the splats' scales from points3D with the 3-NN
distance as JAX's training computes it on a TPU
(`ops/knn.knn_mean_sq_dist_bf16`, on the run's `--device`) in place of
the exact one: what JAX's runs on a TPU started from. `--bf16_grads`
rounds every entry's gradient row to bfloat16 before the per-splat
segment sum (`cuda_raster.segsum`), as JAX's backward at commit 54bd0ea
did (it sorted them packed as bfloat16 pairs). `--bf16_replay` takes the
backward replay's three products from bfloat16 operands with float32
sums, as JAX's `_bwd_kernel` does on a TPU. The patches are
tpu_numerics.py's, entered after `--plain`'s and before the CLI builds
its Trainer.
`compare` prints the runs' records side by side, one row per densify
iteration, with the last run's n_alive relative to the first's.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from argparse import ArgumentParser

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpu_numerics import bf16_grads, bf16_replay, tpu_knn  # noqa: E402

FIELDS = ("n_clone", "n_split", "n_pruned_opacity", "n_pruned", "n_alive",
          "entry_budget", "entries_total", "overflow_events")
XLA_FIELDS = ("max_per_tile", "max_tiles_per_gauss")


def densify_records(path: str) -> dict:
    """{iteration: densify record} of one metrics.jsonl."""
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    return {r["iter"]: r["densify"] for r in rows if "densify" in r}


def test_psnr(path: str) -> dict:
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    return {r["iter"]: r["test_psnr"] for r in rows if "test_psnr" in r}


# Pixels x entries per batch of tiles of an --xla run (a float32
# temporary of ~0.5 GB).
XLA_BATCH_ELEMS = 1 << 27


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _rung(n: int) -> int:
    """The smallest {4, 5, 6, 7} * 2^k at or above n (steps of <= 25%)."""
    k = 1
    while 7 * k < n:
        k *= 2
    return next(m * k for m in (4, 5, 6, 7) if m * k >= n)


def no_crop_trainer(tile: int):
    """A Trainer class on the padded-tile backend at `tile` whose occupancy
    probe covers every train view it has been given (step_block's camera
    stacks) with no crop."""
    import dataclasses

    import torch

    from wheat3dgs_tpu_torch.ops.binning import (capped_rect, count_tiles,
                                                 num_tiles)
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians
    from wheat3dgs_tpu_torch.render.pipeline import RasterConfig, zero_colors
    from wheat3dgs_tpu_torch.training import Trainer

    class NoCropTrainer(Trainer):
        def __init__(self, *args, **kw):
            kw["config"] = RasterConfig(backend="xla", tile=tile,
                                        max_tiles_per_gauss=1,
                                        max_per_tile=1)
            super().__init__(*args, **kw)
            self._stacks = None

        def step_block(self, it0, view_idx, cam_stacks, *args, **kw):
            self._stacks = cam_stacks
            return super().step_block(it0, view_idx, cam_stacks, *args,
                                      **kw)

        @torch.no_grad()
        def _refresh_occupancy(self, cam, width, height):
            st = self.state
            cams = ([tuple(a[i] for a in self._stacks)
                     for i in range(self._stacks[0].shape[0])]
                    if self._stacks is not None else [cam])
            tx, ty = num_tiles(width, height, tile)
            mtpg, mpt = self.config.max_tiles_per_gauss, 1
            for c in cams:
                s = project_gaussians(
                    st.params.means, st.scales(), st.params.quats,
                    st.opacity(), *c, width, height,
                    colors=zero_colors(st))
                _, _, sx, sy, _ = capped_rect(s, tx, ty, tile, 1 << 30)
                area = int(torch.where(s.radius > 0, sx * sy,
                                       torch.zeros_like(sx)).max())
                mtpg = max(mtpg, _pow2(area))
                mpt = max(mpt, int(count_tiles(s, width, height, tile,
                                               mtpg).max()))
            mpt = max(self.config.max_per_tile, _rung(mpt))
            self.config = dataclasses.replace(
                self.config, max_tiles_per_gauss=mtpg, max_per_tile=mpt,
                tile_batch=max(1, XLA_BATCH_ELEMS // (tile * tile * mpt)))
            self._occupancy_due = False

    return NoCropTrainer


def run(argv) -> dict:
    from wheat3dgs_tpu_torch.apps import train_vanilla
    from wheat3dgs_tpu_torch.ops import cuda_raster
    from wheat3dgs_tpu_torch.training_graph import eager_steps

    parser = ArgumentParser()
    parser.add_argument("--plain", action="store_true")
    parser.add_argument("--eager", action="store_true")
    parser.add_argument("--xla", type=int, default=0, metavar="TILE")
    parser.add_argument("--tpu_knn", action="store_true")
    parser.add_argument("--bf16_grads", action="store_true")
    parser.add_argument("--bf16_replay", action="store_true")
    args, rest = parser.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    with contextlib.ExitStack() as stack:
        if args.plain:
            stack.enter_context(cuda_raster.plain_kernels())
        if args.eager:
            stack.enter_context(eager_steps())
        if args.xla:
            from unittest import mock

            stack.enter_context(mock.patch.object(
                train_vanilla, "Trainer", no_crop_trainer(args.xla)))
        if args.tpu_knn:
            stack.enter_context(tpu_knn(
                rest[rest.index("--device") + 1] if "--device" in rest
                else "cuda"))
        if args.bf16_grads:
            stack.enter_context(bf16_grads())
        if args.bf16_replay:
            stack.enter_context(bf16_replay())
        trainer, scene = train_vanilla.main(rest + ["--quiet"])
    path = os.path.join(scene.model_path, "metrics.jsonl")
    recs = densify_records(path)
    print(f"densify records of {path} (plain={args.plain}, "
          f"eager={args.eager}, xla={args.xla}, tpu_knn={args.tpu_knn}, "
          f"bf16_grads={args.bf16_grads}, bf16_replay={args.bf16_replay})"
          ":")
    fields = FIELDS + (XLA_FIELDS if args.xla else ())
    print("iter " + " ".join(fields))
    for it, r in sorted(recs.items()):
        print(f"{it} " + " ".join(str(r[k]) for k in fields))
    print(f"test psnr: {test_psnr(path)}; final n_alive "
          f"{int(trainer.state.num_alive)}", flush=True)
    return recs


def compare(argv) -> list:
    runs = []
    for a in argv:
        name, path = a.split("=", 1)
        runs.append((name, densify_records(path), test_psnr(path)))
    its = sorted(set().union(*(r[1] for r in runs)))
    print("iter " + " ".join(f"{n}:{k}" for n, _, _ in runs
                             for k in ("n_clone", "n_split", "n_pruned",
                                       "n_alive", "overflow_events"))
          + " last/first n_alive")
    table = []
    for it in its:
        row = [it]
        for _, recs, _ in runs:
            r = recs.get(it, {})
            row += [r.get(k) for k in ("n_clone", "n_split", "n_pruned",
                                       "n_alive", "overflow_events")]
        a0 = runs[0][1].get(it, {}).get("n_alive")
        a1 = runs[-1][1].get(it, {}).get("n_alive")
        row.append(round(a1 / a0, 4) if a0 and a1 else None)
        table.append(row)
        print(" ".join(str(x) for x in row))
    for name, _, tp in runs:
        print(f"{name} test psnr: {tp}")
    return table


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("run", "compare"):
        raise SystemExit(__doc__)
    (run if argv[0] == "run" else compare)(argv[1:])


if __name__ == "__main__":
    main()
