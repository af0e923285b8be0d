"""Densification traces of the port's training CLI, with its kernels or
all-plain, and their comparison.

    python wheat3dgs_tpu_torch/scripts/densify_trace.py run [--plain]
        [--eager] -- <apps.train_vanilla arguments>
    python wheat3dgs_tpu_torch/scripts/densify_trace.py compare
        NAME=MODEL/metrics.jsonl ...

`run` trains through `apps.train_vanilla.main` and prints the densify
records it logged (metrics.jsonl's `densify` lines: n_clone, n_split,
n_pruned_opacity, n_pruned, n_alive, the entry budget, the block's
entries_total, the overflow events so far). `--plain` routes the five
rasterizer kernels to their plain versions (`cuda_raster.plain_kernels`);
`--eager` runs every block's steps one by one instead of replaying a CUDA
graph (`training_graph.eager_steps`; the plain versions read the host, so
a plain run on the card needs it). `compare` prints the runs' records side by side, one row per densify
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

FIELDS = ("n_clone", "n_split", "n_pruned_opacity", "n_pruned", "n_alive",
          "entry_budget", "entries_total", "overflow_events")


def densify_records(path: str) -> dict:
    """{iteration: densify record} of one metrics.jsonl."""
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    return {r["iter"]: r["densify"] for r in rows if "densify" in r}


def test_psnr(path: str) -> dict:
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    return {r["iter"]: r["test_psnr"] for r in rows if "test_psnr" in r}


def run(argv) -> dict:
    from wheat3dgs_tpu_torch.apps import train_vanilla
    from wheat3dgs_tpu_torch.ops import cuda_raster
    from wheat3dgs_tpu_torch.training_graph import eager_steps

    parser = ArgumentParser()
    parser.add_argument("--plain", action="store_true")
    parser.add_argument("--eager", action="store_true")
    args, rest = parser.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    with contextlib.ExitStack() as stack:
        if args.plain:
            stack.enter_context(cuda_raster.plain_kernels())
        if args.eager:
            stack.enter_context(eager_steps())
        trainer, scene = train_vanilla.main(rest + ["--quiet"])
    path = os.path.join(scene.model_path, "metrics.jsonl")
    recs = densify_records(path)
    print(f"densify records of {path} (plain={args.plain}, "
          f"eager={args.eager}):")
    print("iter " + " ".join(FIELDS))
    for it, r in sorted(recs.items()):
        print(f"{it} " + " ".join(str(r[k]) for k in FIELDS))
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
