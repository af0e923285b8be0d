#!/usr/bin/env python
"""Aggregate per-plot metric artifacts into per-scene and mean / std CSVs:
the counterpart of the repo's summarize_results.py, without pandas.

    python wheat3dgs_tpu_torch/scripts/summarize_results.py -b BASE
        [--methods ours nerfacto ...] [-o OUT]

Two layouts are understood:
- ours: <base>/plot_*/results.json (apps/metrics_app's), method
  "wheat3dgs/<latest ours_* key>", storage the size of point_cloud/ in MB;
- nerfstudio baselines: <base>/plot_*/<method>/<run>/test_results.json of
  the latest `%Y-%m-%d_%H%M%S` run, storage its nerfstudio_models/*.ckpt.

It writes results_per_scene.csv and results_summary.csv (each numeric
column's mean and sample std per method) byte for byte as the root
script's pandas `to_csv` writes them: columns in the order the rows first
name them, a column numeric when its values are all numbers (None and NaN
aside) and not all missing, float text as Python's repr, empty fields for
None and NaN, methods in sorted order, the mean a compensated (Kahan) sum
over the count and the std Welford's update, as pandas' groupby
computes them. The per-scene table is printed in a plain layout of its
own. The machine with the card has no pandas, so this one runs there.

It reads and writes files on the host only and runs no tensor code, so it
takes no --device: it needs no card and nothing in it can use one.
"""

from __future__ import annotations

import csv
import json
import math
import os
import sys
from argparse import ArgumentParser
from datetime import datetime
from pathlib import Path


def _dir_size_mb(path: Path) -> float:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total / 1e6


def collect_ours(base: Path) -> list:
    rows = []
    for plot in sorted(p for p in base.iterdir()
                       if p.is_dir() and p.name.startswith("plot_")):
        res = plot / "results.json"
        if not res.exists():
            print(f"results.json not found for {plot.name}")
            continue
        with open(res) as f:
            data = json.load(f)
        method_key = sorted(data.keys())[-1]   # latest ours_<iteration>
        m = data[method_key]
        pc_dir = plot / "point_cloud"
        rows.append({
            "scene": plot.name, "method": f"wheat3dgs/{method_key}",
            "psnr": m.get("PSNR"), "ssim": m.get("SSIM"),
            "lpips": m.get("LPIPS"),
            "storage_mb": _dir_size_mb(pc_dir) if pc_dir.exists() else None})
    return rows


def collect_nerfstudio(base: Path, method: str) -> list:
    rows = []
    for plot in sorted(p for p in base.iterdir()
                       if p.is_dir() and p.name.startswith("plot_")):
        mdir = plot / method
        if not mdir.is_dir():
            print(f"Method {method} not found for {plot.name}")
            continue
        runs = [f for f in mdir.iterdir() if f.is_dir()
                and len(f.name) == 17 and f.name[4] == "-"]
        if not runs:
            continue
        latest = sorted(runs, key=lambda x: datetime.strptime(
            x.name, "%Y-%m-%d_%H%M%S"))[-1]
        tr = latest / "test_results.json"
        if not tr.exists():
            continue
        with open(tr) as f:
            results = json.load(f)["results"]
        ckpts = list((latest / "nerfstudio_models").glob("*.ckpt")) \
            if (latest / "nerfstudio_models").exists() else []
        rows.append({
            "scene": plot.name, "method": method,
            "psnr": results.get("psnr"), "ssim": results.get("ssim"),
            "lpips": results.get("lpips"), "fps": results.get("fps"),
            "storage_mb": sum(os.path.getsize(c) for c in ckpts) / 1e6
            if ckpts else None})
    return rows


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def column_kinds(rows: list, columns: list) -> dict:
    """Each column's kind as pandas infers its dtype from the rows:
    "int" (numbers, all ints, none absent), "float" (numbers with a float,
    NaN included, or an absent value among them) or "object" (anything
    else, e.g. strings, bools, or no value but None). A row without the
    column holds NaN there, as in a DataFrame built from the rows."""
    kinds = {}
    for c in columns:
        vals = [r.get(c, math.nan) for r in rows]
        present = [v for v in vals if v is not None]
        if not present or not all(_is_number(v) for v in present):
            kinds[c] = "object"
        elif len(present) == len(vals) and all(isinstance(v, int)
                                               for v in present):
            kinds[c] = "int"
        else:
            kinds[c] = "float"
    return kinds


def _text(v, kind: str) -> str:
    """A value as pandas' to_csv writes it in a column of `kind`."""
    if _missing(v):
        return ""
    if kind == "float":
        return repr(float(v))
    return str(v)


def group_mean(vals: list) -> float:
    """pandas' groupby mean: a Kahan-compensated sum over the present
    values, divided by their count; NaN when none is present."""
    total = comp = 0.0
    n = 0
    for v in vals:
        if _missing(v):
            continue
        n += 1
        y = float(v) - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / n if n else math.nan


def group_std(vals: list, ddof: int = 1) -> float:
    """pandas' groupby std: Welford's update over the present values,
    sqrt(M2 / (n - ddof)); NaN for n <= ddof."""
    n, mean, m2 = 0, 0.0, 0.0
    for v in vals:
        if _missing(v):
            continue
        n += 1
        old = mean
        mean += (float(v) - old) / n
        m2 += (float(v) - mean) * (float(v) - old)
    return math.sqrt(m2 / (n - ddof)) if n > ddof else math.nan


def write_per_scene(path: Path, rows: list, columns: list,
                    kinds: dict) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([_text(r.get(c), kinds[c]) for c in columns])


def summary_rows(rows: list, columns: list, kinds: dict) -> list:
    """[(method, {column: (mean, std)})] over the numeric columns, methods
    sorted."""
    numeric = [c for c in columns if kinds[c] != "object"]
    out = []
    for method in sorted({r["method"] for r in rows}):
        group = [r for r in rows if r["method"] == method]
        out.append((method, {c: (group_mean([r.get(c) for r in group]),
                                 group_std([r.get(c) for r in group]))
                             for c in numeric}))
    return out


def write_summary(path: Path, summary: list, numeric: list) -> None:
    """The (column, statistic) header rows, the index name's row, then a
    row per method (pandas' layout of a MultiIndex-column frame)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + [c for c in numeric for _ in ("mean", "std")])
        w.writerow([""] + ["mean", "std"] * len(numeric))
        w.writerow(["method"] + [""] * (2 * len(numeric)))
        for method, stats in summary:
            w.writerow([method] + [_text(x, "float") for c in numeric
                                   for x in stats[c]])


def print_table(rows: list, columns: list, kinds: dict) -> None:
    cells = [[_text(r.get(c), kinds[c]) or "NaN" for c in columns]
             for r in rows]
    widths = [max([len(c)] + [len(row[i]) for row in cells])
              for i, c in enumerate(columns)]
    print(" ".join(c.rjust(n) for c, n in zip(columns, widths)))
    for row in cells:
        print(" ".join(v.rjust(n) for v, n in zip(row, widths)))


def main(argv=None) -> None:
    parser = ArgumentParser()
    parser.add_argument("--base_path", "-b", required=True)
    parser.add_argument("--methods", nargs="*", default=["ours"])
    parser.add_argument("--output_folder", "-o", default=".")
    args = parser.parse_args(argv)
    base = Path(args.base_path)
    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)

    all_rows = []
    for method in args.methods:
        rows = collect_ours(base) if method == "ours" else \
            collect_nerfstudio(base, method)
        all_rows += rows
    if not all_rows:
        sys.exit("no results found")
    columns = list(dict.fromkeys(k for r in all_rows for k in r))
    kinds = column_kinds(all_rows, columns)
    per_scene = out / "results_per_scene.csv"
    write_per_scene(per_scene, all_rows, columns, kinds)
    numeric = [c for c in columns if kinds[c] != "object"]
    summary_path = out / "results_summary.csv"
    write_summary(summary_path, summary_rows(all_rows, columns, kinds),
                  numeric)
    print_table(all_rows, columns, kinds)
    print(f"wrote {per_scene} and {summary_path}")


if __name__ == "__main__":
    main()
