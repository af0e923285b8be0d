"""One run of one cell: set-up, the measured window, the check against the
reference, the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: its
configuration file (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<workload>.json`) and, with
--trace 1, one reader per per-layer metric (`metrics/<metric>.py`, a
`read(run)` that returns a number or None). See PERF.md for the metrics.

Set-up (setup_s: from the process's start to the window's first step):
the plot from the configuration (scene.py), the program's initial state
from its point cloud, the first steps one at a time through the window's
own call (their readings kept for the check), then the mix's iterations up
to the window's first, and the driver's warm-up of what the window will
meet (drive.py). The window runs a fixed number of iterations from the
seed's run: --seconds at the mix's nominal rate (`window_rate`, it/s),
rounded up to whole units of its schedule (`window_unit`: a densify
cycle), stopping early only past three times --seconds; then it
synchronises: train_it_s is every plot-iteration of the window over its
wall time. In the window, the first block at each SH degree the ramp
reaches runs its first steps one at a time so that their readings can be
taken (drive.py). With --trace 1 the window runs under torch.profiler,
each block in a host span (ended by a synchronise, so that the span times
it), and samples the state now and then for the work counts (work.py).
After the window: the memory peak is read, the program's state is freed,
and the reference runs (check.py).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "wheat3dgs_tpu")
SAMPLES = 8          # state samples for the work counts in a traced window
THREADS = 2          # the host's intra-op threads: one process, few threads
CAP = 3              # the window stops past CAP x --seconds in any case


def parse(argv):
    ap = argparse.ArgumentParser(description="run one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Cell:
    """A workload's entries and files, looked up by name under `root`."""

    def __init__(self, root: Path, workload: str):
        self.root = root
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        here = root / self.bench["paths"][0]
        self.here = here
        wl = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not wl:
            raise SystemExit(f"unknown workload {workload!r}")
        self.workload = wl[0]
        cfg = [c for c in self.bench["configs"]
               if c["name"] == self.workload["config"]][0]
        self.config = json.loads((root / cfg["file"]).read_text())
        self.mix = json.loads(
            (here / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads(
            (here / "limits" / f"{workload}.json").read_text())

    @property
    def sh_start(self) -> int:
        """The SH degree of the first steps: the top one, or 0 under the
        ramp (the published trainer starts at 0)."""
        return self.config["sh_degree"] if self.mix["sh"] == "max" else 0

    def window_its(self, seconds: float) -> int:
        """The window's iterations: `seconds` at the mix's nominal rate,
        rounded up to whole units of its schedule."""
        unit = self.mix["window_unit"]
        return unit * max(1, math.ceil(seconds * self.mix["window_rate"]
                                       / unit))

    def sh_due(self, first: int, last: int) -> list:
        """The SH degrees the ramp reaches in iterations first..last."""
        if self.mix["sh"] == "max":
            return []
        return [d for d in range(1, self.config["sh_degree"] + 1)
                if first <= 1000 * d <= last]

    def metrics(self, trace: bool) -> list:
        if not trace:
            return [m for m in self.bench["end_to_end"] if self._mine(m)]
        return [m for m in self.bench["per_layer"] if self._mine(m)]

    def _mine(self, m: dict) -> bool:
        return "workloads" not in m or self.workload["name"] in m["workloads"]

    def reader(self, name: str):
        path = self.here / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _geometry(states) -> dict:
    """What the work counts need of a (P, cap, ...) state: a copy of the
    geometry, the opacity and the alive mask."""
    p = states.params
    return {"means": p.means.clone(), "quats": p.quats.clone(),
            "log_scales": p.log_scales.clone(),
            "opacity_logit": p.opacity_logit.clone(),
            "alive": states.alive.clone()}


def count_work(samples: list, plots: list) -> list:
    """Per sampled (plot, view): the weighted pairs, visible and alive
    splats, pixels and SH degree (the reference's forward pass)."""
    from reference.raster import render

    out = []
    for geo, views, deg in samples:
        for p, v in enumerate(views):
            pl = plots[p]
            params = {k: geo[k][p] for k in ("means", "quats", "log_scales",
                                             "opacity_logit")}
            alive = geo["alive"][p]
            zero = torch.zeros_like(params["means"])
            r = render(params, pl.cams[v], pl.width, pl.height, 0,
                       colors=zero, alive=alive)
            out.append({"weighted": r.weighted,
                        "visible": int(r.proj.index.shape[0]),
                        "alive": int(alive.sum()),
                        "pixels": pl.width * pl.height, "sh_degree": deg})
    return out


class Phases:
    """Prints each set-up phase's seconds on stderr."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self, name: str) -> None:
        now = time.time()
        print(f"phase {name} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def densify_due(mix: dict, first: int, last: int) -> bool:
    """Whether iterations first..last hold a densify of the mix."""
    o = mix["optimization"]
    if not mix["densify"]:
        return False
    step = o["densification_interval"]
    it = (max(first, o["densify_from_iter"] + 1) + step - 1) // step * step
    return it <= min(last, o["densify_until_iter"] - 1)


def judge(cell, plot, first, sh_recs, rec, it0, last_it, densify_it, dev,
          control=False):
    """The numbers `correct` compares, each with its limit, where each was
    read, and (control) the same numbers of the reference in TF32 put in
    the program's place."""
    from . import check

    cfg, mix, lim = cell.config, cell.mix, cell.limits
    jobs = [("", first, None, cell.sh_start)]
    jobs += [("sh_", r, r["start"], r["degree"]) for r in sh_recs]
    numbers, worst, ctl = {}, {}, {}
    for prefix, prog, start, deg in jobs:
        views = [v[0] for v in prog["views"]]
        args = (plot, views, prog["its"], cfg["sh_degree"], deg, mix, dev)
        refr = check.reference_steps(*args, start=start)
        print(f"reference losses at SH {deg}, iterations {prog['its']}: "
              f"{refr['losses']}", file=sys.stderr)
        where = {}
        for k, v in check.step_gaps(prog, [refr], where).items():
            name = prefix + k
            if v >= numbers.get(name, (-1.0,))[0]:
                numbers[name] = (v, lim[name])
                worst[name] = (f"SH {deg} " if prefix else "") + where[k]
        if control:
            low = check.reference_steps(*args, low=True, start=start)
            for k, v in check.step_gaps(check.as_program(low),
                                        [refr]).items():
                ctl[prefix + k] = max(ctl.get(prefix + k, 0.0), v)
    for d in cell.sh_due(it0, last_it):
        if not any(r["degree"] == d for r in sh_recs):
            for k in ("loss_gap", "grad_gap", "change_gap"):
                numbers["sh_" + k] = (float("inf"), lim["sh_" + k])
    if densify_due(mix, it0, last_it):
        if rec.pre is None:
            numbers["densify_mismatch"] = (float("inf"),
                                           lim["densify_mismatch"])
        else:
            rule = dict(mix["optimization"], min_opacity=mix["min_opacity"])
            world = densify_it > mix["optimization"]["opacity_reset_interval"]
            numbers["densify_mismatch"] = (float(check.densify_mismatch(
                rec.pre, rec.post, rule, plot.extent, world)),
                lim["densify_mismatch"])
    return numbers, worst, ctl


def run(argv=None, root: Path = None, device=None, t_start: float = None,
        control: bool = False):
    """The cell's result line (a dict), or None after a refusal. `device`
    None is the command line's path: it needs the card. control: also
    read the control of `correct` (the reference in TF32 in the program's
    place, from the same starts) under the key "control"; the benchmark's
    own runs never do."""
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    root = Path(root) if root else Path.cwd()
    cell = Cell(root, args.workload)
    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None
        device = "cuda:0"
    dev = torch.device(device)
    torch.set_num_threads(THREADS)
    if dev.type == "cuda":
        print(f"card: {_smi()}", file=sys.stderr)
    cache = root / "wheat3dgs_tpu_torch" / "_build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))

    from wheat3dgs_tpu_torch.models import gaussians as G

    from . import check, tracing
    from .drive import Single
    from .scene import make_plot, plot_seed

    cfg, mix = cell.config, cell.mix
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = Phases(t_start)
    phase("imports")
    plot = make_plot(cfg["scene"], plot_seed(cfg["scene"]["seed"], 0), dev)
    _sync(dev)
    phase("scene")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = Single(cfg, mix, plot, args.seed, dev)
    _sync(dev)
    phase("program_init")
    n_check = mix["checked_steps"]
    first = driver.first_steps(n_check)
    _sync(dev)
    phase("first_steps")
    while driver.it < mix["window_from_iter"]:
        driver.run_block()
    driver.warm_up()
    _sync(dev)
    phase("warm_up")
    setup_s = time.time() - t_start

    trace = bool(args.trace)
    rec = check.DensifyRecorder(G)
    blocks, samples, sh_recs, overflows = [], [], [], []
    n_setup_captures = len(driver.captures())
    failed0 = driver.failed()
    densify_it = None
    n_its = cell.window_its(args.seconds)
    with rec:
        rec.armed = True
        prof = tracing.start() if trace else None
        it0 = driver.it
        seen_deg = driver.sh_degree()
        t0 = time.perf_counter()
        next_sample = 0.0
        while driver.it - it0 < n_its:
            if trace and time.perf_counter() - t0 >= next_sample:
                samples.append((_geometry(driver.stacked()),
                                driver.peek_views(), driver.sh_degree()))
                next_sample += args.seconds / SAMPLES
            k = driver.next_len()
            record = n_check if driver.block_degree(k) > seen_deg else 0
            b0 = time.perf_counter()
            if trace:
                with tracing.span(str(len(blocks))):
                    k, kind, got = driver.run_block(record)
                    _sync(dev)
            else:
                k, kind, got = driver.run_block(record)
            blocks.append((k, kind, time.perf_counter() - b0))
            if driver.failed() > failed0 + len(overflows):
                overflows.append(driver.it - 1)
            if got is not None:
                sh_recs.append(got)
                seen_deg = got["degree"]
            if densify_it is None and rec.pre is not None:
                densify_it = driver.it - 1
            if time.perf_counter() - t0 >= CAP * args.seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
        t_stop = time.time()
        if prof is not None:
            prof.stop()
        captures = driver.captures()[n_setup_captures:]
    plot_its = driver.it - it0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    summary = {}
    if prof is not None:
        Phases(t_stop)("trace_stop")
        t_read = time.time()
        summary = tracing.summarize(prof, label=lambda s: blocks[int(s)][1])
        del prof
        Phases(t_read)("trace_read")
    last_it = driver.it - 1
    failed = driver.failed() - failed0
    sh_recs = [driver.to_host(r) for r in sh_recs]
    plain = sorted(sec / k for k, kind, sec in blocks if kind == "replayed")
    print(f"window {window_s:.3f} s, {plot_its} plot-iterations, "
          f"{len(blocks)} blocks, {len(captures)} captures "
          f"({sum(captures):.3f} s), replayed blocks' median "
          f"{1e3 * plain[len(plain) // 2] if plain else 0:.3f} ms a step, "
          f"other blocks {sum(sec for _, kind, sec in blocks if kind != 'replayed'):.3f} s; "
          f"{driver.describe()}; overflows counted at {overflows}",
          file=sys.stderr)
    del driver
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phase = Phases(time.time())
    numbers, worst, ctl = judge(cell, plot, first, sh_recs, rec, it0, last_it,
                                densify_it, dev, control)
    correct = all(v <= lim for v, lim in numbers.values())
    phase("reference")

    metrics = {}
    if not trace:
        vals = {"train_it_s": plot_its / window_s, "setup_s": setup_s}
        for m in cell.metrics(False):
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        runrec = {
            "window_s": window_s, "plot_iterations": plot_its,
            "blocks": blocks,
            "captures_s": captures,
            "trace": summary, "work": count_work(samples, [plot]),
        }
        for m in cell.metrics(True):
            v = cell.reader(m["name"])(runrec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        phase("trace_readers")

    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    if trace and summary:
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
    out = {"correct": bool(correct), "attempted": plot_its, "failed": failed,
           "metrics": metrics, "device": device_rec}
    if trace and summary:
        out["breakdown"] = summary["breakdown"]
    if control:
        out["control"] = ctl
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        at = f" at {worst[k]}" if worst.get(k) else ""
        print(f"check {k} {v!r} limit {lim!r}{at}", file=sys.stderr)
    return out


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None, t_start=None) -> int:
    out = run(argv, t_start=t_start)
    if out is None:
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0
