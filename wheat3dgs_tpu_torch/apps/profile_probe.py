"""Times the scan probe's three kinds on the card, against other trees' builds.

    python -m wheat3dgs_tpu_torch.apps.profile_probe [--against DIR[,DIR...]]

On the apps/prof_scan input, a (1024, 128) float32 block of 0.001s, each
kind of the probe kernel (matmul, cumsum, roll) is timed with 256 and with
64 steps (utils/cuda_timing: REPS launches after two of warm-up, queued
behind a spin on the card); the slope between the two is the time a step
costs. With --against DIR[,DIR...], the `csrc/` directories of other trees
with the same C entry point (the parent's, say), scan_probe.cu is also
built from each and the builds run in turns (each DIR, this tree twice,
each DIR again in reverse) on the same input in this process. Each build
reports its cluster size (null for a build without a cluster), its ptxas
registers, spills and shared memory, whether its repeats are bit-equal,
its largest difference from the plain version over the block's largest
value (on this input and on a seeded normal block) and, for the others,
the largest difference of its result from this tree's. Beside them, the
same loop with torch.cumsum as the scan (apps/prof_scan.cumsum_loop), run
eagerly and replayed from a CUDA graph (the library's time without the
host's launches). Prints the card's name and power limit, a line per kind,
then one JSON line. Needs a card.
"""

from __future__ import annotations

import contextlib
import json
import re
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..utils.cuda_timing import bound, cuda_time_ms, graphed, smi_line

P, C = 1024, 128
STEPS, SHORT = 256, 64
REPS = 20


def _ptxas() -> dict:
    """Registers, spills and shared memory of the scan_probe build just
    made, from its compiler log."""
    from ..ops import cuda_build

    log = (cuda_build.BUILD_DIR / "scan_probe.log").read_text()
    return {"registers": [int(r) for r in re.findall(
                r"Used (\d+) registers", log)],
            "spill_store_bytes": [int(b) for b in re.findall(
                r"(\d+) bytes spill stores", log)],
            "smem_bytes": [int(b) for b in re.findall(
                r"(\d+) bytes smem", log)]}


def _run(inputs: dict, refs: dict) -> dict:
    """Each kind of the current build, timed at STEPS and SHORT steps on
    the first input; {kind: (ms, short ms, output, repeat bit-equal, the
    largest difference from the plain version over its max)}."""
    from ..ops.scan_probe import KINDS, scan_probe

    x = inputs["ones"]
    res = {}
    for kind in KINDS:
        first = scan_probe(x, kind, STEPS)
        again = scan_probe(x, kind, STEPS)
        err = {}
        for name, inp in inputs.items():
            ref = refs[kind, name]
            got = scan_probe(inp, kind, STEPS)
            err[name] = float((got - ref).abs().max() / ref.abs().max())
        torch.cuda.synchronize()
        res[kind] = (
            cuda_time_ms(lambda: scan_probe(x, kind, STEPS), REPS),
            cuda_time_ms(lambda: scan_probe(x, kind, SHORT), REPS),
            first, torch.equal(first, again), err)
    return res


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default="",
                    help="comma-separated csrc/ directories of other trees "
                         "to time in turns with this one")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..ops import cuda_build
    from ..ops.scan_probe import KINDS, cluster_size, scan_probe_plain
    from .prof_scan import cumsum_loop

    dev = resolve_device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    inputs = {"ones": torch.full((P, C), 0.001, dtype=torch.float32,
                                 device=dev),
              "normal": torch.as_tensor(np.random.default_rng(0).normal(
                  size=(P, C)).astype(np.float32), device=dev)}
    refs = {(kind, name): scan_probe_plain(inp, kind, STEPS)
            for kind in KINDS for name, inp in inputs.items()}
    others = [d for d in args.against.split(",") if d]
    order = others + ["this", "this"] + others[::-1] if others else ["this"]
    builds, runs = {}, []
    for which in order:
        with (cuda_build.sources(which) if which != "this"
              else contextlib.nullcontext()):
            if which not in builds:
                compiled = cuda_build.build(["scan_probe"])
                builds[which] = {"cluster": cluster_size(),
                                 "ptxas": _ptxas() if compiled else None}
            runs.append((which, _run(inputs, refs)))

    # The function's bound, as chip_smoke.py's: the block read and written
    # once, 4 operations a value and step.
    bound_ms, bound_by = bound(2 * P * C * 4, P * C * STEPS * 4)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "shape": {"rows": P, "lanes": C, "steps": STEPS,
                        "short_steps": SHORT},
              "reps": REPS, "order": order, "builds": builds,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "kinds": {}}
    for kind in KINDS:
        this = [r[kind] for w, r in runs if w == "this"]
        entry = {}
        for which in dict.fromkeys(order):
            sel = [r[kind] for w, r in runs if w == which]
            ms, short = min(s[0] for s in sel), min(s[1] for s in sel)
            e = entry[which] = {
                "ms": [s[0] for s in sel], "ms_short": [s[1] for s in sel],
                "us_per_step": (ms - short) * 1e3 / (STEPS - SHORT),
                "repeat_bit_equal": all(s[3] for s in sel),
                "err_of_plain_max": {n: max(s[4][n] for s in sel)
                                     for n in inputs}}
            if which == "this":
                e["runs_bit_equal"] = all(torch.equal(this[0][2], s[2])
                                          for s in this)
            else:
                top = float(this[0][2].abs().max())
                e["max_diff_of_max"] = float(
                    (this[0][2] - sel[0][2]).abs().max()) / top
        report["kinds"][kind] = entry
        print(kind, " ".join(f"{w}: {min(entry[w]['ms']):.4f} ms "
                             f"({entry[w]['us_per_step']:.3f} us/step)"
                             for w in entry), flush=True)
    x = inputs["ones"]
    replay = graphed(lambda: cumsum_loop(x, STEPS))
    report["library"] = {
        "torch.cumsum loop, eager": cuda_time_ms(
            lambda: cumsum_loop(x, STEPS), 3),
        "torch.cumsum loop, CUDA graph": cuda_time_ms(replay, REPS)}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
