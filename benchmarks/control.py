"""The readings that set a cell's limits: the control of `correct` and the
faults planted under the timed path, on the card at the cell's own size.

    python3 benchmarks/control.py --workload <name> --seconds <s> \
        --seeds 11 12 13 [--fault tf32|state_unchanged|loss_altered|
                                  half_the_pixels|no_clones|sh_band_dropped]

Runs the cell through the harness (benchlib/harness.run) once a seed, in
one process, and prints one JSON line a run with every number compared.
`tf32` (the default) runs the program as it is and reads beside its
numbers the control's: the reference in TF32 put in the program's place,
from the same starts, held against the reference in float32. The other
names plant a fault in the program first: a step that leaves the state
unchanged (Adam's update skipped), the L1 term's mean taken over half the
image's rows (half the batch left out), the loss scaled by 1.01 where it
is produced, a densify that clones nothing, the SH colour without its
first band above the DC term. The benchmark's own runs never run this; it
needs a CUDA card.
"""

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import argparse  # noqa: E402

import torch  # noqa: E402

FAULTS = ("tf32", "state_unchanged", "loss_altered", "half_the_pixels",
          "no_clones", "sh_band_dropped")


def plant(fault: str, patch=setattr) -> None:
    """Break the program underneath the harness: patch(module, name,
    value) (setattr: for the rest of the process)."""
    import wheat3dgs_tpu_torch.models.gaussians as G
    import wheat3dgs_tpu_torch.training as T
    from wheat3dgs_tpu_torch.utils import sh

    if fault == "state_unchanged":
        patch(T, "adam_update", lambda *a, **k: None)
    elif fault == "loss_altered":
        l1 = T.l1_loss
        patch(T, "l1_loss", lambda a, b: 1.01 * l1(a, b))
    elif fault == "half_the_pixels":
        l1 = T.l1_loss
        patch(T, "l1_loss", lambda a, b: l1(a[:, :a.shape[1] // 2],
                                            b[:, :b.shape[1] // 2]))
    elif fault == "no_clones":
        masks = G.densify_masks

        def no_clones(*a, **k):
            m = masks(*a, **k)
            m["clone"] = torch.zeros_like(m["clone"])
            return m

        patch(G, "densify_masks", no_clones)
    elif fault == "sh_band_dropped":
        basis = sh.sh_basis

        def dropped(deg, dirs):
            out = basis(deg, dirs)
            return [out[0]] + [torch.zeros_like(b) for b in out[1:4]] \
                + out[4:]

        patch(sh, "sh_basis", dropped)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=FAULTS, default="tf32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from benchlib import harness

    if args.fault != "tf32":
        plant(args.fault)
    for seed in args.seeds:
        out = harness.run(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          control=args.fault == "tf32", t_start=time.time())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": out["correct"],
                          "checks": out["checks"],
                          "control": out.get("control"),
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
