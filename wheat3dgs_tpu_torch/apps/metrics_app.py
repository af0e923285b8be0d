"""NVS metric runner (reference: metrics.py).

Counterpart of wheat3dgs_tpu/apps/metrics_app.py: walks
`<model>/test/<method>/{renders,gt}`, computes SSIM / PSNR / LPIPS on the
device and writes results.json + per_view.json in the reference schema
(metrics.py:81-91). LPIPS is null unless a weights npz is given (see
ops/lpips.py).

    python -m wheat3dgs_tpu_torch.apps.metrics_app -m <model>
        [--lpips_weights auto[:vgg|alex|squeeze]|<npz>] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from .. import resolve_device
from ..ops.losses import psnr, ssim

_AUTO = ("auto", "auto:vgg", "auto:alex", "auto:squeeze")


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    arr = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    return arr[..., :3].transpose(2, 0, 1)


def evaluate(model_paths, lpips_weights: str | None = None, device="cuda"):
    from ..ops import lpips as lpips_mod

    dev = resolve_device(device)
    lpips_fn = None
    # --lpips_weights, or the WHEAT3DGS_LPIPS_WEIGHTS variable.
    lpips_weights = lpips_weights or os.environ.get("WHEAT3DGS_LPIPS_WEIGHTS")
    lpips_note = None
    if lpips_weights in _AUTO:
        # The deterministic He-init stand-in: numeric and reproducible, but
        # not comparable to published LPIPS; results are labeled below.
        net = lpips_weights.split(":")[1] if ":" in lpips_weights else "vgg"
        lpips_weights = lpips_mod.default_weights(net)
    if lpips_weights and os.path.exists(lpips_weights):
        lpips_fn = lpips_mod.load_lpips(lpips_weights, device=dev)
        if lpips_mod.is_untrained(lpips_weights):
            lpips_note = ("untrained He-init backbone (synthesize_lpips_"
                          "weights) — not comparable to published LPIPS")

    for model_path in model_paths:
        print("Scene:", model_path)
        full, per_view = {}, {}
        test_dir = os.path.join(model_path, "test")
        for method in sorted(os.listdir(test_dir)):
            rdir = os.path.join(test_dir, method, "renders")
            gdir = os.path.join(test_dir, method, "gt")
            if not os.path.isdir(rdir):
                # eval_wheatgs_app's segmentation/ and overlay/ sit beside
                # the method dirs and hold no renders (JAX's metrics app
                # stops on them, so the root eval.sh fails on a model that
                # has been through run_wheat_3dgs.sh).
                print(f"Skipping {method}: no renders/")
                continue
            print("Method:", method)
            names = sorted(os.listdir(rdir))
            ssims, psnrs, lpipss = [], [], []
            for nm in names:
                r = torch.as_tensor(read_image(os.path.join(rdir, nm)),
                                    device=dev)
                g = torch.as_tensor(read_image(os.path.join(gdir, nm)),
                                    device=dev)
                ssims.append(float(ssim(r, g)))
                psnrs.append(float(psnr(r, g)))
                lpipss.append(float(lpips_fn(r, g)) if lpips_fn else None)
            print(f"  SSIM: {np.mean(ssims):.7f}")
            print(f"  PSNR: {np.mean(psnrs):.7f}")
            if lpips_fn:
                print(f"  LPIPS: {np.mean(lpipss):.7f}")
            full[method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": float(np.mean(lpipss)) if lpips_fn else None}
            if lpips_note:
                full[method]["LPIPS_note"] = lpips_note
            per_view[method] = {
                "SSIM": dict(zip(names, map(float, ssims))),
                "PSNR": dict(zip(names, map(float, psnrs))),
                "LPIPS": dict(zip(names, lpipss))}
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
    return full


def main(argv=None):
    parser = ArgumentParser(description="wheat3dgs_tpu_torch metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument(
        "--lpips_weights", type=str, default=None,
        help="npz with torchvision-VGG16 conv weights (features.<i>.weight"
             "/.bias) + LPIPS heads (lin<k>.model.1.weight); build one "
             "from the standard checkpoints with "
             "scripts/convert_lpips_weights.py. Also read from "
             "WHEAT3DGS_LPIPS_WEIGHTS. 'auto[:vgg|alex|squeeze]' uses the "
             "deterministic untrained stand-in (labeled in results.json). "
             "Without it LPIPS is emitted null.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.lpips_weights, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
