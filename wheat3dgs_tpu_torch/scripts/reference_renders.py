"""A trained exp_bench2 model's test renders against JAX's saved ones.

    python wheat3dgs_tpu_torch/scripts/reference_renders.py MODEL [--ref DIR]

JAX's exp_bench2 run saved its first three test renders as
docs/quality/00000.png - 00002.png (test cameras 10, 11 and 22 of the
36-camera plot). For each save `MODEL/test/ours_<it>/` that
apps/render_sets wrote, this prints, for those three views, the PSNR of
the port's render against JAX's render, of the port's ground truth (the
scene's image, `gt/`) against JAX's render and of the port's render
against its ground truth, with the texture statistics
(utils/image_stats.py) of all three images: one JSON object on stdout.
A gap between the port's model and JAX's render splits so into a
different ground truth and a different model.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
from PIL import Image

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

from wheat3dgs_tpu_torch.utils import image_stats as S  # noqa: E402

VIEWS = 3


def _read(path: str) -> np.ndarray:
    return S.unit(np.asarray(Image.open(path).convert("RGB")))


def score(model: str, ref: str) -> dict:
    test = os.path.join(model, "test")
    saves = sorted((d for d in os.listdir(test) if d.startswith("ours_")),
                   key=lambda d: int(d.split("_")[1]))
    if not saves:
        raise SystemExit(f"no test renders under {test}")
    out = {}
    for d in saves:
        rows = []
        for k in range(VIEWS):
            name = f"{k:05d}.png"
            jax = _read(os.path.join(ref, name))
            render = _read(os.path.join(test, d, "renders", name))
            gt = _read(os.path.join(test, d, "gt", name))
            rows.append({
                "view": name,
                "psnr_render_vs_jax": S.psnr(render, jax),
                "psnr_gt_vs_jax": S.psnr(gt, jax),
                "psnr_render_vs_gt": S.psnr(render, gt),
                "texture": {"jax": S.texture(jax), "render": S.texture(render),
                            "gt": S.texture(gt)}})
        out[d.split("_")[1]] = rows
    return out


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model")
    ap.add_argument("--ref", default=os.path.join(ROOT, "docs", "quality"))
    args = ap.parse_args(argv)
    out = score(args.model, args.ref)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
