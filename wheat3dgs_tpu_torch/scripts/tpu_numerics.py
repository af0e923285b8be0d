"""What JAX's training and segmentation computed on a TPU, as patches of
the port, and a runner that enters them around one app's `main`.

    python wheat3dgs_tpu_torch/scripts/tpu_numerics.py [--tpu_knn]
        [--bf16_grads] [--bf16_replay] [--seed N] -- <module>
        <app arguments>

<module> is one of the port's apps (`apps.train_vanilla`,
`apps.run_3d_seg_app`, or its full dotted name); its `main` runs with the
app arguments and the patches entered, each restored when it returns.

- `tpu_knn(device)`: model initialization (models/gaussians.create_from_pcd)
  sizes its splats with the 3-NN distance as JAX's `ops/knn.py::
  knn_mean_sq_dist` computes it on a TPU (one bfloat16 matmul pass,
  `ops/knn.knn_mean_sq_dist_bf16`, on `device`).
- `bf16_grads()`: the backward's per-splat segment sum
  (cuda_raster.segsum) adds entry gradient rows rounded to bfloat16, as
  JAX's Pallas backward rounds every per-entry gradient column before its
  segment sum (ops/pallas_raster.py:1464-1482). Training's backward and
  the FlashSplat lift (the gradient of an 8-channel render) both reach it.
- `bf16_replay()`: the backward replay (cuda_raster.composite_bwd, through
  `rasterize`'s backward) takes its three products from bfloat16
  operands with float32 sums, as JAX's `_bwd_kernel` computes them on a
  TPU (ops/pallas_raster.py:964-990): u = gmat . ent, the prefix of w u
  and the value-row gradients gmat . w. Training and the lift both reach
  it. It wraps whatever `cuda_raster.composite_bwd` is when it is
  entered, so enter `cuda_raster.plain_kernels()` before it, not inside
  it. A CUDA graph (training_graph.StepGraph) captured before it is
  entered replays the float32 replay it captured, so enter it before any
  Trainer is built; the runner does.
- `train_seed(n)`: the Trainer's split-noise generator is seeded with n
  (its default is 0, as JAX's training seeds 0); runs that differ only in
  it give a spread of the port's own, otherwise deterministic, runs.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import os
import sys
from argparse import ArgumentParser
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def tpu_knn(device):
    """Model initialization (models/gaussians.create_from_pcd) sizes its
    splats with the TPU's 3-NN distance while this is entered."""
    from wheat3dgs_tpu_torch.models import gaussians
    from wheat3dgs_tpu_torch.ops.knn import knn_mean_sq_dist_bf16

    return mock.patch.object(
        gaussians, "knn_mean_sq_dist",
        lambda points, k=3: knn_mean_sq_dist_bf16(points, k, device=device))


def bf16_grads():
    """The backward's per-splat segment sum (cuda_raster.segsum) adds
    entry gradient rows rounded to bfloat16 while this is entered."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster

    segsum = cuda_raster.segsum
    return mock.patch.object(
        cuda_raster, "segsum", lambda vals, start, end: segsum(
            vals.to(torch.bfloat16).float(), start, end))


def bf16_replay():
    """`rasterize`'s backward replay (cuda_raster.composite_bwd) rounds its
    products' operands to bfloat16 (its bf16_ops) while this is entered."""
    from wheat3dgs_tpu_torch.ops import cuda_raster

    return mock.patch.object(cuda_raster, "composite_bwd", functools.partial(
        cuda_raster.composite_bwd, bf16_ops=True))


def train_seed(n: int):
    """Every Trainer built while this is entered seeds its split noise
    with n, unless its caller passes a seed."""
    from wheat3dgs_tpu_torch.training import Trainer

    init = Trainer.__init__
    sig = inspect.signature(init)

    @functools.wraps(init)
    def seeded(self, *args, **kw):
        if "seed" not in sig.bind_partial(self, *args, **kw).arguments:
            kw["seed"] = n
        init(self, *args, **kw)

    return mock.patch.object(Trainer, "__init__", seeded)


def app_module(name: str):
    """The port's app module `name` (`apps.train_vanilla` or its full
    dotted name)."""
    if not name.startswith("wheat3dgs_tpu_torch."):
        name = "wheat3dgs_tpu_torch." + name
    if not name.startswith("wheat3dgs_tpu_torch.apps."):
        raise SystemExit(f"tpu_numerics: {name} is not one of the port's "
                         "apps")
    return importlib.import_module(name)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" not in argv:
        raise SystemExit(__doc__)
    cut = argv.index("--")
    ap = ArgumentParser(prog="tpu_numerics.py")
    ap.add_argument("--tpu_knn", action="store_true")
    ap.add_argument("--bf16_grads", action="store_true")
    ap.add_argument("--bf16_replay", action="store_true")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv[:cut])
    rest = argv[cut + 1:]
    if not rest:
        raise SystemExit(__doc__)
    app, app_args = app_module(rest[0]), rest[1:]
    print(f"tpu_numerics: {app.__name__} with tpu_knn={args.tpu_knn}, "
          f"bf16_grads={args.bf16_grads}, bf16_replay={args.bf16_replay}, "
          f"seed={args.seed}", file=sys.stderr)
    with contextlib.ExitStack() as stack:
        if args.tpu_knn:
            stack.enter_context(tpu_knn(
                app_args[app_args.index("--device") + 1]
                if "--device" in app_args else "cuda"))
        if args.bf16_grads:
            stack.enter_context(bf16_grads())
        if args.bf16_replay:
            stack.enter_context(bf16_replay())
        if args.seed is not None:
            stack.enter_context(train_seed(args.seed))
        return app.main(app_args)


if __name__ == "__main__":
    main()
