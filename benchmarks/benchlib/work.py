"""The work a training step needs, counted from its inputs: operations and
bytes that any implementation has to spend, whatever the program does.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s HBM3.

Per weighted (pixel, splat) pair (alpha >= 1/255 before the pixel's stop;
counted by the plain reference's forward pass):
- forward compositing, FWD_PAIR_OPS = 26: alpha (the offsets 2, the conic
  quadratic 7, the -0.5 and e^x 2, times opacity 1, the clamp and the floor
  test 2 = 14), the transmittance (1 - alpha, the product, the stop test,
  the weight: 4) and the weighted sum of 3 colours and the weight (8);
- backward replay, BWD_PAIR_OPS = 58: alpha again (14) and the
  transmittance (4), the colour cotangent's dot u (8), the prefix (2),
  d alpha (4), d power (1), d xy (8), d conic (9), d opacity (2) and
  d colour (6).
Bytes of the compositors, each input read once and each output written
once: a splat's row (x, y, conic, opacity, 3 colours: 36 B) read per
visible splat; per pixel the forward writes 3 colours and the weight sum
(16 B), the backward reads the cotangent (12 B), the image (12 B) and the
final transmittance (4 B) and writes a gradient row per visible splat
(36 B).
The rest of the step, per pixel and colour channel: L1 (3 forward, 3
backward), SSIM's five separable 11-tap blurs (5 x 44 forward, 5 x 44
backward) and its map (18 forward, 30 backward); per splat projection
(100 forward, 200 backward), SH at degree d (6 (d+1)^2 + 3 d^2 forward,
twice that backward), the screen-space statistic (5); per parameter
(59 a splat) Adam's update (12).
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FWD_PAIR_OPS = 26
BWD_PAIR_OPS = 58
ROW_BYTES = 36
PARAMS_PER_SPLAT = 59


def compositor_work(weighted: int, visible: int, pixels: int) -> dict:
    """{kernel: (operations, bytes)} of the two compositors of one view."""
    return {
        "composite_train_fwd": (weighted * FWD_PAIR_OPS,
                                visible * ROW_BYTES + pixels * 16),
        "composite_bwd": (weighted * BWD_PAIR_OPS,
                          visible * 2 * ROW_BYTES + pixels * 28),
    }


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time one H100 takes: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def step_ops(weighted: int, alive: int, pixels: int, sh_degree: int) -> float:
    """Operations of one training step on one view (module docstring)."""
    k = (sh_degree + 1) ** 2
    per_pixel = 3 * (6 + 5 * 44 * 2 + 18 + 30)
    per_splat = 300 + 3 * (6 * k + 3 * sh_degree ** 2) + 5 \
        + 12 * PARAMS_PER_SPLAT
    return (weighted * (FWD_PAIR_OPS + BWD_PAIR_OPS) + pixels * per_pixel
            + alive * per_splat)


def kernel_roofline(run: dict, kernel: str, pattern: str):
    """A compositor's share of its roofline in a traced run (%): the mean
    least time per call over the sampled (plot, view)s, over the kernel's
    mean device time per call (its trace name matching `pattern`)."""
    from .tracing import kernel_time

    if not run["work"] or not run["trace"]:
        return None
    secs, calls = kernel_time(run["trace"]["kernels"], pattern)
    if not calls:
        return None
    least = sum(least_seconds(*compositor_work(
        w["weighted"], w["visible"], w["pixels"])[kernel])
        for w in run["work"]) / len(run["work"])
    return 100.0 * least / (secs / calls)
