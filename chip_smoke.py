#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wheat3dgs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero when either is missing, and
when run outside a checkout of the repo. Phases, each reported on a line:

1. device: the card's name and power limit (nvidia-smi);
2. build: the five CUDA sources of the six kernels from csrc/, compiled
   in parallel;
3. data: the bench's synthetic plot (32 heads x 3000 + 104,000 ground =
   200,000 splats, 12 ring views at 1600x1200 -> 10 train / 2 test) made
   with the port's generator from seed 0, and a "trained" SH-degree-3
   model PLY made from its ground truth (seeded f_rest and per-axis scale
   jitter);
4. kernels: the serving kernels against their plain PyTorch versions on
   one full-width view (decode_cull keys and alive count exactly equal;
   composite_fwd within the stated tolerance and bit-identical over two
   launches), both timed with CUDA events;
5. serving path: `apps/render_sets.main` over both splits with the launch
   counters reset just before and read just after, the PNG trees checked,
   every view's entries_total checked against its budget, one view checked
   against the plain compositor, and the steady render_fwd FPS;
6. train kernels: the training kernels against their plain versions on
   train view 0 of the stand-in model under the L1 + SSIM loss against
   that view's image (composite_train_fwd, composite_bwd, segsum within
   the stated bounds; each bit-identical over two launches),
   composite_bwd's live and walked (warp, entry) steps counted
   from the plain replay, the end-to-end parameter gradients of the kernel
   path against the all-plain path (within 2% of each leaf's max |g|),
   each kernel, its plain version and, for segsum, torch.segment_reduce
   timed with CUDA events;
7. training path: `apps/train_vanilla.main` on the bench scene (100,000
   initial points from points3D, SH 3, bench.py's densify schedule) with
   the launch counters reset just before and read just after, its blocks
   of K > 1 steps replayed from a CUDA graph (Trainer.step_block): finite
   logged losses, a densify event, each training kernel counted once per
   step, the entry-budget watchdog on every step and block, the graph's
   captures (no more than densify events + budget changes + 1), replays
   and capture seconds, the test PSNR rise, and the saved PLY rendered
   through `apps/render_sets`;
8. steady training rate: Trainer.step and Trainer.step_block at SH
   degree 3 in turns (step, block, block, step) of TRAIN_BLOCK iterations
   that end before a multiple of 40 (no densify or probe inside), on the
   host clock;
8b. block against eager steps: a block of BLOCK_CHECK steps from a fresh
   capture against the same steps run eagerly, twice, from copies of the
   trained state: every state tensor and metric bit-identical, or within
   the spread of the two eager runs;
9. segmentation kernels, on train view 0 of the stand-in model: the lift's
   kernels at 9 value rows (depth + 8 label channels: composite_train_fwd,
   composite_bwd, segsum) against their plain versions (and as in phase 6
   for composite_bwd and segsum) and its (8, N) counts against the
   all-plain path; composite_fwd alpha-only (0 value rows) at a subset
   budget, with depth (1 value row) and on an all-empty frame (an all-zero
   image), all timed; the forward compositors' sub-tile cull counted at
   every forward shape of phases 4, 6 and 9 (cuda_raster.fwd_block_steps);
   composite_train_fwd's counting build at 9 rows (LiftOut.contrib_num)
   against the plain walk's per-pixel count (off pixels under
   STOP_MISMATCH_MAX, as the stop), bit-identical over two launches, with
   the image and stop of the build without, timed in turns with it; and
   lift_view's used_count and contrib_num against the all-plain path;
10. segmentation path: `apps/run_3d_seg_app.main` on the bench scene and
   the stand-in model with the launch counters reset just before and read
   just after: the artifact tree, the head ids in the 2DSeg maps, the
   subset-budget ladder, seconds and calls per lift / match / predbits, the
   device's busy share over association steps, and the heads scored
   against the generator's ground truth (gt_points.npz);
11. evaluation path: `apps/eval_wheatgs_app.main` on the same model
   (all_counts.pt and the test split's segmentation / overlay PNGs);
12. metrics: `apps/metrics_app.main` on phase 7's test renders (the
   trained model, 1600x1200) with each LPIPS stand-in net (vgg, alex,
   squeeze), the launch counters reset before and read after (no
   rasterizer kernel runs there): results.json / per_view.json schema and
   LPIPS_note, each view's SSIM / PSNR / LPIPS against the port's CPU
   values on the same PNGs, seconds per image from each net's second run
   (the first, which may write the stand-in weights, timed apart), one
   image's PNG reads, SSIM + PSNR and LPIPS forward timed alone;
13. 360 field: `apps/render_360_app.main --render_type field` on the
   stand-in model and phase 10's experiment with run_wheat_3dgs.sh's
   arguments cut to FIELD_360's 100 frames (the script's 200) at 800x600,
   the head overlay, counters reset
   just before and read just after: the labels and the video (the app
   itself raises on a frame over its probed budget), frame 0 against the
   plain compositors (colour image within the composite tolerance, the
   overlaid head apart on at most OVERLAY_OFF_MAX of the pixels, no other
   channel more than 1 level apart), frames per second on the host clock
   over the orbits and over the whole run (its budget probes, lift and
   encoding timed apart), and the device's busy share over a few frames
   (torch.profiler);
14. 360 head: the same with `--render_type head` (HEAD_360's 50 frames
   per head, the script's 100, at 533x400), one video per head PLY
   without a letter suffix;
15. viewer: `apps/viewer_app.build_viewer` with the field run's labels,
   served on a free port in a thread: /info, /teleport and 20 /render
   requests at 960x720 with and without the overlay and with a head
   whitelist, each a JPEG of that size, ms per request, re-probes, one
   overlaid frame's image before JPEG against the plain compositors (as
   the 360 frame, in float);
16. morphology: `morphology.run_pipeline` at the reference config
   (wheatheadsmorphology/config.yaml's values) on the heads phase 10 wrote,
   once on the card and once on the CPU from the same seeded np.random:
   the traits xlsx, the boxes and the merged PLY of kept points byte-equal
   (so each head's kept set, traits and box), a row per head, seconds a
   head on each device split into cluster, SOR and traits;
17. pipeline: `wheat3dgs_tpu_torch/scripts/run_wheat_3dgs.sh` on the
   pipeline plot (PIPELINE_SCENE: the bench plot's generator at 800x600
   with 8 heads) into a fresh model dir (DEVICE=cuda, ITERS=PIPELINE_ITERS),
   each `python` call through a runner that logs its seconds and the kernel
   launches in that process (and whether `python` is on PATH): every step
   exits 0, the saved iteration, results.json, the head PLYs, the eval
   PNGs and all_counts.pt, both 360 mp4 kinds, a traits xlsx with a row per
   head PLY; then `scripts/eval.sh` on the same model. Its processes run
   in a thread beside phases 10-16, as phase 24's do (each process counts
   its own launches);
18. the scan probe: each kind of the kernel against its plain version on
   the probe's input and a seeded normal block, and at the cluster's edge
   shapes (8 rows, fewer than its CTAs; 1000 rows, not a multiple of them;
   the probe's 1024 is the most it holds), two launches bit-identical,
   `steps = 0` returning the input, a row past the cluster's capacity
   refused; timed at 256 and 64 steps (the slope is the time a step
   costs) beside a torch.cumsum loop, eager and replayed from a CUDA graph;
   then `apps/prof_scan.main` with the counters reset;
19. multi-plot training: `apps/train_multi.main` on two bench plots
   (phase 3's scene and the generator's plot 462 from seed 1, 100,000
   points3D each) with MULTI_VIEWS views a step for MULTI_ITERS
   iterations on bench.py's schedule, the launch counters reset just
   before and read just after: finite per-plot losses and a training-PSNR
   rise for each plot, a densify event, each training kernel counted
   P x B times a step, the graph's captures (no more than densify events
   + capacity doublings + SH changes + 1), every step's demand at or under
   its budget (a device maximum read once), both PLYs loaded; the four
   training kernels against their plain versions at the app's shapes
   (each trained plot at the automatic budget, at the run's capacity and
   at its doubling: the loss's gradients within GRAD_REL, the colour
   image as composite_train_fwd's stop); then one
   multi-plot step from copies of the trained states against each plot
   stepped alone and against its own replay (bit-identical, or within the
   spread of two eager runs), the steady rates at SH 3 for P = 1, 2 and
   B = 1, 2 in turns on the host clock, and the device's busy share;
20. bench: `python -m wheat3dgs_tpu_torch.apps.bench` as its own process
   on phase 3's scene (the bench plot) at its default 600 iterations: its
   one JSON line with bench.py's keys, every value finite and positive,
   no training overflow and no render over its budget, and the kernel
   launches of that process, printed; then the kernels against their
   plain versions at the bench's shapes: apps/bench's functions train the
   scene again in this process to its end (~105k splats), the training
   kernels held as in phase 19 at the Trainer's probed budget and SH 3,
   and render_fwd at the render rate's probed budget, on two train views,
   with the budget and capacity printed;
7b (after 8b). the densification decision, kernels against plain: from
   the bench plot's points3D at 1/4 of its size, DECISION_STEPS steps on
   fixed view picks from iteration DECISION_FROM, ending at the densify of
   iteration 3100 (past the opacity reset, so the world-size prune is
   live), once replayed with the kernels and once eagerly all-plain from
   the same state: the splats whose prune / clone / split decision
   differs held under DECISION_DIFF_MAX of the alive ones, the statistic
   grad_accum / denom compared among splats within 2x of the threshold
   (largest and mean signed relative error, hot-only counts each way) and
   the n_alive after the densify printed;
21. distributed: DIST_RANKS processes on this card, each a gloo rank with
   CUDA tensors (its collectives staged through the host), run the
   multi-plot step of `parallel.mesh` over each mesh of DIST_MESHES (1
   plot x 2 views: the gradient all-reduce; tests/test_torch_dist.py
   holds the plot and gauss axes on the CPU) for DIST_STEPS steps from
   the bench plot's points3D at full size, each rank holding its share to
   the one-process multi_plot_step (the loss and the means within JAX's
   tests/test_parallel.py tolerances, the Adam moments and grad_accum
   within DIST_MOMENT_REL of their max), with its launches counted;
22. the padded-tile backend (`RasterConfig(backend="xla")`, plain torch
   ops, autograd), on train view 0 of the stand-in model: (a) render_fwd at
   XLA_TILE with max_tiles_per_gauss and max_per_tile at the view's own
   uncapped maxima (nothing cropped) against the kernels' render_fwd at
   the probed budget (colour, alpha, depth within the composite
   tolerance; pixels off at the stop's T_EPS edge counted under
   STOP_MISMATCH_MAX, as the stop is); (b) at JAX's defaults (tile 16,
   adapt_config's max_per_tile rung) at 400x300 on the card against the
   same render on the CPU (within XLA_CPU_ATOL, edge pixels counted
   likewise); (c) one train_step on (a)'s config against the kernels' step
   from the same state (loss within rel 1e-4, every parameter's first
   Adam moment, i.e. its gradient, within GRAD_REL of its max): autograd
   against composite_bwd + segsum at full size; (d) an XLA_BLOCK-step
   Trainer.step_block replayed from a CUDA graph against the same steps run
   eagerly, twice (bit-identical, or within XLA_SPREAD_FACTOR times the
   two eager runs' spread); (e) the ms of a render_fwd and a train_step on
   each backend (CUDA events), the peak memory of each part, and
   torch.backends.cuda.matmul.allow_tf32, which must be False (the path's
   matmuls are float32);
23. the scene of JAX's exp_bench2 table: exp_bench2's ground-truth scene
   (36 views at 1600x1200, 32 heads x 3000 + 104,000 ground, seed 0)
   built on the card by the generator's _build_gt_scene three ways, no
   files written, with the launch counters reset just before and read
   just after: colour noise 0.05 (the generator of commit 54bd0ea, where
   JAX's table was taken) and 0.15 (today's), both with splats sized by
   the exact 3-NN distance, and 0.05 sized by the 3-NN distance as JAX
   computes it on a TPU (knn="bfloat16"); test cameras 10, 11 and 22
   (JAX's docs/quality/00000-00002.png) rendered through render_fwd and
   quantized as the generator writes them; per camera the mean
   horizontal step and mean 8x8 block std of each image and of JAX's
   render, and the PSNR of JAX's render against each, with each build's
   share of splats at the 1e-4 scale floor. It fails unless, on every
   camera, the 0.05 scene's two statistics are nearer JAX's render than
   the 0.15 scene's, and the TPU kNN's 0.05 scene has a higher PSNR
   against it than the exact kNN's;
24. the envelope chain: `wheat3dgs_tpu_torch/scripts/exp_round5_final.sh`
   at a dwarfed envelope (CHAIN_ENV: 6 heads x 800 + 8,000 ground, 12
   views at 400x300) on the numerics of JAX's band (the TPU kNN's scene
   and start, bfloat16 entry gradients, split-noise seed 1), the scene
   synthesized in this process and training's first leg to CHAIN_SAVES[0]
   through tpu_numerics.py, the chain resuming it to CHAIN_SAVES[1], then
   `diag_psnr_decline.py` over both saves, every `python` through the
   step runner (the processes in a thread beside phases 10-16), the launch
   counters reset just before the synthesis: each step exits 0
   (but the chain's first scoring, which has no segmentation yet, as the
   JAX chain's), the envelope report's keys are JAX's with n_discovered
   >= 1, morph_compare.json has n_pairs, the 360 videos and traits are
   written, the diag's rows of both splits sit at demand / budget <= 1,
   every kernel of the path is launched; then one lift of the chain's
   model passes segsum only bfloat16-exact rows under bf16_grads (and
   not without);
25. the bf16 replay: composite_bwd's BF16 build (cuda_raster's bf16_ops,
   scripts/tpu_numerics.py's bf16_replay(): JAX's TPU rounding of the
   replay's three products) on train view 0 of the stand-in model, at 4
   value rows under the L1 + SSIM loss on a grey background (so that the
   weight-sum row's float32 route is exercised) and at the lift's 9 rows:
   against the flagged plain replay within the default pair's bound and,
   in relative L2, at most BF16_SHARE of the distance of each plain
   replay that rounds other terms (none, the weight-sum row's cotangent,
   the image rows of A), two launches bit-identical, its rows different
   from the default build's, timed in
   turns with it, every BF16 instantiation's ptxas line without spills;
   under the patch the end-to-end gradients within 2% of the all-plain
   path's, and a Trainer built inside it replaying a BF16_BLOCK-step
   block from a CUDA graph that launches the BF16 build once a step and
   the default build never; no default path launched the BF16 build;
26. the root tools without a card's work (A14): the port's
   summarize_results.py over a plot_* layout made from phase 12's
   results.json and apps/vis_cam on the bench scene's sparse/0, each as a
   process in which pandas and matplotlib cannot be imported: the CSVs'
   rows against the file's numbers, the PNG decoded with both splits'
   colours in it;
27. the distributed steps over NCCL (`nccl_path`): one spawned process,
   an NCCL rank of a world of one (NCCL refuses two ranks on one card;
   over one rank a SUM or MAX is the identity), runs the plot x view
   trainer (NCCL_PLOTS copies of the bench plot x MULTI_VIEWS views) and
   the view x gauss trainer for DIST_STEPS steps with a densify after
   step NCCL_DENSIFY_AFTER, the launch counters reset just before and
   read just after: each step replayed from a CUDA graph (at least two
   captures, one replay), bit for bit (every state tensor and metric)
   the same steps under `eager_steps()` and the one-process step
   (multi_plot_step / train_step_views), with the one-process step's
   kernel launches; the collectives a step issues, the card's activities
   of one profiled replay beside the one-process step's, ms a step
   replayed, eager and in one process; then `apps/train_multi --dist_backend
   nccl --world_size 1` with phase 19's arguments, its metrics_multi.jsonl
   (but elapsed_s) and PLYs equal to phase 19's;
28. a `kernels` JSON line, then the device line last.
Work files go to `_smoke_work/` in the checkout and are removed on success.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import shutil
import signal
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
WORK = os.path.join(ROOT, "_smoke_work")

# composite_fwd against its plain version: the kernel sums each pixel's
# weights sequentially with FMA contraction, the plain version per 128-entry
# chunk through a cumsum, so float32 sums differ in order only.
COMPOSITE_ATOL = 1e-4
COMPOSITE_RTOL = 1e-4

# composite_train_fwd: the image as composite_fwd's. Its stop is equal on
# every pixel but those whose transmittance lands within rounding of the
# 1e-4 floor (the kernel's sequential log-T sum against a cumsum); those
# are counted and printed, and held under STOP_MISMATCH_MAX of the pixels.
STOP_MISMATCH_MAX = 1e-3
# composite_bwd: each entry row's sums over up to 1024 pixels run in
# another order (a shuffle tree against a tensor-axis sum); the error is
# held against each column's max |value|.
BWD_REL = 1e-3
# segsum: float32 sums in a shuffle tree against a float64 running sum.
SEGSUM_REL = 1e-5
# End-to-end parameter gradients, kernel path against all-plain path, as
# tests/test_pallas.py holds the TPU backward to XLA autodiff.
GRAD_REL = 0.02
# The segmentation lift's (8, N) counts, kernel path against the all-plain
# path, against each row's max (float32 sums in another order).
LIFT_REL = 1e-3
# The scan probe against its plain version, against the block's max |value|
# (sums in another order, renormalised every step).
PROBE_REL = 1e-5
# Gross-failure gates of the segmentation path on the 32-head bench plot
# (the CPU parity tests hold the algorithm to the JAX package's).
SEG_HEADS = (8, 96)
SEG_MEDIAN_PURITY = 0.5
# The test-split PSNR after TRAIN_ITERS iterations must beat the one after
# the first iteration by this many dB (the first run on an H100 rose
# 7.35 dB, 17.32 -> 24.67).
PSNR_RISE_DB = 3.0
# Phase 7b: the densification decision at 1/4 of the bench's size, over
# the 100 steps that end at the densify of iteration 3100 (past the
# opacity reset at 3000); at most this share of the alive splats may be
# decided differently on the kernel path than on the plain one. The
# kernels gave 1 of 100,000 on exp_bench2's plot (H100, 700 W); ~3,600
# splats lie within 2x of the threshold, so a 1% bias in the statistic
# would flip ~25.
DECISION_RESOLUTION = 4
DECISION_FROM = 3001
DECISION_STEPS = 100
DECISION_DIFF_MAX = 1e-4

BENCH = dict(width=1600, height=1200, n_cams=12, n_heads=32,
             pts_per_head=3000, ground_pts=104_000, seed=0)
ITERATION = 30_000
FPS_RENDERS = 30
TRAIN_ITERS = 300
# Steps per timed turn of phase 8 (a window that ends before the next
# multiple of 40, the densify interval) and in the block of phase 8b.
TRAIN_BLOCK = 39
BLOCK_CHECK = 8
DEVICE = "cuda"
# Phases 12-15 (run_wheat_3dgs.sh's step 2 and 4 arguments with the
# orbits cut to half their frames, 200 and 100, to keep the smoke within
# its time; the viewer's CLI default size).
FIELD_360 = dict(n_frames=100, framerate=20, elevation=45)
HEAD_360 = dict(n_frames=50, framerate=10, elevation=30)
VIEWER_REQUESTS = 20
LPIPS_NETS = ("vgg", "alex", "squeeze")
# metrics on the card against the port's CPU values on the same PNGs:
# SSIM and PSNR relative, LPIPS relative (float32 convolutions summed in
# another order by cuDNN and the CPU's kernels).
METRIC_REL = 1e-5
LPIPS_REL = 1e-4
# An orbit or viewer frame against the same frame through the plain
# compositors: the colour image at COMPOSITE_ATOL / COMPOSITE_RTOL, and no
# channel of the frame more than 1 uint8 level apart, except on pixels
# whose overlaid head differs. Those are counted apart and held under
# OVERLAY_OFF_MAX of the pixels (a head whose claim on a pixel sits at
# eval_obj_labels' alpha 0.5 threshold may flip it).
OVERLAY_OFF_MAX = 1e-3
BUSY_FRAMES = 5
# Phase 16: the morphology at wheatheadsmorphology/config.yaml's values
# (run_wheat_3dgs.sh's step 5).
MORPHOLOGY = {"file_format": "ply", "subsampling_threshold": 5000,
              "clusterer_definition": {"type": "hdbscan", "min_samples": 15,
                                       "min_cluster_size": 250,
                                       "epsilon_hdbscan": 0.015},
              "sor_parameters": {"k": 200, "std_ratio": 3},
              "splines_smoothing_value": 1, "distance_percentile": 99,
              "get_bboxes": True, "get_processed_pcd": True}
# Phase 17: the pipeline script's plot (the bench plot's generator at half
# its width and height, with a quarter of its heads and ground: the
# scripts' eleven processes cost the same at any size, the segmentation
# path at full size is phase 10), its training iterations, cut from
# 15,000 (the other seven steps cost about the same at any count), and a
# limit on each script's run.
PIPELINE_SCENE = dict(width=800, height=600, n_cams=12, n_heads=8,
                      pts_per_head=3000, ground_pts=26_000, seed=0)
PIPELINE_ITERS = 300
# The pipeline's 360 videos at a tenth of the script's frames (phases
# 13-14 render FIELD_360's and HEAD_360's orbits in process).
PIPELINE_FRAMES = {"FIELD_FRAMES": "20", "HEAD_FRAMES": "10"}
SCRIPT_TIMEOUT = 600
# Phase 19: two bench plots trained together, B views a step, on bench.py's
# schedule (densify from 20 every 40, no opacity reset); the second plot
# is the generator's plot 462 from seed 1 at the bench sizes, without
# masks. Rates: steps per timed turn, rounds of turns (each
# configuration twice a round, in mirrored order), steps in the
# busy-share window.
MULTI_ITERS = 200
MULTI_VIEWS = 2
MULTI_DENSIFY_FROM = 20
MULTI_INTERVAL = 40
MULTI_PLOT = dict(plot_id=462, seed=1, with_masks=False)
MULTI_RATE_STEPS = 20
MULTI_RATE_ROUNDS = 3
MULTI_BUSY_STEPS = 5
# Each plot's training PSNR after MULTI_ITERS iterations must beat its
# first step's by this many dB.
MULTI_PSNR_RISE_DB = 1.0
# Phase 20: apps/bench's default iterations and the keys of its line
# (bench.py's).
BENCH_ITERS = 600
# Phase 21: the multi-plot step over DIST_RANKS gloo ranks on the one card
# (CUDA tensors, collectives staged through the host), DIST_STEPS steps on
# each mesh of DIST_MESHES (plots x views: one plot over two view ranks,
# whose gradients are all-reduced; tests/test_torch_dist.py holds the
# plot axis on the CPU), against the one-process step; JAX's
# tests/test_parallel.py tolerances for the loss and the means, each Adam
# moment and grad_accum within DIST_MOMENT_REL of its max |value|.
DIST_RANKS = 2
DIST_MESHES = ((1, 2),)
DIST_STEPS = 3
DIST_LOSS_RTOL = 1e-5
DIST_ATOL = 1e-5
DIST_MOMENT_REL = 1e-4
DIST_JOIN_TIMEOUT = 400.0
# Phase 27: one spawned process, an NCCL rank of a world of one (NCCL
# refuses two ranks on one card; over one rank every SUM and MAX is the
# identity), runs the plot x view trainer on NCCL_PLOTS copies of the bench
# plot (MULTI_VIEWS views each) and the view x gauss trainer on the bench
# plot (MULTI_VIEWS views), DIST_STEPS steps each with a densify after
# step NCCL_DENSIFY_AFTER, replayed from a CUDA graph; each held bit for
# bit to its own eager steps and to the one-process step; ms a step timed
# over NCCL_TIME_REPS calls; then apps/train_multi over NCCL on phase 19's
# two plots with phase 19's arguments, its files equal to phase 19's.
NCCL_PLOTS = 2
NCCL_DENSIFY_AFTER = 2
NCCL_TIME_REPS = 5
NCCL_JOIN_TIMEOUT = 300.0
# Phase 22, the padded-tile ("xla") backend: its tile at full size (the
# entry stream's 32 px), its pixels x entries per batch of tiles (a float32
# temporary of ~0.5 GB), the steps of its replayed block (2: a padded-tile
# step takes ~3.3 s on the H100, and the block runs replayed and twice
# eagerly), and how far a
# replayed block may be from eager steps against two eager runs' spread.
XLA_TILE = 32
XLA_BATCH_ELEMS = 1 << 27
XLA_BLOCK = 2
XLA_SPREAD_FACTOR = 2.0
# The card's padded-tile render against the CPU's (JAX's raster test
# bound, tests/test_raster.py:113), at 1/XLA_CPU_SHRINK of the view's
# width and height (the CPU's render at 800x600 took a minute).
XLA_CPU_ATOL = 2e-5
XLA_CPU_SHRINK = 4
# Phase 23, the scene of JAX's exp_bench2 table: exp_bench2's plot (36
# ring views at 1600x1200) built as each ground truth (colour noise, kNN),
# in this order: the 0.05 scene of commit 54bd0ea and today's 0.15 one,
# both with the exact kNN, then the 0.05 scene with the kNN JAX computes on
# a TPU; and its first three test cameras, whose JAX renders are
# docs/quality/00000-00002.png.
REFERENCE_SCENE = dict(width=1600, height=1200, n_cams=36, n_heads=32,
                       pts_per_head=3000, ground_pts=104_000, seed=0)
REFERENCE_GTS = {"0.05": (0.05, "exact"), "0.15": (0.15, "exact"),
                 "0.05 tpu_knn": (0.05, "bfloat16")}
REFERENCE_CAMS = (10, 11, 22)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "mean_ms",
              "median_ms", "n_splats", "render_fps"]
# Phase 24, the envelope chain: exp_round5_final.sh at a dwarfed envelope
# on the numerics of JAX's band (the TPU kNN's scene and start, bfloat16
# entry gradients, split-noise seed 1), its training in two legs so that
# diag_psnr_decline.py has two saves; the envelope report's keys (JAX's
# scripts/exp_seg_envelope.py's) and the chain's files.
CHAIN_ENV = {"SEG_W": "400", "SEG_H": "300", "SEG_CAMS": "12",
             "SEG_HEADS": "6", "SEG_PTS": "800", "SEG_GROUND": "8000",
             "FRAMES": "8", "HEAD_FRAMES": "4", "SEG_KNN": "bfloat16",
             "SEG_BF16_GRADS": "1", "SEG_SEED": "1"}
CHAIN_SAVES = (300, 600)
# Phase 25: the steps of the block a Trainer built under bf16_replay runs.
BF16_BLOCK = 4
# Phase 25: the BF16 build's rows against the flagged plain replay, in
# relative L2 (||kernel - plain|| / ||plain||), at most this share of the
# distance from the flagged plain replay to each plain replay that rounds
# other terms: a build that rounded as one of them would fail. At 4 rows
# the nearest is the one that also rounds the weight-sum row's cotangent
# (3.41e-5 against the build's 1.65e-6, H100, BF16_BG).
BF16_SHARE = 0.1
# Phase 25's background, not black, so that the weight-sum row (JAX's
# float32 a2 / T_final route) has a cotangent.
BF16_BG = (0.25, 0.5, 0.75)
ENVELOPE_KEYS = ["n_gt_heads", "n_discovered", "n_ply_files",
                 "counting_accuracy", "n_matched_gt", "duplicate_id_count",
                 "metric", "mean_iou", "mean_precision", "mean_recall",
                 "mean_splat_purity", "seg_wall_s", "note", "per_head"]
# cuda_time_ms, bound, fwd_bound and smi_line are bound in main(), from the
# port's utils/cuda_timing, once the port is found next to this script.


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    stop_scripts()
    sys.exit(1)


# The script runs (run_logged) under way, each its own process group.
SCRIPTS: set = set()


def stop_scripts() -> None:
    """Kill every script run under way with all its steps (on a failure,
    at exit and on SIGTERM)."""
    for proc in list(SCRIPTS):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)


def beside(fn, *args):
    """Start fn(*args) in a thread; returns a function that waits for it
    and gives its result, or exits as fn did (fail() in the thread has
    printed its message)."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as exc:    # raised again in the caller
            box["exc"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "exc" in box:
            raise box["exc"]
        return box["out"]
    return join


def say(phase: str, **kv) -> None:
    """A phase's JSON line, with the seconds since main() started."""
    kv["at_seconds"] = time.perf_counter() - T_START
    print(phase + ": " + json.dumps(kv), flush=True)


def make_data(scene_dir: str, model_dir: str) -> int:
    """The bench plot and its SH-3 stand-in model; returns the splat count."""
    from wheat3dgs_tpu_torch.io.synthetic import (make_synthetic_colmap_scene,
                                                  write_stand_in_model)

    make_synthetic_colmap_scene(scene_dir, device=DEVICE, **BENCH)
    return write_stand_in_model(
        model_dir, scene_dir, BENCH["n_heads"], BENCH["pts_per_head"],
        BENCH["ground_pts"], BENCH["seed"], ITERATION, device=DEVICE)


def check_kernels(scene):
    """Phase 4: each kernel against its plain version on train view 0."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config

    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    budget = adapt_config(st, cams[0], w, h, cams=cams).entry_budget
    splats = project_gaussians(
        st.params.means, st.scales(), st.params.quats, st.opacity(),
        *cams[0], w, h, sh=st.sh(), sh_degree=scene.sh_degree)
    plan = CR.alloc_prologue(splats, w, h, budget)
    key_k, alive_k = CR.decode_cull(plan)
    key_p, alive_p = CR.decode_cull_plain(plan)
    torch.cuda.synchronize()
    if not torch.equal(key_k, key_p) or int(alive_k) != int(alive_p):
        bad = int((key_k != key_p).sum())
        fail(f"decode_cull differs from its plain version: {bad} keys, "
             f"alive {int(alive_k)} vs {int(alive_p)}")
    e, n = plan.owner.shape[0], plan.geo_r.shape[0]
    dec = dict(
        ms=cuda_time_ms(lambda: CR.decode_cull(plan), 50),
        plain_ms=cuda_time_ms(lambda: CR.decode_cull_plain(plan), 10),
        max_abs_err=0,
        shape={"slots": e, "splats": n, "alive": int(alive_k),
               "total": int(plan.total)})
    # Owner read + key write per slot; per-rank meta, total, alive once.
    dec["bound_ms"], dec["bound_by"] = bound(
        e * (4 + 8) + n * (16 + 24) + 8, e * 60)

    skeys, starts, ends = CR.sorted_stream(key_k, plan.t_total,
                                           plan.rank_bits)
    feat_r = CR.entry_features(splats, plan.order, True, True)
    cargs = (skeys, starts, ends, feat_r, plan.rank_bits, w, h)
    img_k = check_repeatable("composite_fwd", CR.composite_fwd, cargs)
    img_p, (visited, weighted) = CR.composite_fwd_plain(*cargs,
                                                        with_counts=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(img_k).all()):
        fail("composite_fwd produced non-finite values")
    err = (img_k - img_p).abs()
    lim = COMPOSITE_ATOL + COMPOSITE_RTOL * img_p.abs()
    if not bool((err <= lim).all()):
        fail(f"composite_fwd differs from its plain version: max abs err "
             f"{float(err.max())} (atol {COMPOSITE_ATOL}, rtol "
             f"{COMPOSITE_RTOL})")
    nv = feat_r.shape[1] - 6
    comp = dict(
        ms=cuda_time_ms(lambda: CR.composite_fwd(*cargs), 20),
        plain_ms=cuda_time_ms(lambda: CR.composite_fwd_plain(*cargs), 2,
                              warmup=1),
        max_abs_err=float(err.max()),
        tolerance={"atol": COMPOSITE_ATOL, "rtol": COMPOSITE_RTOL},
        repeat_bit_equal=True,
        shape={"tiles": plan.t_total, "entries": int(alive_k),
               "value_rows": nv, "visited_pairs": visited,
               "weighted_pairs": weighted},
        cull=fwd_cull(cargs))
    # Keys of the live segments, tile bounds, the feature table and the
    # image; 14 flops per visited (pixel, entry) pair, 4 + 2 (1 + nv) more
    # per weighted pair (transcendentals counted as one).
    comp["bound_ms"], comp["bound_by"] = bound(
        int(alive_k) * 8 + plan.t_total * 8 + feat_r.numel() * 4
        + (1 + nv) * w * h * 4,
        visited * 14 + weighted * (4 + 2 * (1 + nv)))
    return dec, comp


def main_path(model_dir: str, scene) -> dict:
    """Phase 5: render_sets over both splits through the user entry point,
    with the launch counters read around exactly that call."""
    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch.apps import render_sets
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config, render_fwd

    CR.reset_launches()
    t0 = time.perf_counter()
    render_sets.main(["-m", model_dir, "--device", DEVICE, "--quiet"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(CR.launches)
    for k in ("decode_cull", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serving path")

    w, h = scene.image_size
    bg = torch.zeros(3, device=DEVICE)
    views = []
    for split in ("train", "test"):
        n = len(getattr(scene.data, split))
        base = os.path.join(model_dir, split, f"ours_{ITERATION}")
        cams = [scene.cam_arrays(split, i) for i in range(n)]
        config = adapt_config(scene.gaussians, cams[0], w, h, cams=cams)
        for i in range(n):
            for sub in ("renders", "gt"):
                path = os.path.join(base, sub, f"{i:05d}.png")
                if not os.path.exists(path):
                    fail(f"missing {path}")
            png = np.asarray(Image.open(
                os.path.join(base, "renders", f"{i:05d}.png")))
            if png.shape != (h, w, 3) or png.std() < 1.0:
                fail(f"{split} view {i}: blank or misshapen render "
                     f"{png.shape}")
            out = render_fwd(scene.gaussians, *cams[i], w, h,
                             sh_degree=scene.sh_degree, bg=bg,
                             config=config)
            total, alive = int(out.entries_total), int(out.entries_alive)
            if not bool(torch.isfinite(out.color).all()):
                fail(f"{split} view {i}: non-finite colour")
            if total > config.entry_budget:
                fail(f"{split} view {i}: demand {total} over budget "
                     f"{config.entry_budget}")
            views.append((split, i, total, alive, config.entry_budget, png))
    expected = (len(scene.data.train), len(scene.data.test))
    if expected != (10, 2):
        fail(f"split is {expected}, expected (10, 2)")

    # One view against the plain compositor, at the PNGs' 8-bit precision.
    split, i, *_ = views[0]
    png = views[0][-1].astype(np.int32)
    plain = render_fwd_plain(scene, split, i, views[0][4])
    ref = (np.clip(plain, 0, 1).transpose(1, 2, 0) * 255).astype(np.int32)
    off = np.abs(png - ref) > 1
    if off.mean() > 1e-3:
        fail(f"main-path PNG differs from the plain render on "
             f"{off.mean():.2%} of pixel channels")

    # Steady-state FPS over the train views at their adapted budget.
    cams = [scene.cam_arrays("train", i) for i in range(len(scene.data.train))]
    config = adapt_config(scene.gaussians, cams[0], w, h, cams=cams)

    def one(i):
        return render_fwd(scene.gaussians, *cams[i % len(cams)], w, h,
                          sh_degree=scene.sh_degree, bg=bg, config=config)

    for i in range(3):
        one(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FPS_RENDERS):
        one(i)
    torch.cuda.synchronize()
    fps = FPS_RENDERS / (time.perf_counter() - t0)
    return dict(seconds=seconds, launches=launches, fps=fps,
                views=[v[:5] for v in views],
                plain_check_pixels_off=float(off.mean()))


def render_fwd_plain(scene, split: str, i: int, budget: int):
    """View `i`'s colour (background 0) through both kernels' plain
    versions instead of the kernels."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians

    st = scene.gaussians
    w, h = scene.image_size
    splats = project_gaussians(
        st.params.means, st.scales(), st.params.quats, st.opacity(),
        *scene.cam_arrays(split, i), w, h, sh=st.sh(),
        sh_degree=scene.sh_degree)
    plan = CR.alloc_prologue(splats, w, h, budget)
    key, _ = CR.decode_cull_plain(plan)
    skeys, starts, ends = CR.sorted_stream(key, plan.t_total, plan.rank_bits)
    feat_r = CR.entry_features(splats, plan.order, True, True)
    img = CR.composite_fwd_plain(skeys, starts, ends, feat_r, plan.rank_bits,
                                 w, h)
    return img[2:5].cpu().numpy()       # rows: weight sum, depth, rgb


def timed_once(fn):
    """(fn(), its time in ms) with CUDA events, for the plain versions,
    which are too slow to repeat at full width."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def check_repeatable(name: str, kernel, args):
    """kernel(*args) twice: the outputs (a tensor or a tuple of them) must
    be bit-identical (the kernel sums in a fixed order and uses no atomics
    on its output)."""
    import torch

    first = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    pairs = zip(first, again) if isinstance(first, tuple) else [(first,
                                                                 again)]
    for a, b in pairs:
        if not torch.equal(a, b):
            fail(f"{name}: two launches on the same inputs differ in "
                 f"{int((a != b).sum())} values")
    return first


def fwd_cull(cargs) -> dict:
    """The forward compositors' sub-tile cull on these inputs, counted by
    its plain mirror (cuda_raster.fwd_block_steps): (sub-tile, entry) pairs
    kept against tested, and the (pixel, entry) pairs the kernels' pixels
    walk among the kept entries."""
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    kept, tested, visited = CR.fwd_block_steps(*cargs)
    return {"subtile_pairs_kept": kept, "subtile_pairs_tested": tested,
            "kernel_visited_pairs": visited}


def check_segsum(rows, plan, where: str) -> dict:
    """segsum of the composite_bwd rows against its plain version (within
    SEGSUM_REL of each column's max, two launches bit-identical), timed
    beside torch.segment_reduce of the same rows. The result carries the
    plain output ("ref") and its column scale ("scale")."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    sargs = (rows, plan.seg_start, plan.seg_end)
    out_k = check_repeatable("segsum" + where, CR.segsum, sargs)
    out_p, seg_plain_ms = timed_once(lambda: CR.segsum_plain(*sargs))
    scale = out_p.abs().amax(dim=0).clamp(min=1e-30)
    seg_rel = float(((out_k - out_p).abs() / scale).max())
    if seg_rel > SEGSUM_REL:
        fail(f"segsum{where} differs from its plain version: {seg_rel} of "
             f"the column max (bound {SEGSUM_REL})")
    n, cols = out_k.shape
    used = int(plan.seg_end[-1])
    offsets = torch.cat([plan.seg_start, plan.seg_end[-1:]]).long()
    seg = dict(ms=cuda_time_ms(lambda: CR.segsum(*sargs), 50),
               plain_ms=seg_plain_ms,
               library_ms=cuda_time_ms(lambda: torch.segment_reduce(
                   rows[:used], "sum", offsets=offsets), 50),
               max_abs_err=float((out_k - out_p).abs().max()),
               max_rel_err_of_column_max=seg_rel, bound_rel=SEGSUM_REL,
               repeat_bit_equal=True,
               shape={"slots_summed": used, "ranks": n, "columns": cols},
               ref=out_p, scale=scale)
    # Reported, not gated: a time is no correctness check.
    seg["faster_than_library"] = seg["ms"] <= seg["library_ms"]
    seg["bound_ms"], seg["bound_by"] = bound(
        used * cols * 4 + n * 8 + n * cols * 4, used * cols)
    return seg


def view_stream(scene, cam, budget: int, colors=None):
    """The entry stream of one view of the scene's model at `budget`, with
    no gradient: (plan, alive, skeys, starts, ends, perm, feat) with the
    model's SH colours, or with `colors` (N, C) in their place."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians

    st = scene.gaussians
    w, h = scene.image_size
    kw = (dict(sh=st.sh(), sh_degree=scene.sh_degree) if colors is None
          else dict(colors=colors))
    with torch.no_grad():
        splats = project_gaussians(
            st.params.means, st.scales(), st.params.quats, st.opacity(),
            *cam, w, h, **kw)
        plan = CR.alloc_prologue(splats, w, h, budget)
        key, alive = CR.decode_cull(plan)
        skeys, starts, ends, perm = CR.sorted_stream(
            key, plan.t_total, plan.rank_bits, with_perm=True)
        feat = CR.entry_features(splats, plan.order, True, True)
    return plan, alive, skeys, starts, ends, perm, feat


def check_train_kernels(scene):
    """Phase 6: the training kernels against their plain versions on train
    view 0 of the stand-in model, under the L1 + SSIM loss."""
    import dataclasses

    import torch

    from wheat3dgs_tpu_torch.models.gaussians import GaussianParams
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.binning import pick_entry_budget
    from wheat3dgs_tpu_torch.ops.losses import photometric_loss
    from wheat3dgs_tpu_torch.render.pipeline import (RasterConfig,
                                                     entry_demand_probe,
                                                     render)

    st = scene.gaussians
    w, h = scene.image_size
    cam = scene.cam_arrays("train", 0)
    gt = scene.gt_image("train", 0)
    bg = torch.zeros(3, device=DEVICE)
    # The entry budget the trainer's ladder picks for this view.
    budget = pick_entry_budget(int(entry_demand_probe(
        st, *cam, width=w, height=h)))
    plan, alive, skeys, starts, ends, perm, feat = view_stream(scene, cam,
                                                               budget)
    nv = feat.shape[1] - 6
    cols = 6 + nv
    e = skeys.shape[0]
    entries = int(alive)

    # composite_train_fwd
    fargs = (skeys, starts, ends, feat, plan.rank_bits, w, h)
    img_k, stop_k = check_repeatable("composite_train_fwd",
                                     CR.composite_train_fwd, fargs)
    (img_p, stop_p), fwd_plain_ms = timed_once(
        lambda: CR.composite_train_fwd_plain(*fargs))
    if not bool(torch.isfinite(img_k).all()):
        fail("composite_train_fwd produced non-finite values")
    err = (img_k - img_p).abs()
    if not bool((err <= COMPOSITE_ATOL + COMPOSITE_RTOL * img_p.abs()).all()):
        fail(f"composite_train_fwd differs from its plain version: max abs "
             f"err {float(err.max())}")
    if not torch.equal(img_k, CR.composite_fwd(*fargs)):
        fail("composite_train_fwd's image differs from composite_fwd's")
    stop_off = int((stop_k != stop_p).sum())
    if stop_off > STOP_MISMATCH_MAX * w * h:
        fail(f"composite_train_fwd stop differs on {stop_off} pixels")
    _, (visited, weighted) = CR.composite_fwd_plain(*fargs, with_counts=True)
    fwd = dict(
        ms=cuda_time_ms(lambda: CR.composite_train_fwd(*fargs), 20),
        plain_ms=fwd_plain_ms, max_abs_err=float(err.max()),
        stop_pixels_differing=stop_off,
        tolerance={"atol": COMPOSITE_ATOL, "rtol": COMPOSITE_RTOL},
        repeat_bit_equal=True,
        shape={"tiles": plan.t_total, "entries": entries, "value_rows": nv,
               "visited_pairs": visited, "weighted_pairs": weighted},
        cull=fwd_cull(fargs))
    fwd["bound_ms"], fwd["bound_by"] = bound(
        entries * 8 + plan.t_total * 8 + feat.numel() * 4
        + ((1 + nv) * 4 + 4) * w * h,
        visited * 14 + weighted * (4 + 2 * (1 + nv)))

    # The image's cotangent under the training loss.
    img_v = img_k.detach().requires_grad_(True)
    color = img_v[2:5] + (1.0 - img_v[0])[None] * bg[:, None, None]
    grad = torch.autograd.grad(photometric_loss(color, gt),
                               img_v)[0].contiguous()

    # composite_bwd
    bargs = (skeys, perm, starts, ends, feat, img_k, stop_k, grad,
             plan.rank_bits, w, h)
    rows_k = check_repeatable("composite_bwd", CR.composite_bwd, bargs)
    rows_p, bwd_plain_ms = timed_once(lambda: CR.composite_bwd_plain(*bargs))
    if not bool(torch.isfinite(rows_k).all()):
        fail("composite_bwd produced non-finite values")
    col_max = rows_p.abs().amax(dim=0).clamp(min=1e-30)
    bwd_rel = float(((rows_k - rows_p).abs() / col_max).max())
    if bwd_rel > BWD_REL:
        fail(f"composite_bwd differs from its plain version: {bwd_rel} of "
             f"the column max (bound {BWD_REL})")
    # Pairs the replay walks: every pixel up to its stop.
    tiles_x = plan.tiles_x
    ty = torch.arange(h, device=DEVICE)[:, None] // CR.TILE_PX
    tx = torch.arange(w, device=DEVICE)[None, :] // CR.TILE_PX
    bwd_visited = int((stop_k.long() - starts[ty * tiles_x + tx]).sum())
    live_steps, walked_steps = CR.bwd_warp_steps(
        skeys, starts, ends, feat, stop_k, plan.rank_bits, w, h)
    bwd = dict(
        ms=cuda_time_ms(lambda: CR.composite_bwd(*bargs), 20),
        plain_ms=bwd_plain_ms,
        max_abs_err=float((rows_k - rows_p).abs().max()),
        max_rel_err_of_column_max=bwd_rel, bound_rel=BWD_REL,
        repeat_bit_equal=True,
        shape={"slots": e, "entries": entries, "columns": cols,
               "visited_pairs": bwd_visited, "weighted_pairs": weighted,
               "live_warp_steps": live_steps,
               "walked_warp_steps": walked_steps})
    # Keys + permutation of the live entries, the feature table, image,
    # cotangent and stop per pixel, the (E, cols) row write; the forward's
    # replay per visited pair, ~36 + 4 nv ops per weighted pair (u, the
    # prefix, dα and the 6 + nv columns and their reduction).
    bwd["bound_ms"], bwd["bound_by"] = bound(
        entries * 16 + plan.t_total * 8 + feat.numel() * 4
        + (2 * (1 + nv) * 4 + 4) * w * h + e * cols * 4,
        bwd_visited * 14 + weighted * (36 + 4 * nv))

    # segsum
    seg = check_segsum(rows_k, plan, "")
    lib_out = torch.segment_reduce(rows_k[:seg["shape"]["slots_summed"]],
                                   "sum", offsets=torch.cat([
                                       plan.seg_start,
                                       plan.seg_end[-1:]]).long())
    seg["library_rel_err"] = float(
        ((lib_out - seg.pop("ref")).abs() / seg.pop("scale")).max())

    # End-to-end parameter gradients: kernels against the all-plain path.
    def leaf_grads():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in st.params.as_dict().items()}
        view = dataclasses.replace(st, params=GaussianParams(**leaves))
        out = render(view, *cam, w, h, scene.sh_degree, bg=bg,
                     config=RasterConfig(entry_budget=budget))
        return torch.autograd.grad(photometric_loss(out.color, gt),
                                   list(leaves.values()))

    names = list(st.params.as_dict())
    got = leaf_grads()
    with CR.plain_kernels():
        ref = leaf_grads()
    grad_rel = {}
    for k, a, b in zip(names, got, ref):
        top = float(b.abs().max())
        grad_rel[k] = float((a - b).abs().max()) / top if top > 0 else 0.0
        if not bool(torch.isfinite(a).all()) or grad_rel[k] > GRAD_REL:
            fail(f"end-to-end gradient of {k}: {grad_rel[k]} of its max "
                 f"(bound {GRAD_REL})")
    return fwd, bwd, seg, {"budget": budget, "grad_rel_of_max": grad_rel}


def densify_decision(scene_dir: str) -> dict:
    """Phase 7b: the densification decision, kernels against plain. From
    the bench plot's points3D at 1/DECISION_RESOLUTION of its size, two
    Trainers take the same DECISION_STEPS steps on the same view picks
    (random.Random(0), as the CLI draws them) from copies of one state,
    iterations DECISION_FROM on, so the block ends at a densify past the
    opacity reset and the world-size prune is live: one replays the
    kernels from a CUDA graph (step_block, the CLI's path), one runs the
    plain versions eagerly. Per splat: the statistic grad_accum / denom
    and densify_and_prune's prune / clone / split decisions. The count of
    splats whose decision differs is held under DECISION_DIFF_MAX of the
    alive ones; the statistic's largest and mean signed relative error
    among splats within 2x of the threshold, each direction's hot-only
    count and the n_alive after the densify are printed (GRAD_REL,
    relative to a tensor's max, cannot see an error in the small per-splat
    norms that decide)."""
    import random

    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.training import Trainer
    from wheat3dgs_tpu_torch.training_graph import eager_steps

    scene = Scene(cfg.ModelParams(source_path=scene_dir,
                                  resolution=DECISION_RESOLUTION),
                  device=DEVICE)
    opt = cfg.OptimizationParams()
    w, h = scene.image_size
    gts = torch.as_tensor(scene.data.train.images, device=DEVICE)
    cams = scene.cam_stack("train")
    rnd = random.Random(0)
    picks = [rnd.randint(0, gts.shape[0] - 1) for _ in range(DECISION_STEPS)]
    it_last = DECISION_FROM + DECISION_STEPS - 1
    if it_last % opt.densification_interval or (
            it_last <= opt.opacity_reset_interval):
        fail(f"decision block ends at {it_last}, not at a densify past the "
             "opacity reset")
    dkw = dict(grad_threshold=opt.densify_grad_threshold, min_opacity=0.005,
               extent=scene.cameras_extent, max_screen_size=20.0,
               percent_dense=opt.percent_dense)

    def run(plain: bool) -> dict:
        tr = Trainer(G.map_tensors(torch.clone, scene.gaussians), opt,
                     scene.cameras_extent, sh_degree=3)
        tr.active_sh_degree = 3
        tr.maybe_densify = lambda it: None     # densify below, by hand
        with (CR.plain_kernels() if plain else contextlib.nullcontext()), (
                eager_steps() if plain else contextlib.nullcontext()):
            t0 = time.perf_counter()
            m = tr.step_block(DECISION_FROM, picks, cams, gts, w, h,
                              n_steps=DECISION_STEPS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        masks = G.densify_masks(tr.state, **dkw)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(0)
        _, info = G.densify_and_prune(tr.state, generator=gen, **dkw)
        return dict(masks=masks, alive=tr.state.alive,
                    n_alive_after=int(info["n_alive"]), seconds=seconds,
                    entry_budget=tr.config.entry_budget,
                    entries_total=int(m["entries_total"]),
                    loss=float(m["loss"]))

    k, p = run(False), run(True)
    mk, mp = k["masks"], p["masks"]
    alive = k["alive"]
    if not torch.equal(alive, p["alive"]):
        fail("decision phase: the two runs' alive masks differ")
    if not bool(torch.isfinite(mk["stat"]).all()):
        fail("decision phase: non-finite densification statistic")

    def decision(m):
        return (m["prune"].long() + 2 * m["clone"].long()
                + 3 * m["split"].long())

    n_alive = int(alive.sum())
    differ = int(((decision(mk) != decision(mp)) & alive).sum())
    thr = opt.densify_grad_threshold
    near = alive & (mp["stat"] >= thr / 2) & (mp["stat"] <= 2 * thr)
    rel = (mk["stat"] - mp["stat"])[near] / mp["stat"][near]
    out = dict(resolution=[w, h], steps=DECISION_STEPS,
               iterations=[DECISION_FROM, it_last], alive=n_alive,
               decisions_differ=differ,
               gate=int(DECISION_DIFF_MAX * n_alive),
               near_threshold=int(near.sum()),
               stat_max_rel_err_near=float(rel.abs().max()) if len(rel)
               else 0.0,
               stat_mean_signed_rel_err_near=float(rel.mean()) if len(rel)
               else 0.0,
               hot_kernel_only=int((mk["hot"] & ~mp["hot"]).sum()),
               hot_plain_only=int((mp["hot"] & ~mk["hot"]).sum()),
               counts={name: [int(mk[name].sum()), int(mp[name].sum())]
                       for name in ("prune_opacity", "prune", "hot",
                                    "clone", "split")},
               n_alive_after=[k["n_alive_after"], p["n_alive_after"]],
               entry_budget=[k["entry_budget"], p["entry_budget"]],
               entries_total=[k["entries_total"], p["entries_total"]],
               loss=[k["loss"], p["loss"]],
               seconds=[k["seconds"], p["seconds"]])
    if differ > DECISION_DIFF_MAX * n_alive:
        fail(f"decision phase: {differ} of {n_alive} splats decided "
             f"differently on the kernel path (gate {out['gate']}): {out}")
    return out


def train_path(scene_dir: str, out_dir: str):
    """Phase 7: apps/train_vanilla over the bench scene, with the launch
    counters read around exactly that call. Blocks of K > 1 steps run
    through Trainer.step_block (a step replayed from a CUDA graph)."""
    import math

    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch import training
    from wheat3dgs_tpu_torch.apps import render_sets, train_vanilla
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    # Record each step's and each block's demand (a block's maximum) and
    # budget (tensors; read after the run so the record adds no host sync).
    record = []
    step, step_block = training.Trainer.step, training.Trainer.step_block

    def recording_step(self, it, *args):
        m = step(self, it, *args)
        record.append((it, it, m["entries_total"], self.config.entry_budget,
                       m["loss"]))
        return m

    def recording_block(self, it0, *args, n_steps):
        m = step_block(self, it0, *args, n_steps=n_steps)
        record.append((it0, it0 + n_steps - 1, m["entries_total"],
                       self.config.entry_budget, m["loss"]))
        return m

    n_iter = TRAIN_ITERS
    interval, densify_from, densify_until = 40, 20, n_iter - 100
    argv = ["-s", scene_dir, "-m", out_dir, "--device", DEVICE, "--eval",
            "--iterations", str(n_iter),
            "--densify_from_iter", str(densify_from),
            "--densification_interval", str(interval),
            "--densify_until_iter", str(densify_until),
            "--opacity_reset_interval", "100000",
            "--test_iterations", "1", str(n_iter),
            "--save_iterations", str(n_iter), "--quiet"]
    training.Trainer.step = recording_step
    training.Trainer.step_block = recording_block
    try:
        CR.reset_launches()
        t0 = time.perf_counter()
        trainer, scene = train_vanilla.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
    finally:
        training.Trainer.step = step
        training.Trainer.step_block = step_block
    for k in ("decode_cull", "composite_train_fwd", "composite_bwd",
              "segsum", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the training path")
    # Every step runs each training kernel once, replayed or not.
    for k in ("composite_train_fwd", "composite_bwd", "segsum"):
        if launches[k] != n_iter:
            fail(f"{k}: {launches[k]} launches counted in {n_iter} steps")

    n_init = len(scene.data.point_cloud.points)
    logs = [json.loads(ln) for ln in open(os.path.join(out_dir,
                                                       "metrics.jsonl"))]
    steps = [r for r in logs if "loss" in r]
    tests = [r for r in logs if "test_psnr" in r]
    if not steps or not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"non-finite or missing logged loss: {steps}")
    losses = [float(x[4]) for x in record]
    if not all(math.isfinite(x) for x in losses):
        fail("a training step's loss is not finite")
    if not any(r["n_alive"] != n_init for r in steps):
        fail(f"no densify event changed n_alive from {n_init}")
    if sum(b - a + 1 for a, b, *_ in record) != n_iter:
        fail("the recorded steps and blocks do not cover the run")
    # The watchdog checks after every block and every k-th step: the
    # telemetry queued at one check is read at the next, and the record
    # after that probes. So every check whose demand exceeded its budget
    # must see the budget raised by then, unless the run ended first.
    k = trainer.overflow_check_every
    demand = [(a, b, int(t), bud) for a, b, t, bud, _ in record]
    checks = [i for i, (a, b, _, _) in enumerate(demand)
              if b > a or b % k == 0]
    over = [i for i in checks if demand[i][2] > demand[i][3]]
    for i in over:
        after = [c for c in checks if c > i]
        if not after or after[0] + 1 >= len(demand):
            continue
        if max(d[3] for d in demand[i + 1:after[0] + 2]) <= demand[i][3]:
            a, b, t, bud = demand[i]
            fail(f"iterations {a}-{b}: demand {t} over budget {bud} and "
                 "the watchdog did not raise it")
    # The graph: replayed, and captured anew only after an event that
    # replaces what it baked in (densify, a budget change), plus once.
    g = trainer.graph
    blocks = [b - a + 1 for a, b, *_ in record if b > a]
    densify_events = len([it for it in range(densify_from + 1,
                                             densify_until)
                          if it % interval == 0])
    budget_changes = sum(demand[i][3] != demand[i - 1][3]
                         for i in range(1, len(demand)))
    if g.replays != sum(blocks) - g.captures:
        fail(f"{g.replays} replays for {len(blocks)} blocks of "
             f"{sum(blocks)} steps and {g.captures} captures")
    if g.replays <= 0 or g.captures > densify_events + budget_changes + 1:
        fail(f"graph: {g.captures} captures, {g.replays} replays "
             f"({densify_events} densify events, {budget_changes} budget "
             "changes)")
    if [r["iter"] for r in tests] != [1, n_iter]:
        fail(f"test evaluations at {[r['iter'] for r in tests]}")
    rise = tests[-1]["test_psnr"] - tests[0]["test_psnr"]
    if not rise > PSNR_RISE_DB:
        fail(f"test PSNR rose {rise:.3f} dB (< {PSNR_RISE_DB})")
    ply = os.path.join(out_dir, "point_cloud", f"iteration_{n_iter}",
                       "point_cloud.ply")
    if not os.path.exists(ply):
        fail(f"missing {ply}")
    render_sets.main(["-m", out_dir, "--device", DEVICE, "--quiet",
                      "--skip_train"])
    for i in range(len(scene.data.test)):
        png = np.asarray(Image.open(os.path.join(
            out_dir, "test", f"ours_{n_iter}", "renders", f"{i:05d}.png")))
        if png.shape != (BENCH["height"], BENCH["width"], 3) or \
                png.std() < 1.0:
            fail(f"trained model: blank or misshapen test render {i}")
    return trainer, scene, dict(
        seconds=seconds, launches=launches, iterations=n_iter,
        initial_points=n_init, capacity=trainer.state.capacity,
        n_alive=int(trainer.state.num_alive), logged=steps,
        test_psnr=[r["test_psnr"] for r in tests], psnr_rise_db=rise,
        blocks=blocks, single_steps=len(record) - len(blocks),
        captures=g.captures, replays=g.replays,
        capture_seconds=g.capture_seconds, densify_events=densify_events,
        budget_changes=budget_changes,
        overflow_checks_over=len(over),
        overflow_events=trainer.overflow_events,
        entry_budget=trainer.config.entry_budget,
        max_demand=max(t for _, _, t, _ in demand))


def train_rate(trainer, scene) -> dict:
    """Phase 8: Trainer.step and Trainer.step_block at the trained state,
    SH degree 3, in turns (step, block, block, step) of TRAIN_BLOCK
    iterations each, on the host clock; a warm-up turn of each first (the
    block's capture happens there)."""
    import random

    import torch

    w, h = scene.image_size
    n_train = len(scene.data.train)
    gts = torch.as_tensor(scene.data.train.images, device=DEVICE)
    cams = [scene.cam_arrays("train", i) for i in range(n_train)]
    stacks = scene.cam_stack("train")
    trainer.active_sh_degree = trainer.max_sh_degree
    rnd = random.Random(1)
    # Iterations 10_001.. in windows [40 m + 1, 40 m + 39]: no SH ramp,
    # and no multiple of the densify interval (40), so no probe inside.
    windows = iter(range(10_001, 10 ** 9, 40))

    def turn(mode):
        first = next(windows)
        vis = [rnd.randint(0, n_train - 1) for _ in range(TRAIN_BLOCK)]
        if mode == "block":
            m = trainer.step_block(first, vis, stacks, gts, w, h,
                                   n_steps=TRAIN_BLOCK)
        else:
            for i, v in enumerate(vis):
                m = trainer.step(first + i, cams[v], gts[v], w, h)
        torch.cuda.synchronize()
        return m

    turn("step")
    turn("block")
    turns = []
    for mode in ("step", "block", "block", "step"):
        captures = trainer.graph.captures
        t0 = time.perf_counter()
        m = turn(mode)
        seconds = time.perf_counter() - t0
        turns.append(dict(mode=mode, it_per_s=TRAIN_BLOCK / seconds,
                          ms_per_step=seconds / TRAIN_BLOCK * 1e3,
                          captures=trainer.graph.captures - captures,
                          loss=float(m["loss"])))

    def mean(mode):
        return sum(t["it_per_s"] for t in turns if t["mode"] == mode) / 2

    return dict(step_it_per_s=mean("step"), block_it_per_s=mean("block"),
                turns=turns, steps_per_turn=TRAIN_BLOCK,
                captures=trainer.graph.captures,
                capture_seconds=trainer.graph.capture_seconds,
                n_alive=int(trainer.state.num_alive),
                entry_budget=trainer.config.entry_budget)


def block_against_eager(trainer, scene) -> dict:
    """Phase 8b: one block of BLOCK_CHECK steps replayed from a fresh
    capture against the same steps run eagerly (twice, for the spread of
    eager runs), from copies of the trained state at its budget: every
    state tensor and the metrics."""
    import dataclasses

    import torch

    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.training import LAST_METRICS, Trainer

    w, h = scene.image_size
    n_train = len(scene.data.train)
    gts = torch.as_tensor(scene.data.train.images, device=DEVICE)
    stacks = scene.cam_stack("train")
    vis = [(3 * i + 1) % n_train for i in range(BLOCK_CHECK)]
    it0 = 20_001

    def copy():
        st = G.state_from_numpy(**G.state_to_numpy(trainer.state)._asdict(),
                                device=DEVICE)
        tr = Trainer(st, trainer.opt, trainer.extent, trainer.max_sh_degree,
                     config=trainer.config, adaptive_occupancy=False)
        tr.active_sh_degree = trainer.active_sh_degree
        return tr

    graphed = copy()
    mg = graphed.step_block(it0, vis, stacks, gts, w, h,
                            n_steps=BLOCK_CHECK)
    runs = []
    for _ in range(2):
        tr = copy()
        for i, v in enumerate(vis):
            m = tr.step(it0 + i, scene.cam_arrays("train", v), gts[v], w, h)
        runs.append((tr, m))
    torch.cuda.synchronize()

    def diff(a, ma, b, mb):
        """Max |a - b| over every state tensor and metric, by name."""
        out = {}
        for f in G.PARAM_FIELDS:
            out[f] = getattr(a.state.params, f) - getattr(b.state.params, f)
            out["mu." + f] = a.state.adam.mu[f] - b.state.adam.mu[f]
            out["nu." + f] = a.state.adam.nu[f] - b.state.adam.nu[f]
        for f in G.STAT_FIELDS:
            out[f] = getattr(a.state, f) - getattr(b.state, f)
        for k in LAST_METRICS:
            out[k] = (ma[k] - mb[k]).double()
        return {k: float(v.abs().max()) for k, v in out.items()}

    (e1, m1), (e2, m2) = runs
    graph_eager = diff(graphed, mg, e1, m1)
    eager_eager = diff(e1, m1, e2, m2)
    bad = [k for k in graph_eager if graph_eager[k] > eager_eager[k]]
    if bad:
        fail(f"replayed block against eager steps beyond the eager spread: "
             f"{ {k: (graph_eager[k], eager_eager[k]) for k in bad} }")
    if not torch.equal(graphed.state.alive, e1.state.alive):
        fail("replayed block: alive mask differs from eager steps")
    return dict(steps=BLOCK_CHECK, views=vis, first_iteration=it0,
                bit_identical=not any(graph_eager.values()),
                eager_runs_bit_identical=not any(eager_eager.values()),
                max_abs_graph_vs_eager=max(graph_eager.values()),
                max_abs_eager_vs_eager=max(eager_eager.values()),
                captures=graphed.graph.captures,
                replays=graphed.graph.replays,
                capture_seconds=graphed.graph.capture_seconds)


def check_seg_kernels(scene, scene_dir: str):
    """Phase 9: the segmentation shapes of the compositor kernels on train
    view 0 of the stand-in model."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.render.pipeline import (adapt_config,
                                                     subset_stream)
    from wheat3dgs_tpu_torch.seg import flashsplat
    from wheat3dgs_tpu_torch.utils import image_ops

    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    cam = cams[0]
    config = adapt_config(st, cam, w, h, cams=cams)   # run_3d_seg_app's
    budget = config.entry_budget
    # The lift's first batch of view 0: its first masks, the all-ones row,
    # zero rows to 8 (as SegContext._lift_camera builds it).
    paths = scene.data.train.metas[0].mask_paths or []
    rows = [image_ops.read_mask(p, (w, h)) for p in paths[:7]]
    rows.append(np.ones((h, w), bool))
    rows += [np.zeros((h, w), bool)] * (8 - len(rows))
    planes = torch.as_tensor(np.stack(rows), dtype=torch.float32,
                             device=DEVICE)
    bits8 = torch.as_tensor(np.stack([np.packbits(r, axis=None)
                                      for r in rows]), device=DEVICE)

    plan, alive, skeys, starts, ends, perm, feat = view_stream(
        scene, cam, budget, torch.zeros((st.capacity, 8), device=DEVICE))
    nv = feat.shape[1] - 6
    if nv != 9:
        fail(f"the lift composites {nv} value rows, expected 9")
    cols, e, entries = 6 + nv, skeys.shape[0], int(alive)

    fargs = (skeys, starts, ends, feat, plan.rank_bits, w, h)
    img_k, stop_k = check_repeatable("composite_train_fwd at nv=9",
                                     CR.composite_train_fwd, fargs)
    (img_p, stop_p), fwd_plain_ms = timed_once(
        lambda: CR.composite_train_fwd_plain(*fargs))
    err = (img_k - img_p).abs()
    if not bool(torch.isfinite(img_k).all()) or not bool(
            (err <= COMPOSITE_ATOL + COMPOSITE_RTOL * img_p.abs()).all()):
        fail(f"composite_train_fwd at nv=9 differs from its plain version: "
             f"max abs err {float(err.max())}")
    if not torch.equal(img_k, CR.composite_fwd(*fargs)):
        fail("composite_train_fwd's image at nv=9 differs from "
             "composite_fwd's")
    stop_off = int((stop_k != stop_p).sum())
    if stop_off > STOP_MISMATCH_MAX * w * h:
        fail(f"composite_train_fwd at nv=9: stop differs on {stop_off} "
             "pixels")
    _, (visited, weighted) = CR.composite_fwd_plain(*fargs, with_counts=True)
    count = check_count(fargs, img_k, stop_k, stop_p)
    fwd = dict(value_rows=nv, ms=cuda_time_ms(
        lambda: CR.composite_train_fwd(*fargs), 20), plain_ms=fwd_plain_ms,
        max_abs_err=float(err.max()), stop_pixels_differing=stop_off,
        repeat_bit_equal=True,
        shape={"slots": e, "entries": entries, "value_rows": nv,
               "visited_pairs": visited, "weighted_pairs": weighted},
        cull=fwd_cull(fargs))
    fwd["bound_ms"], fwd["bound_by"] = bound(
        entries * 8 + plan.t_total * 8 + feat.numel() * 4
        + ((1 + nv) * 4 + 4) * w * h,
        visited * 14 + weighted * (4 + 2 * (1 + nv)))
    count["bound_ms"], count["bound_by"] = bound(
        entries * 8 + plan.t_total * 8 + feat.numel() * 4
        + ((1 + nv) * 4 + 8) * w * h,
        visited * 14 + weighted * (5 + 2 * (1 + nv)))
    fwd["count"] = count

    # The label planes are the cotangent of the 8 colour rows.
    grad = torch.zeros_like(img_k)
    grad[2:] = planes
    bargs = (skeys, perm, starts, ends, feat, img_k, stop_k, grad,
             plan.rank_bits, w, h)
    rows_k = check_repeatable("composite_bwd at nv=9", CR.composite_bwd,
                              bargs)
    rows_p, bwd_plain_ms = timed_once(lambda: CR.composite_bwd_plain(*bargs))
    col_max = rows_p.abs().amax(dim=0).clamp(min=1e-30)
    bwd_rel = float(((rows_k - rows_p).abs() / col_max).max())
    if not bool(torch.isfinite(rows_k).all()) or bwd_rel > BWD_REL:
        fail(f"composite_bwd at nv=9 differs from its plain version: "
             f"{bwd_rel} of the column max (bound {BWD_REL})")
    tiles_x = plan.tiles_x
    ty = torch.arange(h, device=DEVICE)[:, None] // CR.TILE_PX
    tx = torch.arange(w, device=DEVICE)[None, :] // CR.TILE_PX
    bwd_visited = int((stop_k.long() - starts[ty * tiles_x + tx]).sum())
    live_steps, walked_steps = CR.bwd_warp_steps(
        skeys, starts, ends, feat, stop_k, plan.rank_bits, w, h)
    bwd = dict(value_rows=nv, ms=cuda_time_ms(
        lambda: CR.composite_bwd(*bargs), 20), plain_ms=bwd_plain_ms,
        max_abs_err=float((rows_k - rows_p).abs().max()),
        max_rel_err_of_column_max=bwd_rel, repeat_bit_equal=True,
        shape={"slots": e, "entries": entries, "columns": cols,
               "visited_pairs": bwd_visited, "weighted_pairs": weighted,
               "live_warp_steps": live_steps,
               "walked_warp_steps": walked_steps})
    bwd["bound_ms"], bwd["bound_by"] = bound(
        entries * 16 + plan.t_total * 8 + feat.numel() * 4
        + (2 * (1 + nv) * 4 + 4) * w * h + e * cols * 4,
        bwd_visited * 14 + weighted * (36 + 4 * nv))

    seg = check_segsum(rows_k, plan, " at 15 columns")
    del seg["ref"], seg["scale"]
    seg["value_rows"] = nv

    # The lifted counts: kernels against the all-plain path.
    lift_args = (st, *cam, bits8)
    lift_kw = dict(width=w, height=h, config=config)
    got = flashsplat.lift_batch8(*lift_args, **lift_kw)
    with CR.plain_kernels():
        ref = flashsplat.lift_batch8(*lift_args, **lift_kw)
    row_max = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    lift_rel = float(((got - ref).abs() / row_max).max())
    if not bool(torch.isfinite(got).all()) or lift_rel > LIFT_REL:
        fail(f"lift_batch8 counts differ from the all-plain path: "
             f"{lift_rel} of the row max (bound {LIFT_REL})")
    lift = dict(ms=cuda_time_ms(
        lambda: flashsplat.lift_batch8(*lift_args, **lift_kw), 5),
        max_rel_err_of_row_max=lift_rel, masks=len(paths),
        entry_budget=budget)
    # lift_view (ops/mask_lift.lift_mask) on the same masks as one label
    # image: used_count as lift_batch8's, contrib_num from the counting
    # build, both against the all-plain path.
    labels = torch.zeros((h, w), dtype=torch.int64, device=DEVICE)
    for i, r in enumerate(rows[:min(7, len(paths))]):
        labels[torch.as_tensor(r, device=DEVICE)] = i + 1
    view_args = (st, *cam, labels)
    view_kw = dict(num_obj=7, width=w, height=h, config=config)
    out = flashsplat.lift_view(*view_args, **view_kw)
    with CR.plain_kernels():
        ref = flashsplat.lift_view(*view_args, **view_kw)
    row_max = ref.used_count.abs().amax(dim=1, keepdim=True).clamp(
        min=1e-30)
    view_rel = float(((out.used_count - ref.used_count).abs()
                      / row_max).max())
    view_off = int((out.contrib_num != ref.contrib_num).sum())
    if (view_rel > LIFT_REL or view_off > STOP_MISMATCH_MAX * w * h
            or int(out.contrib_num.max()) <= 1):
        fail(f"lift_view differs from the all-plain path: used_count "
             f"{view_rel} of the row max, contrib_num on {view_off} pixels")
    lift["lift_view"] = dict(max_rel_err_of_row_max=view_rel,
                             contrib_pixels_differing=view_off,
                             contrib_max=int(out.contrib_num.max()))

    # composite_fwd at the subset renders' shapes: alpha-only at the subset
    # budget (match / predbits), with depth at the scene's (eval).
    gt = np.load(os.path.join(scene_dir, "gt_points.npz"))["head_id"]
    head = torch.zeros((st.capacity,), dtype=torch.bool, device=DEVICE)
    head[:len(gt)] = torch.as_tensor(gt == 1, device=DEVICE)
    seg_budget = max(2048, (budget // 8 + 127) // 128 * 128)
    comp = []
    for with_depth, b in ((False, seg_budget), (True, budget)):
        cargs, splan, s_entries, b = subset_stream(st, cam, head, w, h, b,
                                                   with_depth)
        img_k = check_repeatable(f"composite_fwd at nv={int(with_depth)}",
                                 CR.composite_fwd, cargs)
        img_p, (vis, wtd) = CR.composite_fwd_plain(*cargs, with_counts=True)
        err = (img_k - img_p).abs()
        if not bool((err <= COMPOSITE_ATOL + COMPOSITE_RTOL *
                     img_p.abs()).all()) or float(img_k[0].max()) <= 0.5:
            fail(f"composite_fwd at nv={int(with_depth)} differs from its "
                 f"plain version ({float(err.max())}) or renders nothing")
        lens = cargs[2] - cargs[1]
        r = dict(value_rows=int(with_depth),
                 ms=cuda_time_ms(lambda: CR.composite_fwd(*cargs), 50),
                 plain_ms=timed_once(
                     lambda: CR.composite_fwd_plain(*cargs))[1],
                 max_abs_err=float(err.max()), repeat_bit_equal=True,
                 shape={"slots": b, "demand": int(splan.total),
                        "entries": s_entries, "value_rows": int(with_depth),
                        "tiles_with_entries": int((lens > 0).sum()),
                        "longest_segment": int(lens.max()),
                        "visited_pairs": vis, "weighted_pairs": wtd},
                 cull=fwd_cull(cargs))
        r["bound_ms"], r["bound_by"] = fwd_bound(
            s_entries, splan.t_total, cargs[3].numel(), int(with_depth), w,
            h, vis, wtd)
        comp.append(r)
    # The all-empty frame (every tile's segment empty, 0 rows): the cost of
    # covering the grid and storing zeros; its image must be all zero.
    empty = torch.zeros_like(cargs[1])
    eargs = (cargs[0], empty, empty, cargs[3][:, :6].contiguous(),
             *cargs[4:])
    img_k = check_repeatable("composite_fwd on an empty frame",
                             CR.composite_fwd, eargs)
    if img_k.shape != (1, h, w) or bool(img_k.any()):
        fail("composite_fwd on an empty frame: not an all-zero image")
    r = dict(value_rows=0, ms=cuda_time_ms(lambda: CR.composite_fwd(*eargs),
                                           50),
             plain_ms=timed_once(lambda: CR.composite_fwd_plain(*eargs))[1],
             max_abs_err=0.0, repeat_bit_equal=True,
             shape={"entries": 0, "value_rows": 0, "visited_pairs": 0,
                    "weighted_pairs": 0})
    # The function only writes the zero image.
    r["bound_ms"], r["bound_by"] = bound(w * h * 4, 0)
    comp.append(r)
    return fwd, bwd, seg, comp, lift


def check_count(fargs, img_k, stop_k, stop_p) -> dict:
    """Phase 9: composite_train_fwd's counting build (the lift's
    contrib_num) at 9 rows against the plain walk's per-pixel count: equal
    but on at most STOP_MISMATCH_MAX of the pixels (where an alpha at
    exactly 1/255 or the transmittance floor rounds the other way, as for
    the stop); its image and stop equal to the build's without the count;
    two launches bit-identical; timed in turns with the build without."""
    import torch

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    w, h = fargs[-2:]
    img_c, stop_c, count_k = check_repeatable(
        "composite_train_fwd with its count at nv=9",
        lambda *a: CR.composite_train_fwd(*a, with_contrib=True), fargs)
    (_, _, count_p), plain_ms = timed_once(
        lambda: CR.composite_train_fwd_plain(*fargs, with_contrib=True))
    if not (torch.equal(img_c, img_k) and torch.equal(stop_c, stop_k)):
        fail("composite_train_fwd's counting build: its image or stop "
             "differs from the build's without the count")
    diff = (count_k - count_p).abs()
    off = int((diff > 0).sum())
    if off > STOP_MISMATCH_MAX * w * h or int(count_k.max()) <= 1:
        fail(f"composite_train_fwd's count differs from its plain version "
             f"on {off} pixels (max {int(diff.max())})")
    # In turns: without the count, with it, with it, without it.
    turns = [cuda_time_ms(lambda: CR.composite_train_fwd(
        *fargs, with_contrib=c), 20) for c in (False, True, True, False)]
    return dict(value_rows=9, ms=(turns[1] + turns[2]) / 2,
                ms_without_count=(turns[0] + turns[3]) / 2, turns_ms=turns,
                plain_ms=plain_ms, max_abs_err=float(diff.max()),
                pixels_differing=off, stop_pixels_differing=int(
                    (stop_k != stop_p).sum()),
                off_where_stop_differs=int(((diff > 0) & (
                    stop_k != stop_p)).sum()),
                count_sum=int(count_k.sum()),
                plain_count_sum=int(count_p.sum()), repeat_bit_equal=True)


def seg_path(scene_dir: str, model_dir: str) -> dict:
    """Phase 10: apps/run_3d_seg_app over the bench scene and the stand-in
    model, with the launch counters read around exactly that call."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.apps import run_3d_seg_app
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.seg import flashsplat
    from wheat3dgs_tpu_torch.seg.pipeline import SegContext, load_pt

    # Host-clock seconds and calls of each device step (each returns host
    # arrays, so the device work is inside), the subset renders' demand
    # against their budget, and the run's SegContext.
    calls = {k: [0, 0.0] for k in ("lift", "match", "predbits")}
    renders, ctxs = [], []
    saved = {"lift": SegContext._lift_camera,
             "match": SegContext.match_device,
             "predbits": SegContext.predbits_device}
    raw = {k: getattr(flashsplat, k) for k in ("match_views_packed",
                                               "predbits_views")}

    def timed(kind):
        def wrapper(self, *a, **k):
            if not ctxs:
                ctxs.append(self)
            t0 = time.perf_counter()
            out = saved[kind](self, *a, **k)
            calls[kind][0] += 1
            calls[kind][1] += time.perf_counter() - t0
            return out
        return wrapper

    def recorded(name):
        def wrapper(*a, **k):
            out = raw[name](*a, **k)
            renders.append((name, int(out[-1]), k["config"].entry_budget))
            return out
        return wrapper

    try:
        SegContext._lift_camera = timed("lift")
        SegContext.match_device = timed("match")
        SegContext.predbits_device = timed("predbits")
        for name in raw:
            setattr(flashsplat, name, recorded(name))
        CR.reset_launches()
        t0 = time.perf_counter()
        summary = run_3d_seg_app.main(["-s", scene_dir, "-m", model_dir,
                                       "--exp_name", "smoke", "--device",
                                       DEVICE, "--quiet"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
    finally:
        SegContext._lift_camera = saved["lift"]
        SegContext.match_device = saved["match"]
        SegContext.predbits_device = saved["predbits"]
        for name, fn in raw.items():
            setattr(flashsplat, name, fn)
    for k in ("decode_cull", "composite_fwd", "composite_train_fwd",
              "composite_bwd", "segsum"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the segmentation path")

    base = summary["out_dir"]
    num_heads = summary["num_heads"]
    rows = open(os.path.join(base, "results.csv")).read().splitlines()
    plys = [f for f in os.listdir(os.path.join(base, "ply"))
            if f.startswith("wh_")]
    maps = sorted(os.listdir(os.path.join(base, "2DSeg")))
    if len(rows) < 2 or not plys or len(maps) != 12:
        fail(f"segmentation artifacts: {len(rows)} csv lines, {len(plys)} "
             f"head plys, {len(maps)} 2DSeg maps (expected 12)")
    ids = set()
    for f in maps:
        ids |= set(np.unique(load_pt(os.path.join(base, "2DSeg", f))))
    if len(ids - {0}) != num_heads:
        fail(f"2DSeg maps hold {len(ids - {0})} head ids, run found "
             f"{num_heads}")
    # A subset render over its budget must be rerun at a budget that holds
    # its demand: the next render of the same step.
    for i, (name, demand, budget) in enumerate(renders):
        if demand > budget and not (
                i + 1 < len(renders) and renders[i + 1][0] == name
                and renders[i + 1][2] >= demand):
            fail(f"{name}: demand {demand} over budget {budget} without a "
                 "rerun")

    # The heads against the generator's ground truth (splat i of the
    # stand-in is gt point i).
    gt = np.load(os.path.join(scene_dir, "gt_points.npz"))["head_id"]
    inst = summary["state"].instance_id.cpu().numpy()[:len(gt)]
    purity, majority = [], set()
    for hid in np.unique(inst[inst > 0]):
        vals, counts = np.unique(gt[inst == hid], return_counts=True)
        purity.append(float(counts.max() / counts.sum()))
        majority.add(int(vals[np.argmax(counts)]))
    median_purity = float(np.median(purity)) if purity else 0.0
    covered = len(majority - {0})
    if not (SEG_HEADS[0] <= num_heads <= SEG_HEADS[1]) or \
            median_purity < SEG_MEDIAN_PURITY:
        fail(f"segmentation found {num_heads} heads (gate {SEG_HEADS}), "
             f"median purity {median_purity} (gate {SEG_MEDIAN_PURITY})")

    # Device busy share over association steps of the run's context.
    ctx = ctxs[0]
    counts = ctx.cached_counts(0, ctx.mask_paths[0][0])
    ctx.match_device(counts)
    reps = 5
    busy = device_busy(lambda: [ctx.match_device(counts)
                                for _ in range(reps)])
    return dict(
        seconds=seconds, launches=launches, num_heads=num_heads,
        heads_with_letter_saves=len(plys), results_rows=len(rows) - 1,
        calls={k: {"calls": c, "seconds": t,
                   "ms_per_call": t / c * 1e3 if c else None}
               for k, (c, t) in calls.items()},
        subset_renders=len(renders),
        subset_overflows=sum(d > b for _, d, b in renders),
        seg_budget=ctx.seg_budget, entry_budget=ctx.config.entry_budget,
        max_subset_demand=max((d for _, d, _ in renders), default=0),
        masks=int(sum(len(p) for p in ctx.mask_paths)),
        purity=purity, median_purity=median_purity,
        gt_heads_covered=covered,
        match_step={"ms_host": busy["ms_host"] / reps,
                    "device_busy_share": busy["device_busy_share"],
                    "top_device_us": {k: v / reps for k, v in
                                      busy["top_device_us"].items()}})


def eval_path(model_dir: str) -> dict:
    """Phase 11: apps/eval_wheatgs_app over the same model, with the launch
    counters read around exactly that call."""
    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch.apps import eval_wheatgs_app
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    CR.reset_launches()
    t0 = time.perf_counter()
    labels = eval_wheatgs_app.main(["-m", model_dir, "--exp_name", "smoke",
                                    "--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(CR.launches)
    for k in ("decode_cull", "composite_fwd", "composite_train_fwd",
              "composite_bwd", "segsum"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the evaluation path")
    if not os.path.exists(os.path.join(model_dir, "wheat-head", "smoke",
                                       "all_counts.pt")):
        fail("all_counts.pt was not written")
    nonzero = {}
    for sub in ("segmentation", "overlay"):
        d = os.path.join(model_dir, "test", sub)
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        if len(files) != 2:
            fail(f"test/{sub}: {len(files)} PNGs, expected 2")
        for f in files:
            png = np.asarray(Image.open(os.path.join(d, f)))
            if png.shape[:2] != (BENCH["height"], BENCH["width"]) or \
                    not png.any():
                fail(f"test/{sub}/{f}: empty or misshapen {png.shape}")
            nonzero[f"{sub}/{f}"] = float((png > 0).mean())
    return dict(seconds=seconds, launches=launches,
                labelled_gaussians=int(labels[1:].any(axis=0).sum()),
                label_rows=int(labels.shape[0]), nonzero_share=nonzero)


def device_busy(fn) -> dict:
    """Host ms of fn() (which must end with the device idle, e.g. by
    reading a result) and the share of it the device spent in kernels,
    from torch.profiler, with its kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"ms_host": wall_us / 1e3, "device_busy_share": device_us / wall_us,
            "top_device_us": {e.key: e.self_device_time_total for e in top}}


def frame_parts(state, cam, width, height, config, labels=None,
                nonempty=None, **render_kw):
    """One frame's two renders as the 360 app and the viewer make them:
    the (3, H, W) colour image clipped to [0, 1] and, given the head
    labels, the (H, W) head-id map of eval_obj_labels, as numpy."""
    import numpy as np

    from wheat3dgs_tpu_torch.render.pipeline import render_fwd
    from wheat3dgs_tpu_torch.seg.eval import eval_obj_labels

    out = render_fwd(state, *cam, width, height, config=config, **render_kw)
    ids = None
    if labels is not None:
        ids = eval_obj_labels(state, labels, *cam, width=width,
                              height=height, config=config,
                              nonempty=nonempty).cpu().numpy()
    return np.clip(out.color.cpu().numpy(), 0, 1), ids


def check_frame(where: str, parts, got) -> dict:
    """parts() (frame_parts of one frame) with the kernels and through the
    plain compositors: the colour images within COMPOSITE_ATOL /
    COMPOSITE_RTOL and the head-id maps apart on at most OVERLAY_OFF_MAX
    of the pixels. `got`, the app's frame from the kernel path, is held to
    the plain path's frame on every pixel whose head agrees: a (H, W, 3)
    uint8 frame with no channel more than 1 level apart, a (3, H, W)
    float image within the colour tolerance."""
    import numpy as np

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.utils import image_ops

    colour, ids = parts()
    with CR.plain_kernels():
        ref, ref_ids = parts()
    err = np.abs(colour - ref)
    if not (err <= COMPOSITE_ATOL + COMPOSITE_RTOL * np.abs(ref)).all():
        fail(f"{where}: colour image differs from the plain compositors by "
             f"{float(err.max())} (atol {COMPOSITE_ATOL}, rtol "
             f"{COMPOSITE_RTOL})")
    agree = np.ones(ref.shape[1:], bool)
    if ref_ids is not None:
        agree = ids == ref_ids
        ref = image_ops.overlay_image(
            ref, image_ops.visualize_obj(ref_ids).astype(np.float32) / 255.0)
    overlay_off = 1.0 - float(agree.mean())
    if overlay_off > OVERLAY_OFF_MAX:
        fail(f"{where}: the overlaid head differs from the plain "
             f"compositors' on {overlay_off:.2%} of the pixels (bound "
             f"{OVERLAY_OFF_MAX:.2%})")
    if got.dtype == np.uint8:
        ref = (ref.transpose(1, 2, 0) * 255).astype(np.uint8)
        agree = agree[..., None]
    if got.shape != ref.shape:
        fail(f"{where}: frame {got.shape}, plain compositors' {ref.shape}")
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        bad = int(((diff > 1) & agree).sum())
    else:
        diff = np.abs(got - ref)
        bad = int(((diff > COMPOSITE_ATOL + COMPOSITE_RTOL * np.abs(ref))
                   & agree).sum())
    if bad:
        fail(f"{where}: {bad} channels of the frame differ from the plain "
             "compositors' where their heads agree")
    return dict(colour_max_abs_err=float(err.max()),
                overlay_pixels_off=overlay_off, channels_off=bad)


def metrics_path(model_dir: str) -> dict:
    """Phase 12: apps/metrics_app on the trained model's test renders,
    twice per LPIPS net (the second run timed), with the launch counters
    read around all the runs; each net's results.json / per_view.json held
    to the schema and to the port's CPU values on the same PNGs."""
    import torch

    from wheat3dgs_tpu_torch.apps import metrics_app
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops import lpips
    from wheat3dgs_tpu_torch.ops.losses import psnr, ssim

    method = f"ours_{TRAIN_ITERS}"
    renders = os.path.join(model_dir, "test", method, "renders")
    names = sorted(os.listdir(renders))

    def read():
        out = []
        for f in ("results.json", "per_view.json"):
            with open(os.path.join(model_dir, f)) as fh:
                out.append(json.load(fh))
        return out

    CR.reset_launches()
    nets, cpu_seconds = {}, {}
    for net in LPIPS_NETS:
        argv = ["-m", model_dir, "--lpips_weights", f"auto:{net}",
                "--device", DEVICE]
        # The first run also writes the stand-in weights (on first use of
        # the net) and meets cuDNN's first calls; the second is timed.
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            metrics_app.main(argv)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        nets[net] = {"first_run_seconds": runs[0], "seconds": runs[1]}
        nets[net]["full"], nets[net]["per_view"] = read()
    launches = dict(CR.launches)
    if any(launches.values()):
        fail(f"the metrics path launched rasterizer kernels: {launches}")

    for net, r in nets.items():
        full, per_view = r.pop("full"), r.pop("per_view")
        if sorted(full) != [method] or sorted(full[method]) != [
                "LPIPS", "LPIPS_note", "PSNR", "SSIM"]:
            fail(f"metrics {net}: results.json {full}")
        if "untrained" not in full[method]["LPIPS_note"]:
            fail(f"metrics {net}: LPIPS_note {full[method]['LPIPS_note']!r}")
        if sorted(per_view[method]) != ["LPIPS", "PSNR", "SSIM"] or any(
                sorted(v) != names for v in per_view[method].values()):
            fail(f"metrics {net}: per_view.json names or keys")
        t0 = time.perf_counter()
        metrics_app.main(["-m", model_dir, "--lpips_weights", f"auto:{net}",
                          "--device", "cpu"])
        cpu_seconds[net] = time.perf_counter() - t0
        cpu_full, cpu_view = read()
        worst = {}
        for k, rel in (("SSIM", METRIC_REL), ("PSNR", METRIC_REL),
                       ("LPIPS", LPIPS_REL)):
            errs = [abs(per_view[method][k][n] - cpu_view[method][k][n])
                    / abs(cpu_view[method][k][n]) for n in names]
            worst[k] = max(errs)
            if not worst[k] <= rel:
                fail(f"metrics {net}: {k} {worst[k]} relative to the CPU "
                     f"value (bound {rel})")
        # The parts of one image's time: its two PNG reads on the host,
        # SSIM + PSNR and the LPIPS forward on the card.
        fn = lpips.load_lpips(lpips.default_weights(net), device=DEVICE)
        t0 = time.perf_counter()
        x, y = (metrics_app.read_image(os.path.join(d, names[0])) for d in
                (renders, os.path.join(model_dir, "test", method, "gt")))
        read_ms = (time.perf_counter() - t0) * 1e3
        x, y = (torch.as_tensor(a, device=DEVICE) for a in (x, y))
        r.update(seconds_per_image=r["seconds"] / len(names),
                 png_read_ms=read_ms,
                 ssim_psnr_ms=cuda_time_ms(
                     lambda: (ssim(x, y), psnr(x, y)), 5),
                 lpips_ms=cuda_time_ms(lambda: fn(x, y), 5),
                 values=full[method], rel_err_vs_cpu=worst,
                 cpu_seconds=cpu_seconds[net])
    return dict(images=len(names), size=list(x.shape[1:]), nets=nets,
                launches=launches)


def recorded_360(RA):
    """Wrap render_360_app's _orbit_frames, orbit_config (the orbit-wide
    budget probe), labels_from_seg_maps and write_video to record what an
    app run does and the seconds each takes; returns (record, restore).
    _orbit_frames itself raises on a frame over its probed budget."""
    import torch

    saved = {k: getattr(RA, k) for k in ("_orbit_frames", "orbit_config",
                                         "labels_from_seg_maps",
                                         "write_video")}
    rec = {"orbits": [], "probe_seconds": 0.0, "lift_seconds": 0.0,
           "encode_seconds": 0.0, "videos": []}

    def orbit(*args, **kw):
        t0 = time.perf_counter()
        frames = saved["_orbit_frames"](*args, **kw)
        seconds = time.perf_counter() - t0
        blank = sum(int(f.std() < 1.0) for f in frames)
        rec["orbits"].append(dict(args=args, obj_labels=kw.get("obj_labels"),
                                  frame0=frames[0], frames=len(frames),
                                  blank=blank, seconds=seconds))
        return frames

    def probe(*args, **kw):
        t0 = time.perf_counter()
        out = saved["orbit_config"](*args, **kw)
        torch.cuda.synchronize()
        rec["probe_seconds"] += time.perf_counter() - t0
        return out

    def labels(*args, **kw):
        t0 = time.perf_counter()
        out = saved["labels_from_seg_maps"](*args, **kw)
        rec["lift_seconds"] += time.perf_counter() - t0
        return out

    def video(frames, path, fps):
        t0 = time.perf_counter()
        out = saved["write_video"](frames, path, fps)
        rec["encode_seconds"] += time.perf_counter() - t0
        rec["videos"].append(out)
        return out

    for k, fn in (("_orbit_frames", orbit), ("orbit_config", probe),
                  ("labels_from_seg_maps", labels), ("write_video", video)):
        setattr(RA, k, fn)

    def restore():
        for k, fn in saved.items():
            setattr(RA, k, fn)
    return rec, restore


def orbit_checks(RA, rec, where: str, seconds: float) -> dict:
    """The first orbit's frame 0 against the same frame through the plain
    compositors (check_frame); no orbit all blank; the device's busy share
    over BUSY_FRAMES frames of that orbit; frames per second over the
    orbits alone and over the whole app run of `seconds`, with the run's
    seconds split into its recorded parts."""
    import numpy as np
    import torch

    o = rec["orbits"][0]
    state, sh, c2ws, fovx, fovy, w, h, bg, config = o["args"]
    labels = nonempty = None
    if o["obj_labels"] is not None:
        labels = torch.as_tensor(np.asarray(o["obj_labels"]),
                                 device=state.device).to(torch.bool)
        nonempty = labels.any(dim=1).tolist()
    cam = RA._orbit_cams(c2ws[:1], fovx, fovy, state.device)[0]
    plain = check_frame(f"{where} frame 0", lambda: frame_parts(
        state, cam, w, h, config, labels, nonempty, sh_degree=sh, bg=bg),
        o["frame0"])
    blank = [x["blank"] for x in rec["orbits"]]
    if any(b == x["frames"] for b, x in zip(blank, rec["orbits"])):
        fail(f"{where}: an orbit with every frame blank ({blank})")
    n = min(BUSY_FRAMES, len(c2ws))
    busy = device_busy(lambda: RA._orbit_frames(
        state, sh, c2ws[:n], fovx, fovy, w, h, bg, config,
        obj_labels=o["obj_labels"]))
    busy["frames"] = n
    busy["ms_per_frame"] = busy["ms_host"] / n
    frames = sum(x["frames"] for x in rec["orbits"])
    parts = {k: rec[k] for k in ("probe_seconds", "lift_seconds",
                                 "encode_seconds")}
    parts["orbit_seconds"] = sum(x["seconds"] for x in rec["orbits"])
    parts["other_seconds"] = seconds - sum(parts.values())
    return dict(frames=frames, size=[w, h], orbits=len(rec["orbits"]),
                seconds=seconds, fps=frames / parts["orbit_seconds"],
                fps_run=frames / seconds, **parts,
                entry_budgets=sorted({x["args"][8].entry_budget
                                      for x in rec["orbits"]}),
                plain_check=plain, blank_frames=sum(blank), busy=busy,
                videos=[os.path.basename(v) for v in rec["videos"]])


def field_path(model_dir: str) -> dict:
    """Phase 13: apps/render_360_app --render_type field on the stand-in
    model and phase 10's experiment, with the launch counters read around
    exactly that call."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.apps import render_360_app as RA
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.seg.pipeline import load_pt

    rec, restore = recorded_360(RA)
    try:
        CR.reset_launches()
        t0 = time.perf_counter()
        video = RA.main(["-m", model_dir, "--exp_name", "smoke",
                         "--render_type", "field", "--device", DEVICE]
                        + [f"--{k}={v}" for k, v in FIELD_360.items()])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
    finally:
        restore()
    for k in CR.KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the 360 field path")
    base = os.path.join(model_dir, "wheat-head", "smoke")
    labels = load_pt(os.path.join(base, "all_obj_labels.pth"))
    counts = load_pt(os.path.join(base, "all_counts.pth"))
    if counts.shape != labels.shape or labels.dtype != np.bool_ or \
            labels.shape[0] < 2:
        fail(f"360 field: labels {labels.shape} {labels.dtype}, counts "
             f"{counts.shape}")
    if rec["videos"] != [video] or not os.path.getsize(video) or \
            os.path.exists(os.path.join(base, "3DSeg")):
        fail(f"360 field: video {video}, recorded {rec['videos']}")
    if rec["orbits"][0]["frames"] != FIELD_360["n_frames"]:
        fail(f"360 field: {rec['orbits'][0]['frames']} frames")
    out = orbit_checks(RA, rec, "360 field", seconds)
    w, h = out["size"]
    if (w, h) != (BENCH["width"] // 2, BENCH["height"] // 2):
        fail(f"360 field: frames at {w}x{h}")
    return dict(launches=launches, video=video,
                heads_labelled=int(labels[1:].any(axis=1).sum()),
                label_rows=int(labels.shape[0]), **out)


def head_path(model_dir: str) -> dict:
    """Phase 14: apps/render_360_app --render_type head on the same
    experiment, with the launch counters read around exactly that call."""
    import torch

    from wheat3dgs_tpu_torch.apps import render_360_app as RA
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    base = os.path.join(model_dir, "wheat-head", "smoke")
    plys = sorted(f for f in os.listdir(os.path.join(base, "ply"))
                  if f.startswith("wh_") and f.endswith(".ply")
                  and len(f[:-4].split("_")) == 2)
    rec, restore = recorded_360(RA)
    try:
        CR.reset_launches()
        t0 = time.perf_counter()
        videos = RA.main(["-m", model_dir, "--exp_name", "smoke",
                          "--render_type", "head", "--device", DEVICE]
                         + [f"--{k}={v}" for k, v in HEAD_360.items()])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
    finally:
        restore()
    for k in ("decode_cull", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the 360 head path")
    stems = [os.path.splitext(os.path.basename(v))[0] for v in videos]
    if not plys or stems != [f[3:-4] for f in plys] or any(
            not os.path.getsize(v) for v in videos):
        fail(f"360 head: videos {stems} for head PLYs {plys}")
    if any(o["frames"] != HEAD_360["n_frames"] for o in rec["orbits"]):
        fail("360 head: an orbit with the wrong frame count")
    out = orbit_checks(RA, rec, "360 head", seconds)
    w, h = out["size"]
    if (w, h) != (BENCH["width"] // 3, BENCH["height"] // 3):
        fail(f"360 head: frames at {w}x{h}")
    return dict(launches=launches, heads=len(videos), **out)


def viewer_path(scene_dir: str, model_dir: str) -> dict:
    """Phase 15: apps/viewer_app.build_viewer on the stand-in model with
    the labels the field run wrote, served on a free port in a thread:
    /info, /teleport and VIEWER_REQUESTS /render requests at the CLI's
    960x720, with the launch counters read around them; then one frame's
    image against the plain compositors."""
    import io
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch.apps import viewer_app
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.viewer import serve

    CR.reset_launches()
    t0 = time.perf_counter()
    vs, args = viewer_app.build_viewer(["-s", scene_dir, "-m", model_dir,
                                        "--exp_name", "smoke", "--device",
                                        DEVICE])
    build_seconds = time.perf_counter() - t0
    httpd = serve(vs, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                return r.read()

        info = json.loads(get("/info"))
        tp = json.loads(get("/teleport?i=0"))
        n_heads = info["n_heads"]
        if n_heads < 1 or len(info["cameras"]) != 12:
            fail(f"viewer /info: {n_heads} heads, {len(info['cameras'])} "
                 "cameras")
        c = info["center"]
        views = [(tp["az"], tp["el"], tp["dist"], tp["center"])]
        views += [(0.8 + 0.3 * i, 0.7, 2 * info["radius"], c)
                  for i in range(VIEWER_REQUESTS - 1)]
        heads = ",".join(str(i) for i in range(1, min(n_heads, 3) + 1))
        kinds = ("plain", "overlay", "overlay_whitelist")
        times, by_kind = [], {k: [] for k in kinds}
        for i, (az, el, dist, ctr) in enumerate(views):
            q = (f"/render?az={az}&el={el}&dist={dist}&cx={ctr[0]}"
                 f"&cy={ctr[1]}&cz={ctr[2]}&overlay={i % 3 != 0:d}")
            if i % 3 == 2:
                q += f"&heads={heads}"
            t0 = time.perf_counter()
            jpeg = get(q)
            times.append((time.perf_counter() - t0) * 1e3)
            if i:                                # the first one warms up
                by_kind[kinds[i % 3]].append(times[-1])
            img = Image.open(io.BytesIO(jpeg))
            if jpeg[:2] != b"\xff\xd8" or img.size != (args.width,
                                                        args.height):
                fail(f"viewer request {i}: not a {args.width}x"
                     f"{args.height} JPEG")
        torch.cuda.synchronize()
        launches = dict(CR.launches)
    finally:
        httpd.shutdown()
        httpd.server_close()
    for k in ("decode_cull", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the viewer path")

    # One overlaid frame's image before JPEG against the plain compositors.
    az, el, dist, ctr = views[1]
    got = vs.render_image(az, el, dist, np.asarray(ctr), overlay=True)
    if got.std() < 1.0 / 255:
        fail("viewer frame is blank")
    cam = vs._cam(az, el, dist, np.asarray(ctr))
    plain = check_frame("viewer frame", lambda: frame_parts(
        vs.state, cam, vs.width, vs.height, vs.config, vs._labels,
        vs._nonempty, sh_degree=vs.sh_degree), got)
    return dict(build_seconds=build_seconds, launches=launches,
                requests=len(times), first_request_ms=times[0],
                ms_per_request=sum(times[1:]) / (len(times) - 1),
                ms_by_kind={k: sum(v) / len(v) for k, v in by_kind.items()},
                reprobes=vs.reprobes, entry_budget=vs.config.entry_budget,
                n_heads=n_heads, size=[args.width, args.height],
                plain_check=plain)


def morphology_path(model_dir: str) -> dict:
    """Phase 16: morphology.run_pipeline at the reference config on the
    heads phase 10 wrote, once on the card and once on the CPU from the
    same seeded np.random: every file equal (so each head's kept points,
    traits and boxes), seconds a head split into cluster, SOR and traits
    (each stage returns host arrays, so its device work is inside)."""
    import zipfile

    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.morphology import pipeline
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    heads = os.path.join(model_dir, "wheat-head", "smoke", "ply")
    n_files = len([f for f in os.listdir(heads) if f.endswith(".ply")])
    stages = {"cluster_s": "main_cluster_extraction",
              "sor_s": "statistical_outlier_removal",
              "traits_s": "compute_traits"}
    saved = {k: getattr(pipeline, fn) for k, fn in stages.items()}

    def timed(key, times):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = saved[key](*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    runs = {}
    for tag, dev in (("card", DEVICE), ("cpu", "cpu")):
        out = os.path.join(WORK, f"morphology_{tag}")
        os.makedirs(out)
        times = {k: [] for k in stages}
        np.random.seed(0)
        try:
            for key, fn in stages.items():
                setattr(pipeline, fn, timed(key, times))
            CR.reset_launches()
            t0 = time.perf_counter()
            xlsx = pipeline.run_pipeline(
                dict(MORPHOLOGY, data_folder=heads, output_folder=out),
                device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            for key, fn in stages.items():
                setattr(pipeline, fn, saved[key])
        # The workbook's sheet (its zip stamps each part with the time),
        # the boxes and the merged PLY of kept points.
        files = {"_traits.xlsx": zipfile.ZipFile(xlsx).read(
            "xl/worksheets/sheet1.xml")}
        for suffix in ("_bboxes.json", "_pcd.ply"):
            path = str(xlsx).replace("_traits.xlsx", suffix)
            files[suffix] = open(path, "rb").read()
        runs[tag] = dict(seconds=seconds, times=times, files=files,
                         rows=_xlsx_rows(str(xlsx)),
                         launches=dict(CR.launches))
    if not runs["cpu"]["rows"] or len(runs["cpu"]["rows"]) != n_files:
        fail(f"morphology: {len(runs['cpu']['rows'])} rows for {n_files} "
             "head PLYs")
    for suffix in runs["cpu"]["files"]:
        if runs["card"]["files"][suffix] != runs["cpu"]["files"][suffix]:
            diff = [(a, b) for a, b in zip(runs["card"]["rows"],
                                           runs["cpu"]["rows"]) if a != b]
            fail(f"morphology: {suffix} differs between {DEVICE} and cpu; "
                 f"rows apart: {diff[:3]}")

    def per_head(tag):
        t = runs[tag]["times"]
        return {k: float(np.sum(v) / n_files) for k, v in t.items()} | {
            "seconds_per_head": runs[tag]["seconds"] / n_files,
            "first_head_cluster_s": t["cluster_s"][0],
            "sor_runs": len(t["sor_s"])}

    points = [int(r[3]) for r in runs["cpu"]["rows"]]
    return dict(heads=n_files, rows=len(points), files_equal=True,
                launches=runs["card"]["launches"], kept_points=points,
                seconds={t: runs[t]["seconds"] for t in runs},
                per_head={t: per_head(t) for t in runs},
                traits_first_row=runs["cpu"]["rows"][0])


def _xlsx_rows(path: str) -> list:
    """The data rows of a traits workbook, as lists of cell texts."""
    import re
    import zipfile

    xml = zipfile.ZipFile(path).read("xl/worksheets/sheet1.xml").decode()
    rows = re.findall(r"<row [^>]*>(.*?)</row>", xml)[1:]
    return [re.findall(r"<(?:v|t)>(.*?)</(?:v|t)>", r) for r in rows]


# The step runner the pipeline scripts' `python` calls go through: it runs
# the module (or stdin's program, or a script by path) as python would, and
# appends the step's seconds, the port's kernel launches in that process
# and its exit status to a log. With SMOKE_SHIM set, sys.executable is that
# shim, so a step's own `sys.executable` subprocesses are logged too.
STEP_RUNNER = """import atexit, json, os, runpy, sys, time
t0 = time.perf_counter()
argv = sys.argv[1:]
status = [None]

def record():
    mod = sys.modules.get("wheat3dgs_tpu_torch.ops.cuda_build")
    rec = {"argv": argv, "seconds": time.perf_counter() - t0,
           "launches": dict(mod.launches) if mod else {},
           "exit": status[0]}
    with open(os.environ["SMOKE_STEP_LOG"], "a") as f:
        f.write(json.dumps(rec) + "\\n")

atexit.register(record)
if os.environ.get("SMOKE_SHIM"):
    sys.executable = os.environ["SMOKE_SHIM"]
try:
    if argv[:1] == ["-m"]:
        sys.argv = argv[1:]
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    elif argv == ["-"]:
        sys.argv = ["-"]
        exec(compile(sys.stdin.read(), "<stdin>", "exec"),
             {"__name__": "__main__"})
    elif argv and argv[0].endswith(".py"):
        sys.argv = argv
        sys.path.insert(0, os.path.dirname(os.path.abspath(argv[0])))
        runpy.run_path(argv[0], run_name="__main__")
    else:
        sys.exit(f"unexpected python call: {argv}")
    status[0] = 0
except SystemExit as e:
    status[0] = e.code if isinstance(e.code, int) else (
        0 if e.code is None else 1)
    raise
except BaseException:
    status[0] = 1
    raise
"""


def step_runner() -> str:
    """WORK/bin, made on first use: STEP_RUNNER and a `python` shim that
    runs every call through it."""
    bindir = os.path.join(WORK, "bin")
    if not os.path.isdir(bindir):
        os.makedirs(bindir)
        with open(os.path.join(bindir, "step_runner.py"), "w") as f:
            f.write(STEP_RUNNER)
        shim = os.path.join(bindir, "python")
        with open(shim, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" '
                    f'"{os.path.join(bindir, "step_runner.py")}" "$@"\n')
        os.chmod(shim, 0o755)
    return bindir


def run_script(script: str, args: list, env: dict, log_name: str) -> dict:
    """Run one of the port's pipeline scripts under bash with `python` on
    PATH going through STEP_RUNNER; its steps (argv, seconds, launches),
    exit code and seconds. Its output goes to WORK/<log_name>."""
    return run_logged(["bash", os.path.join(ROOT, "wheat3dgs_tpu_torch",
                                            "scripts", script), *args],
                      env, log_name)


def run_logged(cmd: list, env: dict, log_name: str) -> dict:
    """Run `cmd` with `python` on PATH going through STEP_RUNNER (a
    leading "python" names the shim); its steps, seconds and launches as
    run_script's. Fails if it exits non-zero."""
    import subprocess

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    bindir = step_runner()
    step_log = os.path.join(WORK, log_name + ".steps")
    if os.path.exists(step_log):
        os.remove(step_log)
    full = dict(os.environ, PATH=f"{bindir}:{os.environ.get('PATH', '')}",
                SMOKE_STEP_LOG=step_log, **env)
    if cmd[0] == "python":
        cmd = [os.path.join(bindir, "python"), *cmd[1:]]
    out_path = os.path.join(WORK, log_name)
    t0 = time.perf_counter()
    # A process group of its own, so that a failure stops the script's
    # steps with it (stop_scripts).
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=full, stdout=out,
                                stderr=subprocess.STDOUT, process_group=0)
    SCRIPTS.add(proc)
    try:
        proc.wait(timeout=SCRIPT_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"{os.path.basename(cmd[1])} ran past {SCRIPT_TIMEOUT} s")
    finally:
        SCRIPTS.discard(proc)
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    seconds = time.perf_counter() - t0
    steps = []
    if os.path.exists(step_log):
        steps = [json.loads(ln) for ln in open(step_log)]
    if proc.returncode != 0:
        tail = open(out_path).read()[-3000:]
        fail(f"{os.path.basename(cmd[1])} exited {proc.returncode} after "
             f"{len(steps)} steps ({[st['argv'][:2] for st in steps]}):\n"
             f"{tail}")
    launches = {k: sum(st["launches"].get(k, 0) for st in steps)
                for k in CR.launches}
    return dict(seconds=seconds, launches=launches,
                steps=[{"step": " ".join(st["argv"][:2]),
                        "seconds": st["seconds"], "exit": st["exit"],
                        "launches": st["launches"]} for st in steps])


def bench_path(scene_dir: str) -> dict:
    """Phase 20: `python -m wheat3dgs_tpu_torch.apps.bench` as its own
    process (through STEP_RUNNER, which logs the process's seconds and
    kernel launches) on phase 3's scene, the bench plot, at the default
    WHEAT3DGS_BENCH_ITERS: one JSON line on stdout with bench.py's keys,
    every value finite and positive, no training overflow event and no
    render over its budget (the bench's stderr lines), each training
    kernel launched on every step."""
    import math
    import re
    import subprocess

    bindir = step_runner()
    step_log = os.path.join(WORK, "bench.steps")
    if os.path.exists(step_log):
        os.remove(step_log)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WHEAT3DGS_BENCH_")}
    env.update(WHEAT3DGS_BENCH_SCENE=scene_dir, SMOKE_STEP_LOG=step_log,
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                             else [])))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(bindir, "step_runner.py"), "-m",
         "wheat3dgs_tpu_torch.apps.bench"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=SCRIPT_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"apps/bench exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"apps/bench printed {len(lines)} stdout lines, not one")
    line = json.loads(lines[0])
    if list(line) != BENCH_KEYS or line["metric"] != "train_iters_per_sec" \
            or line["unit"] != "it/s":
        fail(f"apps/bench's line has other keys or names: {line}")
    for k in BENCH_KEYS:
        v = line[k]
        if not isinstance(v, str) and not (math.isfinite(v) and v > 0):
            fail(f"apps/bench's {k} is {v}")
    overflow = re.search(r"overflow_events=(\d+)", proc.stderr)
    demand = re.search(r"demand max (\d+) of budget (\d+)", proc.stderr)
    if overflow is None or demand is None:
        fail("apps/bench's stderr lacks its overflow or demand report")
    overflow, demand, budget = (int(overflow.group(1)),
                                int(demand.group(1)), int(demand.group(2)))
    if overflow or demand > budget:
        fail(f"apps/bench went over its budget: {overflow} training "
             f"overflow events, render demand {demand} of {budget}")
    with open(step_log) as f:
        launches = json.loads(f.read().splitlines()[-1])["launches"]
    # apps/bench's default iterations, its step at the warm-up iteration
    # and its three rung blocks of 20.
    steps = BENCH_ITERS + 1 + 3 * 20
    for k in ("composite_train_fwd", "composite_bwd", "segsum"):
        if launches.get(k, 0) < steps:
            fail(f"apps/bench launched {k} {launches.get(k, 0)} times for "
                 f"{steps} steps")
    return dict(seconds=seconds, line=line, launches=launches,
                overflow_events=overflow, render_demand=demand,
                render_budget=budget,
                stderr=[ln for ln in proc.stderr.splitlines()
                        if not ln.startswith(("I0000", "W0000"))][-8:])


def check_bench_kernels(scene_dir: str) -> dict:
    """Phase 20: the kernels against their plain versions at the shapes the
    bench gives them. apps/bench's own functions train phase 3's scene in
    this process as its run does (load_scene, then train: the warm-up, the
    rung blocks and the timed windows at BENCH_ITERS, densified past the
    warm-up); then on the first and last train views hold_step at the
    Trainer's probed budget and SH 3, and render_fwd (decode_cull,
    composite_fwd) at the render rate's adapt_config budget against the
    all-plain path: demand under the budget, colour and alpha within
    COMPOSITE_ATOL / COMPOSITE_RTOL but on the ALPHA_MIN pixels of
    hold_step, held under STOP_MISMATCH_MAX."""
    import torch

    from wheat3dgs_tpu_torch.apps import bench
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.render.pipeline import render_fwd

    dev = torch.device(DEVICE)
    scene = bench.load_scene(scene_dir, dev)
    trainer, cams, _, _ = bench.train(scene, BENCH_ITERS, dev)
    trainer.graph.release()
    w, h = scene.image_size
    gts = torch.as_tensor(scene.data.train.images, device=dev)
    views = (0, len(cams) - 1)
    train = [dict(view=i, **hold_step(
        trainer.state, cams[i], gts[i], 3, trainer.opt, trainer.config,
        f"bench kernels, train view {i}")) for i in views]
    config = bench.render_config(trainer, cams, w, h)
    renders = []
    for i in views:
        def once():
            out = render_fwd(trainer.state, *cams[i], w, h, sh_degree=3,
                             config=config)
            return (torch.cat([out.color, out.alpha[None]]),
                    int(out.entries_total))

        img, demand = once()
        with CR.plain_kernels():
            ref, _ = once()
        where = f"bench render_fwd, train view {i}"
        if demand > config.entry_budget:
            fail(f"{where}: demand {demand} over budget "
                 f"{config.entry_budget}")
        if not bool(torch.isfinite(img).all()):
            fail(f"{where}: non-finite colour or alpha")
        err = (img - ref).abs()
        off = int((err > COMPOSITE_ATOL + COMPOSITE_RTOL
                   * ref.abs()).any(0).sum())
        if off > STOP_MISMATCH_MAX * w * h:
            fail(f"{where}: colour or alpha differs from the plain path on "
                 f"{off} pixels, by up to {float(err.max())}")
        renders.append(dict(view=i, entry_budget=config.entry_budget,
                            entries=demand, max_abs_err=float(err.max()),
                            pixels_off=off))
    return dict(train=train, render=renders)


def make_pipeline_scene() -> str:
    """Phase 17's plot (PIPELINE_SCENE), made in this thread (the
    generator renders with the kernels), and the step runner; returns the
    plot's directory."""
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    scene_dir = os.path.join(WORK, "pipeline_scene")
    make_synthetic_colmap_scene(scene_dir, device=DEVICE, **PIPELINE_SCENE)
    step_runner()
    return scene_dir


def pipeline_path(scene_dir: str) -> dict:
    """Phase 17: wheat3dgs_tpu_torch/scripts/run_wheat_3dgs.sh on the
    pipeline plot into a fresh model dir (DEVICE=cuda, ITERS=PIPELINE_ITERS,
    the 360 videos at PIPELINE_FRAMES), every step through the port's apps,
    then scripts/eval.sh on that model; the output tree and each step's
    seconds and launches. Runs in a thread beside other phases: nothing
    here touches this process's launch counters."""
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    python = {"python": shutil.which("python"),
              "python3": shutil.which("python3")}
    model = os.path.join(WORK, "pipeline_model")
    env = {"DEVICE": DEVICE, "ITERS": str(PIPELINE_ITERS),
           **PIPELINE_FRAMES}
    run = run_script("run_wheat_3dgs.sh", [scene_dir, model, "smoke", "0.6"],
                     env, "pipeline.log")
    if len(run["steps"]) != 8:
        fail(f"run_wheat_3dgs.sh ran {len(run['steps'])} python steps, "
             "expected 8")
    for k in CR.KERNELS:
        if run["launches"][k] <= 0:
            fail(f"kernel {k} was not launched on the pipeline")
    base = os.path.join(model, "wheat-head", "smoke")
    need = [os.path.join(model, "point_cloud", f"iteration_{PIPELINE_ITERS}",
                         "point_cloud.ply"),
            os.path.join(model, "results.json"),
            os.path.join(base, "all_counts.pt"),
            os.path.join(base, "wheat_field_360.mp4")]
    need += [os.path.join(model, "test", sub, f"plot_000_{c}.png")
             for sub in ("segmentation", "overlay") for c in (11, 12)]
    missing = [p for p in need if not os.path.exists(p)]

    def ls(sub):
        d = os.path.join(base, sub)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    plys = [f for f in ls("ply") if f.startswith("wh_")
            and f.endswith(".ply")]
    videos = ls("wheat_head_360")
    xlsx = [f for f in ls("morphology") if f.endswith("_traits.xlsx")]
    rows = (_xlsx_rows(os.path.join(base, "morphology", xlsx[0]))
            if len(xlsx) == 1 else [])
    if missing or not plys or not videos or len(rows) != len(plys):
        fail(f"pipeline tree: missing {missing}, {len(plys)} head PLYs, "
             f"{len(videos)} head videos, {len(xlsx)} traits xlsx with "
             f"{len(rows)} rows")
    results = json.load(open(os.path.join(model, "results.json")))
    ev = run_script("eval.sh", [scene_dir, model, "smoke"], env,
                    "eval_script.log")
    if len(ev["steps"]) != 3:
        fail(f"eval.sh ran {len(ev['steps'])} python steps, expected 3")
    return dict(python_on_path=python, iterations=PIPELINE_ITERS,
                head_plys=len(plys), head_videos=len(videos),
                traits_rows=len(rows), results=results, **run,
                eval_script=ev)


def hold_step(st, cam, gt, sh_degree: int, opt, config, where: str) -> dict:
    """The four training kernels against their plain versions at one state,
    view and raster config: the step's loss is differentiated with respect
    to every parameter and the viewspace hook (the densification
    statistics' input) on the kernel path and on the all-plain path; each
    gradient is held within GRAD_REL of its max |value|. The colour image
    is held within COMPOSITE_ATOL / COMPOSITE_RTOL except on pixels where
    an entry's alpha lands within rounding of ALPHA_MIN (the kernel's conic
    power is contracted to FMAs): one path keeps it and the other drops
    it, which moves the pixel by up to ALPHA_MIN x its transmittance x its
    value, and its stop. Those pixels are counted and held under
    STOP_MISMATCH_MAX of the pixels, as composite_train_fwd's stops are."""
    import dataclasses

    import torch

    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.cuda_raster import default_budget
    from wheat3dgs_tpu_torch.ops.losses import photometric_loss
    from wheat3dgs_tpu_torch.render.pipeline import render

    h, w = gt.shape[-2:]
    bg = torch.zeros(3, device=DEVICE)

    def step_grads():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in st.params.as_dict().items()}
        ndc = torch.zeros((st.capacity, 2), device=DEVICE,
                          requires_grad=True)
        view = dataclasses.replace(st, params=G.GaussianParams(**leaves))
        out = render(view, *cam, w, h, sh_degree, bg=bg, ndc_offset=ndc,
                     config=config)
        loss = photometric_loss(out.color, gt, opt.lambda_dssim)
        grads = torch.autograd.grad(loss, list(leaves.values()) + [ndc])
        return (out.color.detach(), float(loss.detach()),
                int(out.entries_total),
                dict(zip(list(leaves) + ["viewspace"], grads)))

    color, loss, entries, got = step_grads()
    with CR.plain_kernels():
        ref_color, ref_loss, _, ref = step_grads()
    budget = config.entry_budget or default_budget(st.capacity)
    if entries > budget:
        fail(f"{where}: demand {entries} over budget {budget}")
    err = (color - ref_color).abs()
    off = int((err > COMPOSITE_ATOL + COMPOSITE_RTOL
               * ref_color.abs()).any(0).sum())
    if off > STOP_MISMATCH_MAX * w * h:
        fail(f"{where}: colour image differs from the plain path on "
             f"{off} pixels, by up to {float(err.max())}")
    grad_rel = {}
    for k, a in got.items():
        top = float(ref[k].abs().max())
        grad_rel[k] = (float((a - ref[k]).abs().max()) / top
                       if top > 0 else 0.0)
        if not bool(torch.isfinite(a).all()) or grad_rel[k] > GRAD_REL:
            fail(f"{where}: gradient of {k} {grad_rel[k]} of its max "
                 f"(bound {GRAD_REL})")
    return dict(capacity=st.capacity, alive=int(st.num_alive),
                entry_budget=budget, entries=entries, loss=loss,
                plain_loss=ref_loss, colour_max_abs_err=float(err.max()),
                colour_pixels_off=off, grad_rel_of_max=grad_rel)


def check_app_kernels(states, cams, gts, sh_degree: int, opt) -> list:
    """Phase 19: hold_step at the shapes the multi-plot app gives the
    training kernels: each trained plot on its first train view at
    RasterConfig() (the app's automatic budget of 16 entries a slot), at
    the run's capacity and at its doubling (the app's pad_cap)."""
    from wheat3dgs_tpu_torch.apps.train_multi import _pad_cap
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.render.pipeline import RasterConfig

    results = []
    for doubled in (False, True):
        stacked = _pad_cap(states) if doubled else states
        for p in range(gts.shape[0]):
            st = G.map_tensors(lambda x: x[p], stacked)
            results.append(dict(plot=p, **hold_step(
                st, tuple(c[p, 0] for c in cams), gts[p, 0], sh_degree,
                opt, RasterConfig(), f"multi-plot kernels, plot {p} at "
                f"capacity {st.capacity}")))
    return results


def multi_argv(scene_dir: str, model_base: str) -> list:
    """apps/train_multi's arguments in phases 19 and 27: phase 3's scene
    and phase 19's plot 462, MULTI_ITERS iterations of bench.py's schedule
    (densify from MULTI_DENSIFY_FROM every MULTI_INTERVAL until
    MULTI_INTERVAL before the end, no opacity reset), MULTI_VIEWS views a
    step."""
    return ["--source_paths", scene_dir, os.path.join(WORK, "plot_462"),
            "--model_base", model_base, "--device", DEVICE,
            "--iterations", str(MULTI_ITERS),
            "--densify_from_iter", str(MULTI_DENSIFY_FROM),
            "--densification_interval", str(MULTI_INTERVAL),
            "--densify_until_iter", str(MULTI_ITERS - MULTI_INTERVAL),
            "--opacity_reset_interval", "100000",
            "--views_per_step", str(MULTI_VIEWS), "--quiet"]


def multi_plot_path(scene_dir: str) -> dict:
    """Phase 19: apps/train_multi on two bench plots (phase 3's scene and
    the generator's plot 462) with MULTI_VIEWS views a step, the launch
    counters reset just before and read just after; then one multi-plot
    step against single-plot steps and a replayed step against an eager
    one, and the steady rates at SH 3 for P = 1, 2 and B = 1, 2."""
    import math

    import numpy as np
    import torch

    from wheat3dgs_tpu_torch import training
    from wheat3dgs_tpu_torch.apps import train_multi
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.models.serialization import load_ply
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.cuda_raster import default_budget

    plot2 = os.path.join(WORK, "plot_462")
    t0 = time.perf_counter()
    make_synthetic_colmap_scene(plot2, device=DEVICE, **MULTI_PLOT, **{
        k: BENCH[k] for k in ("width", "height", "n_cams", "n_heads",
                              "pts_per_head", "ground_pts")})
    gen_seconds = time.perf_counter() - t0

    # Every step object the app builds, and per call (no host read): the
    # capacity, the worst per-plot demand over its budget (entry_budget 0:
    # 16 per slot), the losses' finiteness, the first step's PSNR.
    built, caps = [], []
    dev = torch.device(DEVICE)
    over = torch.full((), -2 ** 40, dtype=torch.int64, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    first = {}

    class Recording(training.MultiPlotStep):
        def __call__(self, states, *args):
            states, m = super().__call__(states, *args)
            cap = states.alive.shape[1]
            caps.append(cap)
            torch.maximum(over, (m["entries_total"].max().to(torch.int64)
                                 - default_budget(cap)), out=over)
            finite.logical_and_(torch.isfinite(m["loss"]).all())
            first.setdefault("psnr", m["psnr"])
            return states, m

    def factory(*a, **k):
        built.append(Recording(*a, **k))
        return built[-1]

    model_base = os.path.join(WORK, "multi_models")
    n_iter, interval = MULTI_ITERS, MULTI_INTERVAL
    densify_from, densify_until = MULTI_DENSIFY_FROM, n_iter - interval
    argv = multi_argv(scene_dir, model_base)
    real = train_multi.multi_plot_step
    train_multi.multi_plot_step = factory
    try:
        torch.cuda.reset_peak_memory_stats()
        CR.reset_launches()
        t0 = time.perf_counter()
        scenes, states = train_multi.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        train_multi.multi_plot_step = real
    n_plots = len(scenes)
    per_step = n_plots * MULTI_VIEWS
    for k in ("decode_cull", "composite_train_fwd", "composite_bwd",
              "segsum"):
        if launches[k] != n_iter * per_step:
            fail(f"multi-plot path: {k} launched {launches[k]} times in "
                 f"{n_iter} steps of {n_plots} plots x {MULTI_VIEWS} views")
    if launches["composite_fwd"]:
        fail("multi-plot path: the forward-only compositor ran")
    if len(caps) != n_iter or not bool(finite):
        fail(f"multi-plot path: {len(caps)} steps, finite losses "
             f"{bool(finite)}")
    if int(over) > 0:
        fail(f"multi-plot path: a step's demand exceeded its budget by "
             f"{int(over)} entries")
    logs = [json.loads(ln) for ln in open(os.path.join(
        model_base, "metrics_multi.jsonl"))]
    last = logs[-1]
    if last["iter"] != n_iter or not all(map(math.isfinite, last["loss"])):
        fail(f"multi-plot path: last log {last}")
    psnr0 = first["psnr"].tolist()
    rise = [b - a for a, b in zip(psnr0, last["psnr"])]
    if not min(rise) > MULTI_PSNR_RISE_DB:
        fail(f"multi-plot path: PSNR {psnr0} -> {last['psnr']}")
    n_init = [len(s.data.point_cloud.points) for s in scenes]
    densify_events = len([it for it in range(densify_from + 1,
                                             densify_until)
                          if it % interval == 0])
    doublings = sum(b > a for a, b in zip(caps, caps[1:]))
    sh_changes = len(built) - 1
    captures = sum(b.graph.captures for b in built)
    replays = sum(b.graph.replays for b in built)
    if last["n_alive"] == n_init or densify_events < 1:
        fail(f"multi-plot path: no densify event ({n_init} -> "
             f"{last['n_alive']})")
    if captures > densify_events + doublings + sh_changes + 1 or \
            replays != n_iter - captures:
        fail(f"multi-plot graph: {captures} captures, {replays} replays "
             f"({densify_events} densify events, {doublings} doublings)")
    plys = []
    for s in scenes:
        ply = os.path.join(s.model_path, "point_cloud",
                           f"iteration_{n_iter}", "point_cloud.ply")
        st, sh = load_ply(ply, device=DEVICE)
        plys.append(int(st.num_alive))
    if plys != last["n_alive"]:
        fail(f"multi-plot PLYs hold {plys} splats, the log {last['n_alive']}")

    # One step from copies of the trained states: P = 2 eagerly (twice,
    # for the spread of eager runs), each plot alone (P = 1), and a
    # replay of the P = 2 step's graph from the same state.
    w, h = scenes[0].image_size
    gts = torch.stack([torch.as_tensor(s.data.train.images, device=DEVICE)
                       for s in scenes])
    banks = [torch.stack(list(c)) for c in zip(
        *(s.cam_stack("train") for s in scenes))]
    extents = [float(s.cameras_extent) for s in scenes]
    opt = built[-1].opt
    bg = torch.zeros(3, device=DEVICE)
    rows = torch.arange(n_plots, device=DEVICE)[:, None]

    def inputs(vi, plots, it, t):
        """The step's arguments as the app gathers them."""
        sel = training.to_device(vi, dev)
        pr = rows[plots]
        return (tuple(c[pr, sel] for c in banks), gts[pr, sel], bg,
                training.to_device(training.plot_scalars(
                    it, t, opt, [extents[p] for p in plots]), dev))

    for b in built:
        b.graph.release()
    app_kernels = check_app_kernels(states, banks, gts, built[-1].sh_degree,
                                    opt)
    vi = np.array([[1, 4], [2, 7]])
    start = G.map_tensors(torch.clone, states)
    t1 = start.adam.step + 1

    def copy(plots):
        return G.map_tensors(lambda x: x[plots], start)

    def eager(plots):
        """A fresh step's first call: the step runs eagerly (the capture
        that follows it runs nothing)."""
        return training.multi_plot_step(3, w, h, opt)(
            copy(plots), *inputs(vi[plots], plots, 20_001, t1))

    (a1, m1), (a2, m2) = eager([0, 1]), eager([0, 1])
    alone = [eager([p]) for p in range(n_plots)]
    replayed = copy([0, 1])
    snap = [t.clone() for t in training.state_tensors(replayed)]
    rstep = training.multi_plot_step(3, w, h, opt)
    rstep(replayed, *inputs(vi, [0, 1], 20_001, t1))
    for t, s0 in zip(training.state_tensors(replayed), snap):
        t.copy_(s0)
    _, mr = rstep(replayed, *inputs(vi, [0, 1], 20_001, t1))
    if rstep.graph.replays != 1:
        fail(f"multi-plot replay: {rstep.graph.replays} replays")
    torch.cuda.synchronize()
    rstep.graph.release()

    def diff(sa, ma, pa, sb, mb, pb):
        """Max |a - b| over plot pa of sa and plot pb of sb, every state
        tensor and metric."""
        out = [float((x[pa].double() - y[pb].double()).abs().max())
               for x, y in zip(training.state_tensors(sa),
                               training.state_tensors(sb))]
        out += [float((ma[k][pa].double() - mb[k][pb].double()).abs())
                for k in training.PLOT_METRICS]
        return out

    spread = [max(x, y) for x, y in zip(diff(a1, m1, 0, a2, m2, 0),
                                        diff(a1, m1, 1, a2, m2, 1))]
    vs_alone = [max(x, y) for x, y in zip(*(
        diff(a1, m1, p, *alone[p], 0)
        for p in range(n_plots)))]
    vs_replay = [max(x, y) for x, y in zip(*(
        diff(a1, m1, p, replayed, mr, p) for p in range(n_plots)))]
    for name, d in (("single-plot steps", vs_alone),
                    ("its replay", vs_replay)):
        bad = [i for i, (x, y) in enumerate(zip(d, spread)) if x > y]
        if bad:
            fail(f"multi-plot step against {name} beyond the eager spread "
                 f"at {[(i, d[i], spread[i]) for i in bad]}")

    # Steady rates at SH 3, after each configuration's capture, in turns.
    rng = np.random.default_rng(5)
    configs = {}
    for plots, b in (([0], 1), ([0], 2), ([0, 1], 1), ([0, 1], 2)):
        configs[(len(plots), b)] = (plots, b, copy(plots),
                                    training.multi_plot_step(3, w, h, opt))
    its = iter(range(30_001, 10 ** 9))

    def turn(key, n):
        """n iterations of the app's loop body: picks, gathers, the
        scalar rows, the step."""
        plots, b, st, step = configs[key]
        for _ in range(n):
            v = rng.integers(len(banks[0][0]), size=(len(plots), b))
            step(st, *inputs(v, plots, next(its), st.adam.step + 1))
            st.adam.step += 1
        torch.cuda.synchronize()

    for key in configs:
        turn(key, 2)                # capture, then one replay
    times = {key: [] for key in configs}
    order = (list(configs) + list(configs)[::-1]) * MULTI_RATE_ROUNDS
    for key in order:
        t0 = time.perf_counter()
        turn(key, MULTI_RATE_STEPS)
        times[key].append(time.perf_counter() - t0)
    rates = {}
    for (p, b), ts in times.items():
        step_s = sum(ts) / (len(ts) * MULTI_RATE_STEPS)
        rates[f"P{p}_B{b}"] = dict(
            ms_per_step=step_s * 1e3, plot_it_per_s=1.0 / step_s,
            plot_iterations_per_s=p / step_s, turns_s=ts,
            turn_spread=(max(ts) - min(ts)) / (sum(ts) / len(ts)))
    # ms a step against the renders in it (P·B), least squares over every
    # turn: a cost per render and a cost per step whatever its size.
    x = np.array([p * b for (p, b), ts in times.items() for _ in ts])
    y = np.array([t * 1e3 / MULTI_RATE_STEPS for ts in times.values()
                  for t in ts])
    per_render, per_step = np.polyfit(x, y, 1)
    fit = dict(ms_per_render=float(per_render), ms_per_step=float(per_step),
               max_abs_residual_ms=float(np.abs(
                   y - (per_render * x + per_step)).max()))
    busy = device_busy(lambda: turn((2, 2), MULTI_BUSY_STEPS))
    busy["steps"] = MULTI_BUSY_STEPS
    rate_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    return dict(
        seconds=seconds, generate_seconds=gen_seconds, iterations=n_iter,
        plots=n_plots, views_per_step=MULTI_VIEWS, launches=launches,
        initial_points=n_init, capacity=caps[-1],
        entry_budget=default_budget(caps[-1]), n_alive=last["n_alive"],
        psnr_first=psnr0, psnr_last=last["psnr"], loss_last=last["loss"],
        demand_over_budget_max=int(over), densify_events=densify_events,
        capacity_doublings=doublings, captures=captures, replays=replays,
        capture_seconds=[x for b in built for x in b.graph.capture_seconds],
        peak_memory_gb=peak_gb, rates_peak_memory_gb=rate_peak_gb,
        single_vs_multi_bit_identical=not any(vs_alone),
        replay_vs_eager_bit_identical=not any(vs_replay),
        eager_runs_bit_identical=not any(spread),
        max_abs_multi_vs_single=max(vs_alone),
        max_abs_replay_vs_eager=max(vs_replay),
        max_abs_eager_vs_eager=max(spread), app_kernels=app_kernels,
        rates=rates, rate_fit=fit, busy=busy)


def dist_rank(rank: int, world: int, init: str, out_dir: str,
              scene_dir: str, device: str) -> None:
    """Phase 21, one spawned rank: init_ranks over gloo on `device` (the
    parent's DEVICE), then dist_meshes; the result or the traceback into
    out_dir/rank<r>.json."""
    import traceback

    import torch

    global DEVICE
    DEVICE = device
    sys.path.insert(0, ROOT)
    from wheat3dgs_tpu_torch.parallel import mesh as TM

    try:
        ranks = TM.init_ranks("gloo", init, world, rank, device=DEVICE)
        res = {"ok": True, **dist_meshes(ranks, scene_dir)}
    except (Exception, SystemExit):       # fail() exits
        res = {"ok": False, "error": traceback.format_exc()}
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def dist_meshes(ranks, scene_dir: str) -> dict:
    """For each (plots, views) mesh of DIST_MESHES over the ranks: the
    bench plot from its points3D as every plot (plot p on train views
    p * views .. p * views + views - 1), SH 3, the app's automatic budget;
    DIST_STEPS steps of the mesh's multi-plot step on this rank's share
    (the launch counters reset just before and read just after), then the
    one-process multi_plot_step (replayed from a CUDA graph) on the whole,
    and this rank's plots held to it: loss, L1 and PSNR within
    DIST_LOSS_RTOL, the means within DIST_ATOL, grad_accum and every
    parameter's Adam moments within DIST_MOMENT_REL of their max |value|
    (the rotations' of the largest), alive, denom and radii exactly, each
    step's n_alive and entries_total equal."""
    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch import training as TT
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.parallel import mesh as TM
    from wheat3dgs_tpu_torch.scene import Scene

    scene = Scene(cfg.ModelParams(source_path=scene_dir), device=DEVICE)
    opt = cfg.OptimizationParams()
    w, h = scene.image_size
    gts_all = torch.as_tensor(scene.data.train.images, device=DEVICE)
    cams_all = scene.cam_stack("train")
    bg = torch.zeros(3, device=DEVICE)
    # (A CPU rehearsal spawns its ranks with DEVICE "cpu".)
    sync = (torch.cuda.synchronize if torch.device(DEVICE).type == "cuda"
            else (lambda: None))
    out = {"device": str(ranks.device), "staged": ranks.staged,
           "backend": ranks.backend, "meshes": []}
    for n_plots, n_views in DIST_MESHES:
        idx = torch.arange(n_plots * n_views, device=DEVICE).reshape(
            n_plots, n_views)
        cams = tuple(a[idx] for a in cams_all)
        gts = gts_all[idx]
        states = TM.stack_states([G.map_tensors(torch.clone,
                                                scene.gaussians)
                                  for _ in range(n_plots)])
        extents = [scene.cameras_extent] * n_plots
        mesh = TM.make_mesh(n_plots, n_views, ranks=ranks)
        step = TM.build_multi_plot_trainer(mesh, 3, w, h, opt)
        mine = TM.shard_states(mesh, G.map_tensors(torch.clone, states))
        my_cams, my_gts = TM.shard_views(mesh, (cams, gts))
        rows = [TT.plot_scalars(it, it, opt, extents).to(DEVICE)
                for it in range(1, DIST_STEPS + 1)]
        ms = []
        CR.reset_launches()
        sync()
        t0 = time.perf_counter()
        for it, row in enumerate(rows, 1):
            mine, m = step(mine, my_cams, my_gts, bg,
                           TM.shard_plot(mesh, row))
            mine.adam.step += 1
            ms.append(m)
        sync()
        seconds = time.perf_counter() - t0
        launches = dict(CR.launches)
        ref_step = TT.multi_plot_step(3, w, h, opt)
        ref = G.map_tensors(torch.clone, states)
        refs = []
        for row in rows:
            ref, m = ref_step(ref, cams, gts, bg, row)
            ref.adam.step += 1
            refs.append(m)
        p = mesh.index("plot")
        where = f"distributed {n_plots}x{n_views}, rank {ranks.rank}"
        loss_rel = 0.0
        for m, r in zip(ms, refs):
            for k in ("loss", "l1", "psnr"):
                got, want = float(m[k][0]), float(r[k][p])
                rel = abs(got - want) / abs(want)
                loss_rel = max(loss_rel, rel)
                if rel > DIST_LOSS_RTOL:
                    fail(f"{where}: {k} {got} against {want}")
            for k in ("n_alive", "entries_total"):
                if int(m[k][0]) != int(r[k][p]):
                    fail(f"{where}: {k} {int(m[k][0])} against "
                         f"{int(r[k][p])}")
        mine_ref = TM.shard_states(mesh, ref)
        # JAX's test holds the loss and the means. The other parameters
        # are held through their Adam moments and grad_accum relative to
        # each one's max |value|: Adam gives a near-zero gradient's float
        # noise (the views' sum taken in another order) a full step of
        # either sign. The rotations of points3D's isotropic splats have a
        # true gradient of 0, so theirs are held relative to the largest
        # moment of any leaf.
        errs = {"means": float((mine.params.means
                                - mine_ref.params.means).abs().max())}
        if errs["means"] > DIST_ATOL:
            fail(f"{where}: means off by {errs['means']}")
        scales = {}
        for moment in ("mu", "nu"):
            got = getattr(mine.adam, moment)
            want = getattr(mine_ref.adam, moment)
            top = max(float(want[k].abs().max()) for k in G.PARAM_FIELDS)
            for k in G.PARAM_FIELDS:
                name = f"{moment} {k}"
                scales[name] = float(want[k].abs().max())
                errs[name] = float((got[k] - want[k]).abs().max())
                scale = top if k == "quats" else scales[name]
                if not errs[name] <= DIST_MOMENT_REL * scale:
                    fail(f"{where}: {name} off by {errs[name]} (max "
                         f"|value| {scales[name]}, bound "
                         f"{DIST_MOMENT_REL} x {scale})")
        scales["grad_accum"] = float(mine_ref.grad_accum.abs().max())
        errs["grad_accum"] = float((mine.grad_accum
                                    - mine_ref.grad_accum).abs().max())
        if not errs["grad_accum"] <= DIST_MOMENT_REL * scales["grad_accum"]:
            fail(f"{where}: grad_accum off by {errs['grad_accum']} (max "
                 f"{scales['grad_accum']})")
        for name in ("alive", "denom", "max_radii2d"):
            if not torch.equal(getattr(mine, name), getattr(mine_ref, name)):
                fail(f"{where}: {name} differs")
        renders = DIST_STEPS * int(my_gts.shape[0]) * int(my_gts.shape[1])
        for k in ("decode_cull", "composite_train_fwd", "composite_bwd",
                  "segsum"):
            # (The plain versions of a CPU rehearsal count nothing.)
            if launches[k] != renders and (
                    torch.device(DEVICE).type == "cuda"):
                fail(f"{where}: {k} launched {launches[k]} times in "
                     f"{renders} renders")
        out["meshes"].append(dict(
            mesh=[n_plots, n_views], coords=list(mesh.coords),
            plots_here=int(my_gts.shape[0]), views_here=int(my_gts.shape[1]),
            loss=[float(m["loss"][0]) for m in ms], loss_max_rel=loss_rel,
            max_abs_err=errs, max_abs=scales, seconds_per_step=seconds / DIST_STEPS,
            launches=launches, size=[w, h], alive=int(m["n_alive"][0])))
    return out


def dist_path(scene_dir: str) -> dict:
    """Phase 21: DIST_RANKS processes spawned on this card, each a gloo
    rank with CUDA tensors (dist_rank), every rank joined with its own
    timeout; their launches summed per kernel (each rank reset its
    counters just before its distributed steps)."""
    import torch.multiprocessing as mp

    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    out_dir = os.path.join(WORK, "dist")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    init = "file://" + os.path.join(out_dir, "init")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(r, DIST_RANKS, init,
                                                 out_dir, scene_dir, DEVICE))
             for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    hung = []
    for r, p in enumerate(procs):
        p.join(DIST_JOIN_TIMEOUT)
        if p.is_alive():
            hung.append(r)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        fail(f"distributed phase: ranks {hung} did not finish")
    ranks = []
    for r in range(DIST_RANKS):
        path = os.path.join(out_dir, f"rank{r}.json")
        if not os.path.exists(path):
            fail(f"distributed phase: rank {r} exited "
                 f"{procs[r].exitcode} without a result")
        with open(path) as f:
            res = json.load(f)
        if not res["ok"]:
            fail(f"distributed phase: rank {r}:\n{res['error']}")
        ranks.append(res)
    launches = {k: sum(m["launches"][k] for res in ranks
                       for m in res["meshes"]) for k in CR.launches}
    return dict(seconds=time.perf_counter() - t0, ranks=ranks,
                launches=launches)


def nccl_rank(init: str, out_dir: str, scene_dir: str,
              app_init: str) -> None:
    """Phase 27, the spawned process: rank 0 of a world of one over NCCL
    (init_ranks), then nccl_steps; the process group destroyed; then
    nccl_app with its own group. The result or the traceback into
    out_dir/rank0.json."""
    import traceback

    import torch

    global cuda_time_ms
    sys.path.insert(0, ROOT)
    from wheat3dgs_tpu_torch.parallel import mesh as TM
    from wheat3dgs_tpu_torch.utils.cuda_timing import cuda_time_ms

    t_rank = time.perf_counter()
    try:
        t0 = time.perf_counter()
        ranks = TM.init_ranks("nccl", init, 1, 0)
        res = {"ok": True, "init_seconds": time.perf_counter() - t0,
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "nccl": ".".join(map(str, torch.cuda.nccl.version())),
               **nccl_steps(ranks, scene_dir)}
        torch.distributed.destroy_process_group()
        res["app"] = nccl_app(scene_dir, app_init)
        res["rank_seconds"] = time.perf_counter() - t_rank
    except (Exception, SystemExit):       # fail() exits
        res = {"ok": False, "error": traceback.format_exc()}
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, "rank0.json"), "w") as f:
        json.dump(res, f)


@contextlib.contextmanager
def counting_collectives(counts: dict):
    """Count the calls of the three collectives the meshes issue, by name,
    while entered."""
    from unittest import mock

    import torch.distributed as dist

    with contextlib.ExitStack() as stack:
        for name in ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor"):
            real = getattr(dist, name)

            def counted(*a, _real=real, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*a, **kw)

            stack.enter_context(mock.patch.object(dist, name, counted))
        yield


def card_activities(fn) -> dict:
    """One fn() call under torch.profiler (the card's activities only):
    the activities by name (kernels, copies, sets), the kernels with
    "nccl" in their name and the device copies (a graph's copy nodes are
    named memcpy*)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    card = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            card[e.name] = card.get(e.name, 0) + 1
    copies = {k: n for k, n in card.items() if "memcpy" in k.lower()}
    return dict(
        kernels=sum(n for k, n in card.items()
                    if k not in copies and not k.startswith(("Memset",
                                                             "nccl:"))),
        nccl_kernels={k: n for k, n in card.items()
                      if "nccl" in k.lower() and not k.startswith("nccl:")},
        copies=sum(copies.values()), copy_names=copies, names=card)


def nccl_calls(fn) -> dict:
    """The ProcessGroupNCCL calls ("nccl:<collective>") of one fn() call,
    by name, from torch.profiler's host events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        if e.name.startswith("nccl:"):
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def nccl_steps(ranks, scene_dir: str) -> dict:
    """Phase 27's steps on the NCCL rank: for each trainer, DIST_STEPS
    steps from the bench plot's points3D replayed from a CUDA graph (the
    launch counters reset just before and read just after), the same
    steps under eager_steps() and the one-process steps, every state
    tensor and metric held bit for bit; the graph's captures and replays,
    the collectives a step issues, the card's activities in one profiled
    replay against the one-process step's, and ms a step timed eagerly,
    replayed and in one process."""
    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch import training as TT
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.parallel import mesh as TM
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.training_graph import eager_steps

    t_setup = time.perf_counter()
    dev = ranks.device
    scene = Scene(cfg.ModelParams(source_path=scene_dir), device=dev)
    opt = cfg.OptimizationParams()
    w, h = scene.image_size
    gts_all = torch.as_tensor(scene.data.train.images, device=dev)
    cams_all = scene.cam_stack("train")
    bg = torch.zeros(3, device=dev)
    extent = float(scene.cameras_extent)
    b = MULTI_VIEWS

    def generator():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    def densify(st):
        return G.densify_and_prune(st, opt.densify_grad_threshold, 0.005,
                                   extent, 0.0, opt.percent_dense,
                                   generator=generator())[0]

    def densify_plots(st):
        return TM.stack_states([densify(G.map_tensors(lambda x: x[p], st))
                                for p in range(NCCL_PLOTS)])

    # plot x view: NCCL_PLOTS plots x b views (plot p on train views
    # p * b .. p * b + b - 1); view x gauss: one plot on views 0 .. b - 1.
    idx = torch.arange(NCCL_PLOTS * b, device=dev).reshape(NCCL_PLOTS, b)
    plot_view = dict(
        state=TM.stack_states([G.map_tensors(torch.clone, scene.gaussians)
                               for _ in range(NCCL_PLOTS)]),
        args=(tuple(a[idx] for a in cams_all), gts_all[idx], bg),
        rows=[TT.plot_scalars(it, it, opt, [extent] * NCCL_PLOTS).to(dev)
              for it in range(1, DIST_STEPS + 1)],
        mesh=lambda: TM.make_mesh(1, 1, ranks=ranks),
        build=TM.build_multi_plot_trainer,
        one=lambda: TT.multi_plot_step(3, w, h, opt),
        densify=lambda mesh, st: densify_plots(st),
        densify_one=densify_plots)

    def gauss_densify(mesh, st):
        return TM.densify_gauss(
            mesh, st, grad_threshold=opt.densify_grad_threshold,
            min_opacity=0.005, extent=extent, max_screen_size=0.0,
            percent_dense=opt.percent_dense, generator=generator())[0]

    view_gauss = dict(
        state=G.map_tensors(torch.clone, scene.gaussians),
        args=(tuple(a[:b] for a in cams_all), gts_all[:b], bg),
        rows=[TT.step_scalars(it, it, 1, opt, extent)[0].to(dev)
              for it in range(1, DIST_STEPS + 1)],
        mesh=lambda: TM.make_gauss_mesh(1, 1, ranks=ranks),
        build=TM.build_gauss_sharded_trainer,
        one=lambda: (lambda st, cams, gts, bg_, row: TT.train_step_views(
            st, cams, gts, bg_, row, sh_degree=3, width=w, height=h,
            opt=opt)),
        densify=gauss_densify, densify_one=densify)

    def run(cfg_, mode: str, counts=None):
        """DIST_STEPS steps of the mesh's step (mode "replayed" or
        "eager") or of the one-process step ("one"), the densify and an
        opacity reset after step NCCL_DENSIFY_AFTER; the launches of the
        run (counters reset just before)."""
        mesh = cfg_["mesh"]() if mode != "one" else None
        step = cfg_["one"]() if mode == "one" else cfg_["build"](
            mesh, 3, w, h, opt)
        st = G.map_tensors(torch.clone, cfg_["state"])
        ms = []
        CR.reset_launches()
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            for it, row in enumerate(cfg_["rows"], 1):
                with (counting_collectives(counts) if counts is not None
                      else contextlib.nullcontext()):
                    st, m = step(st, *cfg_["args"], row)
                st.adam.step += 1
                ms.append({k: v.clone() for k, v in m.items()})
                if it == NCCL_DENSIFY_AFTER:
                    st = G.reset_opacity(
                        cfg_["densify_one"](st) if mode == "one"
                        else cfg_["densify"](mesh, st))
        torch.cuda.synchronize()
        return st, ms, dict(CR.launches), step, mesh

    def differ(a, b_) -> list:
        """Where two runs' states or metrics are not bit-identical: (what,
        max |a - b|)."""
        (sa, ma), (sb, mb) = a, b_
        out = []
        for i, (x, y) in enumerate(zip(TT.state_tensors(sa),
                                       TT.state_tensors(sb))):
            if x.shape != y.shape or not torch.equal(x, y):
                out.append((f"state tensor {i}", float(
                    (x.double() - y.double()).abs().max())
                    if x.shape == y.shape else "shape"))
        for j, (x, y) in enumerate(zip(ma, mb)):
            for k in ("loss", "l1", "psnr", "n_alive", "entries_total"):
                if not torch.equal(x[k].reshape(-1).to(y[k].dtype),
                                   y[k].reshape(-1)):
                    out.append((f"step {j + 1} {k}", float(
                        (x[k].double() - y[k].double()).abs().max())))
        return out

    out = {"device": str(dev), "captured": ranks.captured,
           "staged": ranks.staged, "trainers": {},
           "setup_seconds": time.perf_counter() - t_setup}
    launches_path = {}
    for name, cfg_ in (("plot_view", plot_view), ("view_gauss", view_gauss)):
        t0 = time.perf_counter()
        counts = {}
        rs, rms, rl, step, mesh = run(cfg_, "replayed")
        es, ems, el, _, _ = run(cfg_, "eager", counts)
        os_, oms, ol, one, _ = run(cfg_, "one")
        for k, v in rl.items():
            launches_path[k] = launches_path.get(k, 0) + v
        where = f"phase 27 {name}"
        graph = step.graph
        if not (graph.captures >= 2 and graph.replays >= 1):
            fail(f"{where}: {graph.captures} captures, {graph.replays} "
                 "replays")
        for ref, against in (("its eager steps", (es, ems)),
                             ("the one-process step", (os_, oms))):
            bad = differ((rs, rms), against)
            if bad:
                fail(f"{where}: replayed steps differ from {ref}: {bad}")
        if rl != ol or rl != el:
            fail(f"{where}: launches replayed {rl}, eager {el}, one "
                 f"process {ol}")
        per_step = {k: v // DIST_STEPS for k, v in counts.items()}
        # One profiled call of each, from the runs' final states (the key
        # unchanged: a replay), then ms a step in turns.
        def call_r():
            step(rs, *cfg_["args"], cfg_["rows"][-1])

        def call_o():
            one(os_, *cfg_["args"], cfg_["rows"][-1])

        eager_step = cfg_["build"](mesh, 3, w, h, opt)
        st_e = G.map_tensors(torch.clone, rs)

        def call_e():
            with eager_steps():
                eager_step(st_e, *cfg_["args"], cfg_["rows"][-1])

        call_r()
        call_o()
        t1 = time.perf_counter()
        prof_r, prof_o = card_activities(call_r), card_activities(call_o)
        calls_e = nccl_calls(call_e)
        t2 = time.perf_counter()
        # NCCL launches no kernel for a communicator of one rank: an
        # in-place SUM or MAX is nothing and an out-of-place gather or
        # scatter a device copy. So every collective a step issues must
        # reach ProcessGroupNCCL (its nccl:<name> call on the host, eager),
        # and the replay must hold the out-of-place ones' copies beside
        # the one-process step's; a kernel named nccl counts as well.
        out_of_place = (per_step.get("all_gather_into_tensor", 0)
                        + per_step.get("reduce_scatter_tensor", 0))
        if sum(calls_e.values()) != sum(per_step.values()):
            fail(f"{where}: an eager step issued {per_step} but reached "
                 f"ProcessGroupNCCL {calls_e}")
        if (prof_r["copies"] - prof_o["copies"] < out_of_place
                and sum(prof_r["nccl_kernels"].values())
                < sum(per_step.values())):
            fail(f"{where}: the replay holds {prof_r['copies']} copies and "
                 f"NCCL kernels {prof_r['nccl_kernels']} against one "
                 f"process's {prof_o['copies']} copies, for {per_step}")

        times = {"replayed": [], "eager": [], "one_process": []}
        for _ in range(2):
            for k, fn in (("replayed", call_r), ("eager", call_e),
                          ("one_process", call_o)):
                times[k].append(cuda_time_ms(fn, NCCL_TIME_REPS, warmup=1))
        out["trainers"][name] = dict(
            captures=graph.captures, replays=graph.replays,
            capture_seconds=graph.capture_seconds,
            collectives_per_step=per_step,
            eager_nccl_calls=calls_e,
            replay_nccl_kernels=prof_r["nccl_kernels"],
            replay_copies=prof_r["copy_names"],
            replay_kernels=prof_r["kernels"],
            one_process_kernels=prof_o["kernels"],
            one_process_copies=prof_o["copy_names"],
            kernels_only_in_replay={
                k: n - prof_o["names"].get(k, 0)
                for k, n in prof_r["names"].items()
                if n > prof_o["names"].get(k, 0)},
            ms={k: min(v) for k, v in times.items()}, ms_turns=times,
            launches=rl, n_alive=int(rms[-1]["n_alive"].reshape(-1)[0]),
            loss=[float(m["loss"].reshape(-1)[0]) for m in rms],
            seconds=time.perf_counter() - t0, runs_seconds=t1 - t0,
            profile_seconds=t2 - t1, timing_seconds=time.perf_counter() - t2)
        graph.release()
        one_graph = getattr(one, "graph", None)
        if one_graph is not None:
            one_graph.release()
    out["launches"] = launches_path
    return out


def nccl_app(scene_dir: str, init: str) -> dict:
    """Phase 27's app run on the NCCL rank: apps/train_multi over a world
    of one with phase 19's arguments (its own process group), the launch
    counters reset just before; its metrics_multi.jsonl (but each record's
    elapsed_s) and PLYs equal to phase 19's."""
    import filecmp

    from wheat3dgs_tpu_torch.apps import train_multi
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    base = os.path.join(WORK, "nccl_models")
    ref = os.path.join(WORK, "multi_models")
    argv = multi_argv(scene_dir, base) + [
        "--dist_backend", "nccl", "--dist_init", init, "--world_size", "1",
        "--rank", "0"]
    CR.reset_launches()
    t0 = time.perf_counter()
    train_multi.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(CR.launches)

    def log(d):
        with open(os.path.join(d, "metrics_multi.jsonl")) as f:
            return [{k: v for k, v in json.loads(ln).items()
                     if k != "elapsed_s"} for ln in f]

    got, want = log(base), log(ref)
    if got != want:
        fail(f"phase 27: the NCCL app's log {got} against one process's "
             f"{want}")
    plys = []
    for plot in ("scene", "plot_462"):
        rel = os.path.join(plot, "point_cloud", f"iteration_{MULTI_ITERS}",
                           "point_cloud.ply")
        if not filecmp.cmp(os.path.join(base, rel), os.path.join(ref, rel),
                           shallow=False):
            fail(f"phase 27: the NCCL app's {rel} differs from one "
                 "process's")
        plys.append(rel)
    return dict(seconds=seconds, launches=launches, records=len(got),
                last=got[-1], plys_equal=plys)


def nccl_path(scene_dir: str) -> dict:
    """Phase 27: one process spawned on this card, an NCCL rank of a world
    of one (nccl_rank), joined with its timeout; its launches (the
    replayed steps of both trainers and the app run, each with its
    counters reset just before)."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(WORK, "nccl")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = mp.get_context("spawn")
    proc = ctx.Process(target=nccl_rank, args=(
        "file://" + os.path.join(out_dir, "init"), out_dir, scene_dir,
        "file://" + os.path.join(out_dir, "app_init")))
    t0 = time.perf_counter()
    proc.start()
    proc.join(NCCL_JOIN_TIMEOUT)
    if proc.is_alive():
        proc.kill()
        proc.join()
        fail("phase 27: the NCCL rank did not finish")
    path = os.path.join(out_dir, "rank0.json")
    if not os.path.exists(path):
        fail(f"phase 27: the NCCL rank exited {proc.exitcode} without a "
             "result")
    with open(path) as f:
        res = json.load(f)
    if not res["ok"]:
        fail(f"phase 27: the NCCL rank:\n{res['error']}")
    res["steps_launches"] = res.pop("launches")
    launches = {k: n + res["app"]["launches"][k]
                for k, n in res["steps_launches"].items()}
    return dict(seconds=time.perf_counter() - t0, launches=launches, **res)


def _state_copy(st):
    from wheat3dgs_tpu_torch.models import gaussians as G

    return G.state_from_numpy(**G.state_to_numpy(st)._asdict(),
                              device=st.device)


def _off_pixels(got: dict, ref: dict, atol: float, rtol: float):
    """(pixels where any field of `got` is outside atol + rtol * |ref|,
    max abs error over all pixels, over the pixels not off)."""
    import torch

    off, errs = None, []
    for f in ("color", "alpha", "depth"):
        a, b = got[f], ref[f]
        if not bool(torch.isfinite(a).all()):
            fail(f"padded-tile {f} has non-finite values")
        err = (a - b).abs()
        bad = err > atol + rtol * b.abs()
        if bad.dim() == 3:
            bad, err = bad.any(0), err.amax(0)
        off = bad if off is None else off | bad
        errs.append(err)
    err = torch.stack(errs).amax(0)
    return (int(off.sum()), float(err.max()),
            float(torch.where(off, torch.zeros_like(err), err).max()))


def xla_path(scene_dir: str, model_dir: str) -> dict:
    """Phase 22: the padded-tile backend on the card against the kernels,
    the CPU and eager steps (see the module docstring)."""
    import threading

    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.ops.binning import (capped_rect, count_tiles,
                                                 num_tiles, pick_entry_budget)
    from wheat3dgs_tpu_torch.ops.projection import project_gaussians
    from wheat3dgs_tpu_torch.render.pipeline import (RasterConfig,
                                                     adapt_config,
                                                     entry_demand_probe,
                                                     render_fwd, zero_colors)
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.training import (LAST_METRICS, Trainer,
                                              step_scalars, to_device,
                                              train_step)
    from wheat3dgs_tpu_torch.training_graph import eager_steps

    t_start = time.perf_counter()
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    if tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the padded-tile "
             "path's matmuls must be float32")
    scene = Scene(cfg.ModelParams(source_path=scene_dir,
                                  model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    st = scene.gaussians
    w, h = scene.image_size
    deg = scene.sh_degree
    cam = scene.cam_arrays("train", 0)
    peak = {}

    def mark():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def peak_gib(part):
        torch.cuda.synchronize()
        peak[part] = torch.cuda.max_memory_allocated() / 2 ** 30

    # (a) the view's uncapped maxima at XLA_TILE: nothing cropped.
    with torch.no_grad():
        splats = project_gaussians(
            st.params.means, st.scales(), st.params.quats, st.opacity(),
            *cam, w, h, colors=zero_colors(st))
        tiles_x, tiles_y = num_tiles(w, h, XLA_TILE)
        _, _, sx, sy, _ = capped_rect(splats, tiles_x, tiles_y, XLA_TILE,
                                      1 << 30)
        mtpg = int(torch.where(splats.radius > 0, sx * sy,
                               torch.zeros_like(sx)).max())
        counts = count_tiles(splats, w, h, XLA_TILE, mtpg)
        mpt = int(counts.max())
    del splats
    batch = max(1, XLA_BATCH_ELEMS // (XLA_TILE * XLA_TILE * mpt))
    xconf = RasterConfig(tile=XLA_TILE, max_tiles_per_gauss=mtpg,
                         max_per_tile=mpt, tile_batch=batch, backend="xla")
    kconf = adapt_config(st, cam, w, h)
    mark()
    out_x = render_fwd(st, *cam, w, h, deg, config=xconf)
    peak_gib("render_fwd_xla")
    out_k = render_fwd(st, *cam, w, h, deg, config=kconf)
    if int(out_k.entries_total) > kconf.entry_budget:
        fail("phase 22: the kernels' render overflowed its probed budget")
    off_a, err_a, err_a_on = _off_pixels(out_x._asdict(), out_k._asdict(),
                                         COMPOSITE_ATOL, COMPOSITE_RTOL)
    if off_a > STOP_MISMATCH_MAX * w * h:
        fail(f"phase 22 (a): the padded-tile render differs from the "
             f"kernels' on {off_a} pixels (max abs err {err_a})")
    full = dict(tile=XLA_TILE, max_tiles_per_gauss=mtpg, max_per_tile=mpt,
                tile_batch=batch, tiles=tiles_x * tiles_y,
                entries=int(counts.sum()), entry_budget=kconf.entry_budget,
                pixels_off=off_a, max_abs_err=err_a,
                max_abs_err_on_pixels=err_a_on,
                tolerance={"atol": COMPOSITE_ATOL, "rtol": COMPOSITE_RTOL})
    del out_x, out_k

    # (b) JAX's defaults at a quarter of the size, card against CPU. The
    # CPU's render runs in a thread beside (c) and (d).
    hw, hh = w // XLA_CPU_SHRINK, h // XLA_CPU_SHRINK
    hconf = adapt_config(st, cam, hw, hh, RasterConfig(backend="xla"))
    out_g = render_fwd(st, *cam, hw, hh, deg, config=hconf)
    card = {k: getattr(out_g, k).cpu() for k in ("color", "alpha", "depth")}
    del out_g
    st_cpu = G.map_tensors(lambda x: x.cpu(), st)
    cam_cpu = tuple(c.cpu() if torch.is_tensor(c) else c for c in cam)
    on_cpu = {}

    def cpu_render():
        t0 = time.perf_counter()
        try:
            on_cpu["out"] = render_fwd(st_cpu, *cam_cpu, hw, hh, deg,
                                       config=hconf)._asdict()
        except Exception as exc:       # reported after the join
            on_cpu["error"] = repr(exc)
        on_cpu["seconds"] = time.perf_counter() - t0

    cpu_thread = threading.Thread(target=cpu_render, daemon=True)
    cpu_thread.start()

    # (c) one train_step on each backend from the same state.
    if st.adam.step != 0:
        fail("phase 22 (c): the stand-in model's Adam state is not fresh")
    opt = cfg.OptimizationParams()
    gt = scene.gt_image("train", 0)
    bg = torch.zeros(3, device=DEVICE)
    budget = pick_entry_budget(int(entry_demand_probe(
        st, *cam, width=w, height=h)))
    tconf = RasterConfig(entry_budget=budget)
    row = to_device(step_scalars(1, 1, 1, opt, scene.cameras_extent),
                    st.device)[0]

    def step(config):
        s = _state_copy(st)
        s, m = train_step(s, cam, gt, bg, row, sh_degree=deg, width=w,
                          height=h, opt=opt, config=config)
        return s, m

    mark()
    sx_, mx = step(xconf)
    peak_gib("train_step_xla")
    sk, mk = step(tconf)
    loss_rel = abs(float(mx["loss"]) - float(mk["loss"])) / abs(
        float(mk["loss"]))
    if loss_rel > 1e-4:
        fail(f"phase 22 (c): loss {float(mx['loss'])} against the kernels' "
             f"{float(mk['loss'])}")
    if int(mx["entries_total"]) != -1:
        fail("phase 22 (c): the padded-tile step reported entries_total")
    grad_rel = {}
    for f in G.PARAM_FIELDS:
        ref = sk.adam.mu[f]
        top = float(ref.abs().max())
        grad_rel[f] = (float((sx_.adam.mu[f] - ref).abs().max()) / top
                       if top > 0 else 0.0)
        if grad_rel[f] > GRAD_REL:
            fail(f"phase 22 (c): gradient of {f} {grad_rel[f]} of its max "
                 f"(bound {GRAD_REL})")
    acc_rel = float((sx_.grad_accum - sk.grad_accum).abs().max()) / max(
        float(sk.grad_accum.abs().max()), 1e-30)
    train = dict(loss=[float(mx["loss"]), float(mk["loss"])],
                 loss_rel_err=loss_rel, grad_rel_of_max=grad_rel,
                 grad_accum_rel_of_max=acc_rel, entry_budget=budget)
    del sx_, sk

    # (d) a replayed block against eager steps.
    gts = torch.as_tensor(scene.data.train.images, device=DEVICE)
    stacks = scene.cam_stack("train")
    vis = [0, 3, 1][:XLA_BLOCK]

    def block():
        tr = Trainer(_state_copy(st), opt, scene.cameras_extent, deg,
                     config=xconf, adaptive_occupancy=False)
        tr.active_sh_degree = deg
        m = tr.step_block(1, vis, stacks, gts, w, h, n_steps=XLA_BLOCK)
        return tr, m

    mark()
    graphed, mg = block()
    peak_gib("step_block_xla")
    eager = []
    with eager_steps():
        for _ in range(2):
            eager.append(block())
    torch.cuda.synchronize()

    def diff(a, ma, b, mb):
        out = {}
        for f in G.PARAM_FIELDS:
            out[f] = getattr(a.state.params, f) - getattr(b.state.params, f)
            out["mu." + f] = a.state.adam.mu[f] - b.state.adam.mu[f]
            out["nu." + f] = a.state.adam.nu[f] - b.state.adam.nu[f]
        for f in G.STAT_FIELDS:
            out[f] = getattr(a.state, f) - getattr(b.state, f)
        for k in LAST_METRICS:
            out[k] = (ma[k] - mb[k]).double()
        return {k: float(v.abs().max()) for k, v in out.items()}

    (e1, m1), (e2, m2) = eager
    graph_eager = diff(graphed, mg, e1, m1)
    eager_eager = diff(e1, m1, e2, m2)
    bad = {k: (graph_eager[k], eager_eager[k]) for k in graph_eager
           if graph_eager[k] > XLA_SPREAD_FACTOR * eager_eager[k]}
    if bad:
        fail(f"phase 22 (d): replayed block beyond the eager spread: {bad}")
    if int(mg["entries_total"]) != -1:
        fail("phase 22 (d): the padded-tile block reported entries_total")
    blk = dict(steps=XLA_BLOCK, views=vis,
               bit_identical=not any(graph_eager.values()),
               eager_runs_bit_identical=not any(eager_eager.values()),
               max_abs_graph_vs_eager=max(graph_eager.values()),
               max_abs_eager_vs_eager=max(eager_eager.values()),
               captures=graphed.graph.captures,
               replays=graphed.graph.replays,
               capture_seconds=graphed.graph.capture_seconds)
    del graphed, eager, e1, e2

    cpu_thread.join()
    if "error" in on_cpu:
        fail(f"phase 22 (b): the CPU render raised {on_cpu['error']}")
    off_b, err_b, err_b_on = _off_pixels(card, on_cpu["out"], XLA_CPU_ATOL,
                                         0.0)
    if off_b > STOP_MISMATCH_MAX * hw * hh:
        fail(f"phase 22 (b): card and CPU differ on {off_b} pixels (max abs"
             f" err {err_b})")
    vs_cpu = dict(size=[hw, hh], tile=hconf.tile,
                  max_tiles_per_gauss=hconf.max_tiles_per_gauss,
                  max_per_tile=hconf.max_per_tile,
                  tile_batch=hconf.tile_batch, pixels_off=off_b,
                  max_abs_err=err_b, max_abs_err_on_pixels=err_b_on,
                  atol=XLA_CPU_ATOL, cpu_seconds=on_cpu["seconds"])
    del st_cpu, on_cpu, card

    # (e) times on the card, each backend.
    s = _state_copy(st)

    def t_step(config):
        return cuda_time_ms(lambda: train_step(
            s, cam, gt, bg, row, sh_degree=deg, width=w, height=h, opt=opt,
            config=config), 2, warmup=1)

    times = dict(
        render_fwd_xla_ms=cuda_time_ms(lambda: render_fwd(
            st, *cam, w, h, deg, config=xconf), 2, warmup=1),
        render_fwd_kernels_ms=cuda_time_ms(lambda: render_fwd(
            st, *cam, w, h, deg, config=kconf), 5),
        train_step_xla_ms=t_step(xconf),
        train_step_kernels_ms=t_step(tconf))
    return dict(seconds=time.perf_counter() - t_start, full=full,
                vs_cpu=vs_cpu, train_step=train, block=blk, times=times,
                peak_memory_gib=peak, allow_tf32=tf32, capacity=st.capacity)


def reference_scene() -> dict:
    """Phase 23: exp_bench2's ground-truth scene built on the card with the
    generator's _build_gt_scene (no files) as each of REFERENCE_GTS, its
    REFERENCE_CAMS rendered through render_fwd as the generator renders
    them and quantized as it writes them, each held to JAX's saved render
    of that camera by texture (mean horizontal step, mean 8x8 block std)
    and PSNR. Fails unless, on every camera, both statistics of the 0.05
    scene are nearer JAX's render than those of the 0.15 scene, and the
    0.05 scene sized by JAX's TPU kNN has a higher PSNR against it than
    the one sized by the exact kNN."""
    import numpy as np
    import torch
    from PIL import Image

    from wheat3dgs_tpu_torch.io import synthetic as SY
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.render.pipeline import render_fwd
    from wheat3dgs_tpu_torch.utils import image_stats as S

    t_start = time.perf_counter()
    jax = {cam: S.unit(np.asarray(Image.open(os.path.join(
        ROOT, "docs", "quality", f"{k:05d}.png")).convert("RGB")))
        for k, cam in enumerate(REFERENCE_CAMS)}
    r = REFERENCE_SCENE
    w, h = r["width"], r["height"]
    gts, demand, builds = {}, {}, {}
    CR.reset_launches()
    for name, (noise, knn) in REFERENCE_GTS.items():
        t0 = time.perf_counter()
        (_, params, colors, _, state, _, args, _,
         config) = SY._build_gt_scene(
            w, h, r["n_cams"], r["n_heads"], r["pts_per_head"],
            r["ground_pts"], r["seed"], DEVICE, 2.2, 40.0, None,
            color_noise=noise, knn=knn)
        colors_cap = torch.zeros((state.capacity, 3), device=DEVICE)
        colors_cap[:len(colors)] = torch.as_tensor(colors, device=DEVICE)
        for cam in REFERENCE_CAMS:
            out = render_fwd(state, *args[cam], w, h, sh_degree=0,
                             override_color=colors_cap, config=config)
            if int(out.entries_total) > config.entry_budget:
                fail(f"reference scene {name}, camera {cam}: demand "
                     f"{int(out.entries_total)} over budget "
                     f"{config.entry_budget}")
            gts[name, cam] = S.as_png(
                out.color.cpu().numpy().transpose(1, 2, 0))
            demand[name, cam] = int(out.entries_total)
        torch.cuda.synchronize()
        floor = params["log_scales"][:, 0] <= np.log(1e-4) + 1e-6
        builds[name] = dict(seconds=time.perf_counter() - t0,
                            color_noise=noise, knn=knn, splats=len(colors),
                            capacity=state.capacity,
                            entry_budget=config.entry_budget,
                            scale_floor_share=float(floor.mean()),
                            median_scale=float(np.exp(np.median(
                                params["log_scales"][:, 0]))))
        del state, args, colors_cap
    launches = dict(CR.launches)
    for k in ("decode_cull", "composite_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the reference scene")
    cams = []
    for cam in REFERENCE_CAMS:
        ref = S.texture(jax[cam])
        row = {"camera": cam, "jax": ref}
        for name in REFERENCE_GTS:
            row[name] = dict(S.texture(gts[name, cam]),
                             psnr_jax_render=S.psnr(jax[cam], gts[name, cam]),
                             entries=demand[name, cam])
        lo, hi, tpu = (row[x] for x in REFERENCE_GTS)
        for k in ("h_step", "block_std"):
            if not abs(lo[k] - ref[k]) < abs(hi[k] - ref[k]):
                fail(f"camera {cam}: the {k} of JAX's render ({ref[k]:.5f})"
                     f" is not nearer the 0.05 scene's ({lo[k]:.5f}) than "
                     f"the 0.15 scene's ({hi[k]:.5f})")
        if not tpu["psnr_jax_render"] > lo["psnr_jax_render"]:
            fail(f"camera {cam}: JAX's render is not nearer the 0.05 scene "
                 f"sized by the TPU kNN ({tpu['psnr_jax_render']:.2f} dB) "
                 f"than by the exact one ({lo['psnr_jax_render']:.2f} dB)")
        cams.append(row)
    return dict(seconds=time.perf_counter() - t_start, builds=builds,
                launches=launches, cameras=cams)


def check_probe() -> dict:
    """Phase 16: the scan probe's kinds against the plain version, at the
    cluster's edges, repeated and at 0 steps; timed at 256 and 64 steps
    beside the torch.cumsum loop (eager and as a CUDA graph); then
    apps/prof_scan with the launch counters read around it."""
    import numpy as np
    import torch

    from wheat3dgs_tpu_torch.apps import prof_scan
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops import scan_probe as SP
    from wheat3dgs_tpu_torch.utils.cuda_timing import graphed

    p, c, steps = prof_scan.P, prof_scan.C, prof_scan.STEPS
    short, edge_steps = 64, 17
    rng = np.random.default_rng(0)

    def normal(rows):
        return torch.as_tensor(rng.normal(size=(rows, c)).astype(np.float32),
                               device=DEVICE)

    inputs = {"ones": torch.full((p, c), 0.001, device=DEVICE),
              "normal": normal(p)}
    # Fewer rows than the cluster's CTAs, and rows that are no multiple of
    # them; the probe's 1024 rows are the most one cluster holds.
    edges = {"rows_8": normal(8), "rows_1000": normal(1000)}
    if p != SP.MAX_ROWS:
        fail(f"the probe's {p} rows are not the cluster's {SP.MAX_ROWS}")
    try:
        SP.scan_probe(normal(SP.MAX_ROWS + 1), "cumsum", 1)
        fail(f"scan_probe took {SP.MAX_ROWS + 1} rows")
    except ValueError:
        pass

    def check(kind, name, x, n):
        got = SP.scan_probe(x, kind, n)
        ref = SP.scan_probe_plain(x, kind, n)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not bool(torch.isfinite(got).all()) or rel > PROBE_REL:
            fail(f"scan_probe {kind} on {name} ({tuple(x.shape)}, {n} "
                 f"steps): {rel} of the max (bound {PROBE_REL})")
        return got, err

    # Every kind computes one function: a row prefix sum (one add per
    # value), then |s|, the max and the scale, so one bound holds for all
    # of them. algorithm_ops is what each kind's own algorithm does.
    func_ops = 1 + 3
    algorithm_ops = {"matmul": 2 * c, "cumsum": 1, "roll": 7}
    kinds = {}
    for kind in SP.KINDS:
        errs = {}
        for name, x in inputs.items():
            got, errs[name] = check(kind, name, x, steps)
        for name, x in edges.items():
            _, errs[name] = check(kind, name, x, edge_steps)
        check_repeatable(f"scan_probe {kind}", SP.scan_probe,
                         (inputs["normal"], kind, steps))
        if not torch.equal(SP.scan_probe(got, kind, 0), got):
            fail(f"scan_probe {kind} with 0 steps changed its input")
        x = inputs["ones"]
        r = dict(ms=cuda_time_ms(lambda: SP.scan_probe(x, kind, steps), 10),
                 ms_64_steps=cuda_time_ms(
                     lambda: SP.scan_probe(x, kind, short), 10),
                 plain_ms=cuda_time_ms(
                     lambda: SP.scan_probe_plain(x, kind, steps), 2,
                     warmup=1),
                 max_abs_err=max(errs.values()), max_abs_err_by_input=errs,
                 repeat_bit_equal=True, steps_0_identity=True)
        r["us_per_scan"] = r["ms"] * 1e3 / steps
        r["us_per_step"] = (r["ms"] - r["ms_64_steps"]) * 1e3 / (steps
                                                                 - short)
        r["bound_ms"], r["bound_by"] = bound(2 * p * c * 4,
                                             p * c * steps * func_ops)
        r["algorithm_ops"] = p * c * steps * (algorithm_ops[kind] + 3)
        kinds[kind] = r
    def loop():
        return prof_scan.cumsum_loop(inputs["ones"], steps)

    library_eager_ms = cuda_time_ms(loop, 3)
    library_ms = cuda_time_ms(graphed(loop), 10)
    CR.reset_launches()
    t0 = time.perf_counter()
    app = prof_scan.main([])
    seconds = time.perf_counter() - t0
    launches = CR.launches["scan_probe"]
    if launches <= 0:
        fail("the scan probe kernel was not launched by apps/prof_scan")
    return dict(kinds=kinds, cluster=SP.cluster_size(),
                max_rows=SP.MAX_ROWS, library_ms=library_ms,
                library_eager_ms=library_eager_ms,
                library_us_per_scan=library_ms * 1e3 / steps,
                app_us_per_scan=app, seconds=seconds,
                launches={"scan_probe": launches},
                shape={"rows": p, "lanes": c, "steps": steps,
                       "short_steps": short, "edge_rows": [8, 1000],
                       "edge_steps": edge_steps})


def _load_script(name: str):
    """One of the port's scripts (wheat3dgs_tpu_torch/scripts/ has no
    package), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"smoke_{name}", os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts",
                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def envelope_chain_start() -> dict:
    """Phase 24's first part: the scene synthesized in this process with
    the launch counters reset just before, then the chain's processes
    started in a thread (chain_runs); envelope_chain() takes what this
    returns, waits for them and checks the chain."""
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR

    env_mod = _load_script("exp_seg_envelope")
    scene_dir = os.path.join(WORK, "chain_scene")
    model_dir = os.path.join(WORK, "chain_model")
    env = dict(CHAIN_ENV, SEG_SCENE=scene_dir, SEG_MODEL=model_dir,
               DEVICE=DEVICE, SMOKE_SHIM=os.path.join(step_runner(),
                                                      "python"),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    s = env_mod.settings(env)
    num = env_mod.numerics(s)
    CR.reset_launches()
    t0 = time.perf_counter()
    env_mod.synthesize(s, DEVICE)
    synth_seconds = time.perf_counter() - t0
    synth_launches = dict(CR.launches)
    first = env_mod.train_cmd(scene_dir, model_dir, CHAIN_SAVES[0], DEVICE,
                              num)
    return dict(scene_dir=scene_dir, model_dir=model_dir,
                synth_seconds=synth_seconds, synth_launches=synth_launches,
                runs=beside(chain_runs, env, first, model_dir))


def chain_runs(env: dict, first: list, model_dir: str) -> dict:
    """Phase 24's processes: training to CHAIN_SAVES[0] through
    tpu_numerics.py, exp_round5_final.sh to CHAIN_SAVES[1], then the diag
    over both saves; each run as run_logged reports it, and their
    seconds together."""
    t0 = time.perf_counter()
    leg = run_logged(["python", *first[1:]], env, "chain_leg1.log")
    chain = run_logged(
        ["bash", os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts",
                              "exp_round5_final.sh")],
        dict(env, ITERS=str(CHAIN_SAVES[1])), "chain.log")
    diag = run_logged(
        ["python", os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts",
                                "diag_psnr_decline.py"), "-m", model_dir,
         "--iterations", *map(str, CHAIN_SAVES), "--device", DEVICE],
        env, "chain_diag.log")
    return dict(leg=leg, chain=chain, diag=diag,
                seconds=time.perf_counter() - t0)


def envelope_chain(started: dict) -> dict:
    """Phase 24: the envelope chain on the card at CHAIN_ENV. The scene
    synthesized in this process (exp_seg_envelope.synthesize, the TPU kNN's
    ground truth), training to CHAIN_SAVES[0] through tpu_numerics.py
    (--tpu_knn --bf16_grads --seed), exp_round5_final.sh with ITERS =
    CHAIN_SAVES[1] (training resumes from the first leg's checkpoint), then
    diag_psnr_decline.py over both saves, every `python` through
    STEP_RUNNER (envelope_chain_start, which resets the launch counters of
    this process just before the synthesis, and chain_runs): each command
    exits 0, the envelope report has JAX's keys, its note the
    numerics, and n_discovered >= 1, morph_compare.json has n_pairs, the
    360 videos and the traits are written, the diag prints a row of both
    splits for each save at demand / budget <= 1, and each of the path's
    kernels is launched. Then, apart from the count, one lift of the
    chain's model under tpu_numerics.bf16_grads: every segsum input it
    passes is bfloat16-exact (and without it, not)."""
    import ast
    from unittest import mock

    import numpy as np
    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.render.pipeline import adapt_config
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.seg import flashsplat
    from wheat3dgs_tpu_torch.utils import image_ops

    runs = started["runs"]()
    t_end = time.perf_counter()
    numerics = _load_script("tpu_numerics")
    scene_dir, model_dir = started["scene_dir"], started["model_dir"]
    synth_launches = started["synth_launches"]
    leg, chain, diag = runs["leg"], runs["chain"], runs["diag"]
    launches = {k: synth_launches[k] + leg["launches"][k]
                + chain["launches"][k] + diag["launches"][k]
                for k in CR.launches}
    for k in CR.KERNELS:
        if launches[k] <= 0:
            fail(f"phase 24: kernel {k} was not launched on the chain")
    # The chain's step 1 scores before any segmentation exists and exits
    # non-zero, as the JAX chain's does (`|| true`); every other step 0.
    steps = leg["steps"] + chain["steps"] + diag["steps"]
    if any(st["exit"] != 0 and not st["step"].endswith(
            "exp_seg_envelope.py --skip_seg") for st in steps):
        fail(f"phase 24: steps exited "
             f"{[(st['step'], st['exit']) for st in steps]}")

    exp_dir = os.path.join(model_dir, "wheat-head", "envelope")
    with open(os.path.join(exp_dir, "envelope_report.json")) as f:
        report = json.load(f)
    if list(report) != ENVELOPE_KEYS or report["n_discovered"] < 1 \
            or "tpu_numerics" not in (report["note"] or ""):
        fail(f"phase 24: envelope report {list(report)}, n_discovered "
             f"{report.get('n_discovered')}, note {report.get('note')}")
    with open(os.path.join(exp_dir, "morph_compare.json")) as f:
        morph = json.load(f)
    if "n_pairs" not in morph:
        fail(f"phase 24: morph_compare.json lacks n_pairs: {list(morph)}")
    videos = sorted(os.listdir(os.path.join(exp_dir, "wheat_head_360")))
    traits = [f for f in os.listdir(os.path.join(
        exp_dir, "morph_envelope_results")) if f.endswith("_traits.xlsx")]
    if not os.path.exists(os.path.join(exp_dir, "wheat_field_360.mp4")) \
            or not videos or len(traits) != 1:
        fail(f"phase 24: {len(videos)} head videos, {len(traits)} traits "
             "workbooks, field video "
             f"{os.path.exists(os.path.join(exp_dir, 'wheat_field_360.mp4'))}")
    rows = [ast.literal_eval(ln) for ln in open(os.path.join(
        WORK, "chain_diag.log")) if ln.startswith("{'iteration'")]
    if [r["iteration"] for r in rows] != list(CHAIN_SAVES) or any(
            not np.isfinite(r[f"{sp}_psnr"])
            or r[f"{sp}_demand_over_budget"] > 1.0
            for r in rows for sp in ("train", "test")):
        fail(f"phase 24: diag rows {rows}")

    # One lift of the chain's model, its segsum inputs recorded.
    scene = Scene(cfg.ModelParams(source_path=scene_dir,
                                  model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    config = adapt_config(scene.gaussians, cams[0], w, h, cams=cams)
    paths = scene.data.train.metas[0].mask_paths or []
    planes = [image_ops.read_mask(p, (w, h)) for p in paths[:7]]
    planes.append(np.ones((h, w), bool))
    planes += [np.zeros((h, w), bool)] * (8 - len(planes))
    bits8 = torch.as_tensor(np.stack([np.packbits(r, axis=None)
                                      for r in planes]), device=DEVICE)
    segsum = CR.segsum
    exact = {}
    for rounded in (True, False):
        seen = []

        def recording(vals, start, end):
            seen.append(bool(torch.equal(
                vals, vals.to(torch.bfloat16).float())))
            return segsum(vals, start, end)

        with mock.patch.object(CR, "segsum", recording), (
                numerics.bf16_grads() if rounded
                else contextlib.nullcontext()):
            flashsplat.lift_batch8(scene.gaussians, *cams[0], bits8,
                                   width=w, height=h, config=config)
        exact[rounded] = seen
    if not exact[True] or not all(exact[True]) or all(exact[False]):
        fail(f"phase 24: segsum inputs bfloat16-exact under bf16_grads "
             f"{exact[True]}, without {exact[False]}")
    # Its seconds: the synthesis, the processes and this part (the
    # processes ran beside other phases).
    return dict(seconds=started["synth_seconds"] + runs["seconds"]
                + time.perf_counter() - t_end,
                synth_seconds=started["synth_seconds"],
                leg_seconds=leg["seconds"],
                chain_seconds=chain["seconds"],
                diag_seconds=diag["seconds"], launches=launches,
                steps=[(st["step"], round(st["seconds"], 2), st["exit"])
                       for st in steps],
                report={k: v for k, v in report.items() if k != "per_head"},
                morph={k: v for k, v in morph.items() if k != "rows"},
                diag=rows, head_videos=len(videos),
                splats=int(scene.gaussians.num_alive),
                lift_segsum_bf16_exact=exact)


def ptxas_report(log: str) -> dict:
    """nvcc's -Xptxas -v report per kernel instantiation: {(kernel, value
    rows, flag): {"registers", "spill_stores", "spill_loads"}} for the
    entry functions whose mangled names carry `<int, bool>` arguments
    (composite_bwd_kernel<NV, BF16>)."""
    import re

    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(\w{3}_kernel)"
                      r"ILi(\d+)ELb([01])E", ln)
        if m:
            key = (m.group(1), int(m.group(2)), bool(int(m.group(3))))
            out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def bf16_replay_path(scene_dir: str, model_dir: str) -> dict:
    """Phase 25: composite_bwd's BF16 build (cuda_raster's bf16_ops, what
    tpu_numerics.bf16_replay() turns on) on train view 0 of the stand-in
    model. At 4 value rows (under the L1 + SSIM loss, as phase 6, on the
    BF16_BG background) and at the lift's 9 (the label planes as the
    cotangent, as phase 9): the flagged kernel against the flagged plain
    replay within BWD_REL of each column's max and, in relative L2, within
    BF16_SHARE of the distance from the flagged plain replay to each of
    the wrongly rounded plain replays that this shape exercises (the
    unflagged one; with the weight-sum row's cotangent rounded too; with
    A from bfloat16-rounded image rows), all three exercised at 4 rows;
    bit-identical over two launches, its rows different from the default
    build's (the flag is live), timed beside the default build in turns;
    every BF16 instantiation's ptxas line without spills. Under
    the patch, the end-to-end parameter gradients of the kernel path within
    GRAD_REL of the all-plain path's, and a Trainer built inside the patch
    running a block replayed from a CUDA graph, with the counters reset
    just before and read just after: the BF16 build launched once a step,
    the default build never."""
    import dataclasses

    import numpy as np
    import torch

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.models.gaussians import GaussianParams
    from wheat3dgs_tpu_torch.ops import cuda_build
    from wheat3dgs_tpu_torch.ops import cuda_raster as CR
    from wheat3dgs_tpu_torch.ops.binning import pick_entry_budget
    from wheat3dgs_tpu_torch.ops.losses import photometric_loss
    from wheat3dgs_tpu_torch.render.pipeline import (RasterConfig,
                                                     adapt_config,
                                                     entry_demand_probe,
                                                     render)
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.training import Trainer
    from wheat3dgs_tpu_torch.utils import image_ops

    t_start = time.perf_counter()
    numerics = _load_script("tpu_numerics")
    report = ptxas_report((cuda_build.BUILD_DIR
                           / "composite_bwd.log").read_text())
    flagged = {f"NV={k[1]}": v for k, v in sorted(report.items()) if k[2]}
    if len(flagged) != 10 or any(
            r.get("spill_stores", 1) or r.get("spill_loads", 1)
            for r in flagged.values()):
        fail(f"composite_bwd's BF16 build: ptxas {flagged}")
    default = {f"NV={k[1]}": v for k, v in sorted(report.items())
               if not k[2]}

    scene = Scene(cfg.ModelParams(source_path=scene_dir,
                                  model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    st = scene.gaussians
    w, h = scene.image_size
    cams = [scene.cam_arrays("train", i)
            for i in range(len(scene.data.train))]
    cam = cams[0]
    gt = scene.gt_image("train", 0)
    bg = torch.tensor(BF16_BG, device=DEVICE)

    def replay_args(colors, budget):
        """composite_bwd's inputs on train view 0 (view_stream and the
        kernels' forward) and the plan."""
        plan, alive, skeys, starts, ends, perm, feat = view_stream(
            scene, cam, budget, colors)
        with torch.no_grad():
            img, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                               plan.rank_bits, w, h)
        return plan, int(alive), (skeys, perm, starts, ends, feat, img,
                                  stop)

    # 4 rows: the training loss's cotangent at the trainer's budget.
    budget = pick_entry_budget(int(entry_demand_probe(st, *cam, width=w,
                                                      height=h)))
    plan4, alive4, a4 = replay_args(None, budget)
    img_v = a4[5].detach().requires_grad_(True)
    color = img_v[2:5] + (1.0 - img_v[0])[None] * bg[:, None, None]
    grad4 = torch.autograd.grad(photometric_loss(color, gt),
                                img_v)[0].contiguous()
    # 9 rows: the lift's first batch of view 0, as phase 9.
    config9 = adapt_config(st, cam, w, h, cams=cams)
    paths = scene.data.train.metas[0].mask_paths or []
    planes = [image_ops.read_mask(p, (w, h)) for p in paths[:7]]
    planes.append(np.ones((h, w), bool))
    planes += [np.zeros((h, w), bool)] * (8 - len(planes))
    plan9, alive9, a9 = replay_args(
        torch.zeros((st.capacity, 8), device=DEVICE), config9.entry_budget)
    grad9 = torch.zeros_like(a9[5])
    grad9[2:] = torch.as_tensor(np.stack(planes), dtype=torch.float32,
                                device=DEVICE)

    shapes = []
    for plan, alive, args, grad in ((plan4, alive4, a4, grad4),
                                    (plan9, alive9, a9, grad9)):
        bargs = args + (grad, plan.rank_bits, w, h)
        nv = args[4].shape[1] - 6
        where = f"composite_bwd (bf16 replay) at nv={nv}"
        rows_k = check_repeatable(
            where, lambda *a: CR.composite_bwd(*a, bf16_ops=True), bargs)
        rows_p, plain_ms = timed_once(
            lambda: CR.composite_bwd_plain(*bargs, bf16_ops=True))
        col_max = rows_p.abs().amax(dim=0).clamp(min=1e-30)
        rel = float(((rows_k - rows_p).abs() / col_max).max())
        if not bool(torch.isfinite(rows_k).all()) or rel > BWD_REL:
            fail(f"{where} differs from the flagged plain replay: {rel} of "
                 f"the column max (bound {BWD_REL})")

        def rel_l2(a):
            return float((a - rows_p).norm() / rows_p.norm())

        # Plain replays that round other terms than JAX's TPU does.
        g0_rounded = grad.clone()
        g0_rounded[0] = CR.bf16_round(grad[0])
        wrong = {
            "unflagged": rel_l2(CR.composite_bwd_plain(*bargs)),
            "weight_sum_cotangent_rounded": rel_l2(CR.composite_bwd_plain(
                *args[:7], g0_rounded, *bargs[8:], bf16_ops=True)),
            "A_from_rounded_image": rel_l2(CR.composite_bwd_plain(
                *args[:5], CR.bf16_round(args[5]), *bargs[6:],
                bf16_ops=True))}
        exercised = {k: v for k, v in wrong.items() if v > 0}
        sound = rel_l2(rows_k)
        share_bound = BF16_SHARE * min(exercised.values(), default=0.0)
        if (nv == 4 and len(exercised) != len(wrong)) \
                or "unflagged" not in exercised or sound > share_bound:
            fail(f"{where}: {sound} (relative L2) from the flagged plain "
                 f"replay, bound {share_bound} ({BF16_SHARE} of the nearest"
                 f" wrongly rounded replay's distance, {wrong})")
        rows_d = CR.composite_bwd(*bargs)
        changed = int((rows_d != rows_k).sum())
        if changed == 0:
            fail(f"{where}: the rows equal the default build's")
        ms, ms_default = [], []
        for turn in ("default", "bf16", "bf16", "default"):
            (ms if turn == "bf16" else ms_default).append(cuda_time_ms(
                lambda: CR.composite_bwd(*bargs, bf16_ops=turn == "bf16"),
                20))
        e = args[0].shape[0]
        cols = 6 + nv
        stop = args[6]
        ty = torch.arange(h, device=DEVICE)[:, None] // CR.TILE_PX
        tx = torch.arange(w, device=DEVICE)[None, :] // CR.TILE_PX
        visited = int((stop.long() - args[2][ty * plan.tiles_x + tx]).sum())
        _, (_, weighted) = CR.composite_fwd_plain(
            args[0], args[2], args[3], args[4], plan.rank_bits, w, h,
            with_counts=True)
        b_ms, b_by = bound(
            alive * 16 + plan.t_total * 8 + args[4].numel() * 4
            + (2 * (1 + nv) * 4 + 4) * w * h + e * cols * 4,
            visited * 14 + weighted * (36 + 4 * nv))
        shapes.append(dict(
            value_rows=nv, ms=sum(ms) / 2, default_ms=sum(ms_default) / 2,
            plain_ms=plain_ms, max_abs_err=float((rows_k - rows_p).abs()
                                                 .max()),
            max_rel_err_of_column_max=rel, bound_rel=BWD_REL,
            rel_l2=sound, rel_l2_bound=share_bound,
            wrongly_rounded_rel_l2=wrong,
            repeat_bit_equal=True, values_differing_from_default=changed,
            max_rel_change_of_column_max=float(
                ((rows_k - rows_d).abs() / col_max).max()),
            bound_ms=b_ms, bound_by=b_by,
            shape={"slots": e, "entries": alive, "columns": cols,
                   "visited_pairs": visited, "weighted_pairs": weighted}))

    # End to end under the patch: kernels against the all-plain path.
    def leaf_grads():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in st.params.as_dict().items()}
        view = dataclasses.replace(st, params=GaussianParams(**leaves))
        out = render(view, *cam, w, h, scene.sh_degree, bg=bg,
                     config=RasterConfig(entry_budget=budget))
        return torch.autograd.grad(photometric_loss(out.color, gt),
                                   list(leaves.values()))

    with numerics.bf16_replay():
        CR.reset_launches()
        got = leaf_grads()
        torch.cuda.synchronize()
        e2e_launches = dict(CR.launches)
    # The patch wraps the replay it finds: the plain one inside
    # plain_kernels.
    with CR.plain_kernels(), numerics.bf16_replay():
        ref = leaf_grads()
    if e2e_launches["composite_bwd_bf16"] != 1 \
            or e2e_launches["composite_bwd"] != 0:
        fail(f"phase 25: the patched backward launched {e2e_launches}")
    grad_rel = {}
    for k, a, b in zip(st.params.as_dict(), got, ref):
        top = float(b.abs().max())
        grad_rel[k] = float((a - b).abs().max()) / top if top > 0 else 0.0
        if not bool(torch.isfinite(a).all()) or grad_rel[k] > GRAD_REL:
            fail(f"phase 25: end-to-end gradient of {k} under bf16_replay: "
                 f"{grad_rel[k]} of its max (bound {GRAD_REL})")

    # A Trainer built inside the patch: its replayed block runs the BF16
    # build, once a step.
    gts = torch.as_tensor(scene.data.train.images, device=DEVICE)
    vis = list(range(BF16_BLOCK))
    with numerics.bf16_replay():
        tr = Trainer(G.state_from_numpy(**G.state_to_numpy(st)._asdict(),
                                        device=DEVICE),
                     cfg.OptimizationParams(), scene.cameras_extent,
                     scene.sh_degree, adaptive_occupancy=False)
        CR.reset_launches()
        m = tr.step_block(20_001, vis, scene.cam_stack("train"), gts, w, h,
                          n_steps=BF16_BLOCK)
        torch.cuda.synchronize()
        launches = dict(CR.launches)
    if launches["composite_bwd_bf16"] != BF16_BLOCK \
            or launches["composite_bwd"] != 0 \
            or not bool(torch.isfinite(m["loss"])):
        fail(f"phase 25: a block under bf16_replay launched {launches}, "
             f"loss {float(m['loss'])}")
    return dict(seconds=time.perf_counter() - t_start, shapes=shapes,
                ptxas_bf16=flagged, ptxas_default=default,
                end_to_end={"budget": budget, "grad_rel_of_max": grad_rel,
                            "launches": e2e_launches},
                block={"steps": BF16_BLOCK, "captures": tr.graph.captures,
                       "replays": tr.graph.replays,
                       "loss": float(m["loss"])},
                launches=launches)


def root_tools_path(scene_dir: str) -> dict:
    """Phase 26: the two host-only root tools as processes, with pandas and
    matplotlib made unimportable in them: scripts/summarize_results.py over
    a plot_* layout made from phase 12's results.json (a plot with its
    point_cloud/, one without, one without results.json), then its CSV rows
    against the file's numbers; apps/vis_cam on the bench scene's sparse/0,
    its PNG decoded, of its size, with both splits' colours in it."""
    import subprocess

    import numpy as np
    from PIL import Image

    t_start = time.perf_counter()
    base = os.path.join(WORK, "a14")
    model = os.path.join(WORK, "train_model")
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    for name in ("plot_1", "plot_2", "plot_3"):
        os.makedirs(os.path.join(base, "plots", name))
    for name in ("plot_1", "plot_2"):
        shutil.copy(os.path.join(model, "results.json"),
                    os.path.join(base, "plots", name))
    shutil.copytree(os.path.join(model, "point_cloud"),
                    os.path.join(base, "plots", "plot_1", "point_cloud"))
    blocked = "import runpy, sys; sys.modules.update(pandas=None, " \
        "matplotlib=None); sys.argv = sys.argv[1:]; "
    runs = {
        "summarize_results": [
            "runpy.run_path(sys.argv[0], run_name='__main__')",
            os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts",
                         "summarize_results.py"),
            "-b", os.path.join(base, "plots"), "-o", os.path.join(base, "out")],
        "vis_cam": [
            "runpy.run_module('wheat3dgs_tpu_torch.apps.vis_cam', "
            "run_name='__main__', alter_sys=True)", "vis_cam",
            "-s", scene_dir, "-o", os.path.join(base, "cameras.png")]}
    seconds = {}
    for name, (code, *argv) in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", blocked + code, *argv], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=SCRIPT_TIMEOUT)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 26: {name} exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    key = sorted(results)[-1]
    with open(os.path.join(base, "out", "results_per_scene.csv")) as f:
        per_scene = f.read().splitlines()
    with open(os.path.join(base, "out", "results_summary.csv")) as f:
        summary = f.read().splitlines()
    m = results[key]
    scores = ",".join("" if m.get(k) is None else repr(float(m[k]))
                      for k in ("PSNR", "SSIM", "LPIPS"))
    if per_scene[0] != "scene,method,psnr,ssim,lpips,storage_mb" \
            or len(per_scene) != 3 \
            or not per_scene[1].startswith(f"plot_1,wheat3dgs/{key},"
                                           f"{scores},") \
            or per_scene[2] != f"plot_2,wheat3dgs/{key},{scores}," \
            or len(summary) != 4 or summary[2] != "method" + "," * 8 \
            or not summary[3].startswith(
                f"wheat3dgs/{key},{float(m['PSNR'])!r},0.0,"):
        fail(f"phase 26: summarize_results wrote {per_scene} / {summary}")
    png = Image.open(os.path.join(base, "cameras.png"))
    pix = np.asarray(png.convert("RGB")).reshape(-1, 3)
    colours = {name: int((pix == c).all(axis=1).sum()) for name, c in
               (("red", (255, 0, 0)), ("blue", (0, 0, 255)))}
    if png.size != (1500, 1200) or min(colours.values()) == 0:
        fail(f"phase 26: vis_cam's PNG {png.size}, {colours}")
    return dict(seconds=time.perf_counter() - t_start,
                process_seconds=seconds, per_scene=per_scene,
                summary=summary, png_size=list(png.size),
                split_pixels=colours)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    # The card timer and the roofline bounds (H100 SXM peaks) are the
    # port's, shared with its profiling apps.
    global bound, cuda_time_ms, fwd_bound, smi_line, T_START
    try:
        import wheat3dgs_tpu_torch  # noqa: F401
        from wheat3dgs_tpu_torch.ops import cuda_build
        from wheat3dgs_tpu_torch.utils.cuda_timing import (bound,
                                                            cuda_time_ms,
                                                            fwd_bound,
                                                            smi_line)
    except ImportError as exc:
        fail(f"the port is not importable next to this script ({exc})")
    T_START = t_start = time.perf_counter()
    atexit.register(stop_scripts)
    signal.signal(signal.SIGTERM,
                  lambda *_: (stop_scripts(), os._exit(143)))

    # 1. device
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    say("device", name=kind, count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    # 2. build (every source in parallel)
    t0 = time.perf_counter()
    per_kernel = cuda_build.build()
    ptxas = {}
    for name in cuda_build.KERNELS:
        log = (cuda_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    say("build", seconds=time.perf_counter() - t0, per_kernel=per_kernel,
        ptxas=ptxas)

    # 3. data
    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "scene")
    model_dir = os.path.join(WORK, "model")
    t0 = time.perf_counter()
    n = make_data(scene_dir, model_dir)
    say("data", seconds=time.perf_counter() - t0, splats=n,
        width=BENCH["width"], height=BENCH["height"], sh_degree=3)

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.scene import Scene

    scene = Scene(cfg.ModelParams(source_path=scene_dir, model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    if scene.sh_degree != 3:
        fail(f"model loaded at SH degree {scene.sh_degree}")

    # 4. kernels against their plain versions
    dec, comp = check_kernels(scene)
    say("kernels", decode_cull=dec, composite_fwd=comp)

    # 5. the serving path
    mp = main_path(model_dir, scene)
    say("main_path", **mp)
    print(f"render_fwd: {mp['fps']:.3f} FPS at "
          f"{BENCH['width']}x{BENCH['height']}, {n} splats, SH 3 on "
          f"{smi}", flush=True)

    # 6. training kernels against their plain versions
    tfwd, tbwd, tseg, e2e = check_train_kernels(scene)
    say("train_kernels", composite_train_fwd=tfwd, composite_bwd=tbwd,
        segsum=tseg, end_to_end=e2e)
    del scene

    # 7. the training path
    trainer, tscene, tp = train_path(scene_dir,
                                     os.path.join(WORK, "train_model"))
    say("train_path", **tp)

    print(f"train_graph: {tp['captures']} captures "
          f"({', '.join(f'{x:.2f}' for x in tp['capture_seconds'])} s), "
          f"{tp['replays']} replays in {len(tp['blocks'])} blocks and "
          f"{tp['single_steps']} single steps", flush=True)

    # 8. steady training rate, single steps and blocks in turns
    rate = train_rate(trainer, tscene)
    say("train_rate", **rate)
    print(f"train_step: {rate['step_it_per_s']:.3f} it/s, train_step_block:"
          f" {rate['block_it_per_s']:.3f} it/s at "
          f"{BENCH['width']}x{BENCH['height']}, {rate['n_alive']} splats, "
          f"SH 3 on {smi}", flush=True)

    # 8b. a replayed block against the same steps run eagerly
    say("block_vs_eager", **block_against_eager(trainer, tscene))
    del trainer, tscene

    # 7b. the densification decision, kernels against plain
    dd = densify_decision(scene_dir)
    say("densify_decision", **dd)
    print(f"densify decision at {dd['resolution'][0]}x"
          f"{dd['resolution'][1]}, iterations {dd['iterations'][0]}-"
          f"{dd['iterations'][1]}: {dd['decisions_differ']} of "
          f"{dd['alive']} splats decided differently (gate {dd['gate']}); "
          f"statistic within 2x of the threshold ({dd['near_threshold']} "
          f"splats): max rel err {dd['stat_max_rel_err_near']:.3e}, mean "
          f"signed {dd['stat_mean_signed_rel_err_near']:.3e}; hot on the "
          f"kernel path only {dd['hot_kernel_only']}, plain only "
          f"{dd['hot_plain_only']}; n_alive after {dd['n_alive_after']} "
          f"(kernels, plain); {smi}", flush=True)

    # 9. segmentation kernels against their plain versions
    scene = Scene(cfg.ModelParams(source_path=scene_dir, model_path=model_dir),
                  load_iteration=-1, device=DEVICE)
    sfwd, sbwd, sseg, scomp, lift = check_seg_kernels(scene, scene_dir)
    say("seg_kernels", composite_train_fwd=sfwd, composite_bwd=sbwd,
        segsum=sseg, composite_fwd=scomp, lift_batch8=lift)
    del scene

    # 17 and 24: the pipeline script and eval.sh on a fresh model of
    # their own plot, and the envelope chain's processes, each in a thread
    # beside phases 10-16 (which time nothing on the card); both are done
    # before phase 18.
    pipeline = beside(pipeline_path, make_pipeline_scene())
    chain = envelope_chain_start()

    # 10. the segmentation path
    sp = seg_path(scene_dir, model_dir)
    say("seg_path", **sp)
    print(f"segmentation: {sp['num_heads']} heads, median purity "
          f"{sp['median_purity']:.3f}, {sp['gt_heads_covered']} of "
          f"{BENCH['n_heads']} ground-truth heads, {sp['seconds']:.1f} s on "
          f"{smi}", flush=True)

    # 11. the evaluation path
    ep = eval_path(model_dir)
    say("eval_path", **ep)

    # 12. metrics (SSIM / PSNR / LPIPS) on the trained model's test renders
    mt = metrics_path(os.path.join(WORK, "train_model"))
    say("metrics_path", **mt)
    print("metrics: " + ", ".join(
        f"{k} {v['seconds_per_image']:.3f} s/image after a first run of "
        f"{v['first_run_seconds']:.2f} s (PNG reads {v['png_read_ms']:.1f} "
        f"ms, SSIM + PSNR {v['ssim_psnr_ms']:.2f} ms, LPIPS forward "
        f"{v['lpips_ms']:.2f} ms)" for k, v in mt["nets"].items())
        + f" at {BENCH['width']}x{BENCH['height']} on {smi}", flush=True)

    # 13-14. 360 videos: the field with the head overlay, then each head
    fp = field_path(model_dir)
    say("field_360_path", **fp)
    hp = head_path(model_dir)
    say("head_360_path", **hp)
    for name, r in (("360 field", fp), ("360 head", hp)):
        print(f"{name}: {r['frames']} frames at {r['size'][0]}x"
              f"{r['size'][1]}, {r['fps']:.2f} FPS over the orbits and "
              f"{r['fps_run']:.2f} over the whole run ({r['seconds']:.1f} s: "
              f"probes {r['probe_seconds']:.1f}, lift {r['lift_seconds']:.1f},"
              f" encode {r['encode_seconds']:.1f}) on the host clock, "
              f"device busy {r['busy']['device_busy_share']:.1%}, "
              f"{', '.join(r['videos'][:3])} on {smi}", flush=True)

    # 15. the viewer
    vp = viewer_path(scene_dir, model_dir)
    say("viewer_path", **vp)
    print(f"viewer: {vp['ms_per_request']:.1f} ms per request at "
          f"{vp['size'][0]}x{vp['size'][1]}, {vp['reprobes']} re-probes on "
          f"{smi}", flush=True)

    # 16. morphology on the segmented heads, card against CPU
    mo = morphology_path(model_dir)
    say("morphology_path", **mo)
    print("morphology: " + ", ".join(
        f"{t} {r['seconds_per_head']:.3f} s a head (cluster "
        f"{r['cluster_s']:.3f}, SOR {r['sor_s']:.3f}, traits "
        f"{r['traits_s']:.4f})" for t, r in mo["per_head"].items())
        + f", {mo['heads']} heads of {min(mo['kept_points'])}-"
        f"{max(mo['kept_points'])} kept points, files equal on both "
        f"devices; {smi}", flush=True)

    # 17. the pipeline script, then eval.sh (and phase 24's processes)
    pp = pipeline()
    chain["runs"]()
    say("pipeline_path", **pp)
    print(f"pipeline: {pp['seconds']:.1f} s (" + ", ".join(
        f"{st['step'].split('.')[-1]} {st['seconds']:.1f}"
        for st in pp["steps"]) + f"), {pp['head_plys']} heads, "
        f"{pp['traits_rows']} traits rows; eval.sh "
        f"{pp['eval_script']['seconds']:.1f} s; python on PATH: "
        f"{pp['python_on_path']}; {smi}", flush=True)

    # 18. the scan probe
    probe = check_probe()
    say("probe", **probe)

    # 19. several plots trained in one process
    mpp = multi_plot_path(scene_dir)
    say("multi_plot_path", **mpp)
    print("multi-plot: " + ", ".join(
        f"{k} {r['ms_per_step']:.2f} ms a step ({r['plot_it_per_s']:.2f} "
        f"it/s a plot, {r['plot_iterations_per_s']:.2f} plot-it/s)"
        for k, r in mpp["rates"].items())
        + f" at SH 3, {BENCH['width']}x{BENCH['height']}; device busy "
        f"{mpp['busy']['device_busy_share']:.1%} at P2_B2; training run "
        f"{mpp['seconds']:.1f} s for {mpp['iterations']} iterations, "
        f"{mpp['captures']} captures, peak {mpp['peak_memory_gb']:.2f} GiB;"
        f" {smi}", flush=True)
    print("multi-plot kernels against the plain path: " + ", ".join(
        f"plot {r['plot']} at capacity {r['capacity']}, budget "
        f"{r['entry_budget']} ({r['entries']} entries): gradient "
        f"{max(r['grad_rel_of_max'].values()):.2e} of its max, colour "
        f"{r['colour_pixels_off']} pixels off"
        for r in mpp["app_kernels"]) + "; a replayed step "
        f"{mpp['rate_fit']['ms_per_step']:.3f} ms + "
        f"{mpp['rate_fit']['ms_per_render']:.3f} ms a render", flush=True)

    # 20. the bench as its own process
    bp = bench_path(scene_dir)
    say("bench_path", **bp)
    print(json.dumps(bp["line"]), flush=True)
    print(f"bench: {bp['seconds']:.1f} s, launches {bp['launches']}; "
          f"{smi}", flush=True)
    t0 = time.perf_counter()
    bk = check_bench_kernels(scene_dir)
    say("bench_kernels", seconds=time.perf_counter() - t0, **bk)
    print("bench kernels against the plain path: " + ", ".join(
        f"train view {r['view']} at capacity {r['capacity']} ({r['alive']} "
        f"alive), budget {r['entry_budget']} ({r['entries']} entries): "
        f"gradient {max(r['grad_rel_of_max'].values()):.2e} of its max, "
        f"colour {r['colour_pixels_off']} pixels off" for r in bk["train"])
        + "; " + ", ".join(
        f"render_fwd view {r['view']} at budget {r['entry_budget']} "
        f"({r['entries']} entries): {r['pixels_off']} pixels off, max abs "
        f"err {r['max_abs_err']:.2e}" for r in bk["render"]), flush=True)

    # 21. the multi-plot step over gloo ranks on this card
    dp = dist_path(scene_dir)
    say("dist_path", **dp)
    print("distributed: " + ", ".join(
        f"rank {res['meshes'][0]['coords']} " + "; ".join(
            f"{m['mesh'][0]}x{m['mesh'][1]} mesh {m['seconds_per_step']:.3f}"
            f" s a step, loss rel err {m['loss_max_rel']:.2e}, means "
            f"{m['max_abs_err']['means']:.2e}, " + ", ".join(
                f"{k} {m['max_abs_err'][k]:.2e} of {m['max_abs'][k]:.2e}"
                for k in m["max_abs"] if k.startswith("mu ")
                or k == "grad_accum") for m in res["meshes"])
        for res in dp["ranks"]) + f" (gloo, CUDA tensors staged through "
        f"the host: {dp['ranks'][0]['staged']}); {dp['seconds']:.1f} s; "
        f"{smi}", flush=True)

    # 22. the padded-tile backend against the kernels, the CPU, eager
    xp = xla_path(scene_dir, model_dir)
    say("xla_path", **xp)
    print(f"xla backend: {xp['full']['pixels_off']} pixels off the "
          f"kernels' render (max abs err "
          f"{xp['full']['max_abs_err_on_pixels']:.2e} elsewhere) at tile "
          f"{XLA_TILE}, K {xp['full']['max_per_tile']}; card against CPU "
          f"{xp['vs_cpu']['pixels_off']} pixels off; train_step loss rel "
          f"err {xp['train_step']['loss_rel_err']:.2e}, gradients within "
          f"{max(xp['train_step']['grad_rel_of_max'].values()):.2e} of "
          f"their max; block bit-identical {xp['block']['bit_identical']}; "
          f"render_fwd {xp['times']['render_fwd_xla_ms']:.1f} ms (kernels "
          f"{xp['times']['render_fwd_kernels_ms']:.2f}), train_step "
          f"{xp['times']['train_step_xla_ms']:.1f} ms (kernels "
          f"{xp['times']['train_step_kernels_ms']:.2f}); {smi}", flush=True)

    # 23. the scene JAX's exp_bench2 table was measured on
    rs = reference_scene()
    say("reference_scene", **rs)
    print("reference scene: " + "; ".join(
        f"camera {c['camera']}: JAX's render h_step "
        f"{c['jax']['h_step']:.5f}, block_std {c['jax']['block_std']:.5f}"
        + "".join(f", GT {x}: {c[x]['h_step']:.5f} / "
                  f"{c[x]['block_std']:.5f}, PSNR of JAX's render "
                  f"{c[x]['psnr_jax_render']:.2f} dB"
                  for x in REFERENCE_GTS) for c in rs["cameras"])
        + "; splats at the 1e-4 scale floor " + ", ".join(
            f"{x} {b['scale_floor_share']:.1%}"
            for x, b in rs["builds"].items())
        + f"; {rs['seconds']:.1f} s; {smi}", flush=True)

    # 24. the envelope chain on the band's numerics, then the diag (its
    # processes ran beside phases 10-16)
    ec = envelope_chain(chain)
    say("envelope_chain", **ec)
    rep, diag = ec["report"], ec["diag"]
    print(f"envelope chain: {ec['seconds']:.1f} s (synthesis "
          f"{ec['synth_seconds']:.1f}, first leg {ec['leg_seconds']:.1f}, "
          f"exp_round5_final.sh {ec['chain_seconds']:.1f}, diag "
          f"{ec['diag_seconds']:.1f}); {rep['n_discovered']} ids, IoU "
          f"{rep['mean_iou']:.3f}, purity {rep['mean_splat_purity']:.3f}, "
          f"{ec['morph']['n_pairs']} trait pairs, {ec['head_videos']} head "
          f"videos, {ec['splats']} splats; diag " + ", ".join(
              f"{r['iteration']}: train {r['train_psnr']:.2f} / test "
              f"{r['test_psnr']:.2f} dB" for r in diag)
          + f"; launches {ec['launches']}; {smi}", flush=True)

    # 25. composite_bwd's BF16 build (the bf16 replay patch)
    br = bf16_replay_path(scene_dir, model_dir)
    say("bf16_replay", **br)
    print("bf16 replay: " + ", ".join(
        f"{r['value_rows']} rows {r['ms']:.4f} ms (default build "
        f"{r['default_ms']:.4f} in the same turns), "
        f"{r['max_rel_err_of_column_max']:.2e} of the column max and "
        f"{r['rel_l2']:.2e} in relative L2 (bound {r['rel_l2_bound']:.2e}) "
        f"from the flagged plain replay, wrongly rounded replays at "
        + ", ".join(f"{k} {v:.2e}" for k, v in
                    r["wrongly_rounded_rel_l2"].items())
        + f", {r['values_differing_from_default']} values "
        f"off the default build" for r in br["shapes"])
        + f"; gradients within "
        f"{max(br['end_to_end']['grad_rel_of_max'].values()):.2e} of the "
        f"all-plain path under the patch; a {BF16_BLOCK}-step block "
        f"launched {br['launches']['composite_bwd_bf16']} BF16 / "
        f"{br['launches']['composite_bwd']} default; {br['seconds']:.1f} s;"
        f" {smi}", flush=True)

    # 26. the host-only root tools (A14)
    rt = root_tools_path(scene_dir)
    say("root_tools", **rt)
    print(f"root tools: summarize_results "
          f"{rt['process_seconds']['summarize_results']:.1f} s, vis_cam "
          f"{rt['process_seconds']['vis_cam']:.1f} s ({rt['png_size'][0]}x"
          f"{rt['png_size'][1]}, {rt['split_pixels']} split pixels), "
          f"without pandas or matplotlib; {smi}", flush=True)

    # 27. the distributed steps over NCCL (a world of one), replayed
    npth = nccl_path(scene_dir)
    say("nccl_path", **npth)
    print("nccl: " + "; ".join(
        f"{k} {r['captures']} captures / {r['replays']} replays, bit for "
        f"bit its eager steps and one process, ms a step replayed "
        f"{r['ms']['replayed']:.3f} / eager {r['ms']['eager']:.3f} / one "
        f"process {r['ms']['one_process']:.3f}, collectives a step "
        f"{r['collectives_per_step']} (eager, ProcessGroupNCCL "
        f"{r['eager_nccl_calls']}), NCCL kernels in a replay "
        f"{r['replay_nccl_kernels']}, copies {r['replay_copies']} (one "
        f"process {r['one_process_copies']})"
        for k, r in npth["trainers"].items())
        + f"; train_multi over NCCL {npth['app']['seconds']:.1f} s, files "
        f"equal to one process's; {npth['seconds']:.1f} s (torch "
        f"{npth['torch']}, NCCL {npth['nccl']}); {smi}", flush=True)

    paths = {"serving": mp, "training": tp, "segmentation": sp,
             "evaluation": ep, "metrics": mt, "360_field": fp,
             "360_head": hp, "viewer": vp, "pipeline_script": pp,
             "eval_script": pp["eval_script"], "multi_plot": mpp,
             "bench": bp, "distributed": dp, "reference_scene": rs,
             "envelope_chain": ec, "nccl": npth}
    on_default = {k: r["launches"]["composite_bwd_bf16"]
                  for k, r in paths.items()}
    if any(on_default.values()):
        fail(f"a default path launched the BF16 build: {on_default}")

    src = "wheat3dgs_tpu_torch/csrc/"
    tpu = "wheat3dgs_tpu/ops/pallas_raster.py:"
    keys = ("value_rows", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "library_ms", "shape")
    rows = []
    for name, r, file, line, path, shapes in (
            ("decode_cull", dec, "decode_cull.cu", 381, mp, []),
            ("composite_fwd", comp, "composite_fwd.cu", 1094, mp, scomp),
            ("composite_train_fwd", tfwd, "composite_fwd.cu", 704, tp,
             [sfwd]),
            ("composite_bwd", tbwd, "composite_bwd.cu", 840, tp, [sbwd]),
            ("segsum", tseg, "segsum.cu", 507, tp, [sseg])):
        rows.append({"name": name, "route": "cuda", "source": src + file,
                     "replaces": f"{tpu}{line}",
                     "launches": path["launches"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "launches_by_path": {
                         "serving": mp["launches"][name],
                         "training": tp["launches"][name],
                         "segmentation": sp["launches"][name],
                         "evaluation": ep["launches"][name],
                         "metrics": mt["launches"][name],
                         "360_field": fp["launches"][name],
                         "360_head": hp["launches"][name],
                         "viewer": vp["launches"][name],
                         "pipeline_script": pp["launches"][name],
                         "eval_script": pp["eval_script"]["launches"][name],
                         "multi_plot": mpp["launches"][name],
                         "bench": bp["launches"].get(name, 0),
                         "distributed": dp["launches"][name],
                         "reference_scene": rs["launches"][name],
                         "envelope_chain": ec["launches"][name],
                         "nccl": npth["launches"][name]},
                     "segmentation_shapes": [
                         {k: x.get(k) for k in keys} for x in shapes]})
    # The BF16 build's row: launches from phase 25's block (it is on no
    # default path: each path's count beside it), the 4-row shape first.
    b4, b9 = br["shapes"]
    rows.append({"name": "composite_bwd (bf16 replay)", "route": "cuda",
                 "source": src + "composite_bwd.cu",
                 "replaces": f"{tpu}840",
                 "launches": br["launches"]["composite_bwd_bf16"],
                 "max_abs_err": b4["max_abs_err"], "ms": b4["ms"],
                 "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"],
                 "bound_by": b4["bound_by"], "library_ms": None,
                 "default_build_ms": b4["default_ms"],
                 "launches_by_path": on_default,
                 "segmentation_shapes": [
                     {k: b9.get(k) for k in keys + ("default_ms",)}]})
    # The probe's row: the cumsum kind (torch.cumsum computes the same
    # function; library_ms is its loop replayed from a CUDA graph, without
    # the host's launches), each kind beside it.
    cum = probe["kinds"]["cumsum"]
    rows.append({"name": "scan_probe", "route": "cuda",
                 "source": src + "scan_probe.cu",
                 "replaces": "scripts/prof_scan.py:21",
                 "launches": probe["launches"]["scan_probe"],
                 "max_abs_err": max(k["max_abs_err"]
                                    for k in probe["kinds"].values()),
                 "ms": cum["ms"], "plain_ms": cum["plain_ms"],
                 "bound_ms": cum["bound_ms"], "bound_by": cum["bound_by"],
                 "library_ms": probe["library_ms"],
                 "library_eager_ms": probe["library_eager_ms"],
                 "cluster": probe["cluster"],
                 "kinds": {k: {x: v[x] for x in ("ms", "ms_64_steps",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by", "max_abs_err",
                                                 "us_per_scan", "us_per_step",
                                                 "algorithm_ops")}
                           for k, v in probe["kinds"].items()}})
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s; card: {smi}",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
