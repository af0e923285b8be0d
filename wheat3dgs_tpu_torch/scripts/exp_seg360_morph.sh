#!/bin/bash
# Benchmark config #4 at envelope scale on the PyTorch/CUDA port (run after
# exp_seg_envelope.py): the counterpart of the repo's
# scripts/exp_seg360_morph.sh. The 360-degree field video with the head
# overlay (200 frames at 20 fps, elevation 45: run_wheat_3dgs.sh's), the
# per-head close-up turntables (100 frames at 10 fps, elevation 30), then
# the morphology traits of every discovered head through
# apps/morphology_app on the JAX script's YAML config, each app the port's
# on $DEVICE.
#
# The JAX script writes its config to /tmp/morph_envelope3.yaml and its
# traits to /tmp/morph_envelope_results; here the traits go to MORPH_OUT
# (default <model>/wheat-head/<exp>/morph_envelope_results) and the config
# beside them.
#
# Usage: [SEG_SCENE=dir] [SEG_MODEL=dir] [EXP=envelope] [FRAMES=200] \
#   [HEAD_FRAMES=100] [MORPH_OUT=dir] [DEVICE=cuda|cpu] \
#   bash wheat3dgs_tpu_torch/scripts/exp_seg360_morph.sh
set -exuo pipefail
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
APPS=wheat3dgs_tpu_torch.apps
MODEL=${SEG_MODEL:-$ROOT/output/exp_seg_envelope/model}
SCENE=${SEG_SCENE:-$ROOT/output/exp_seg_envelope/scene}
EXP=${EXP:-envelope}
DEVICE=${DEVICE:-cuda}

time python -m $APPS.render_360_app -s "$SCENE" -m "$MODEL" \
  --exp_name "$EXP" --render_type field --n_frames "${FRAMES:-200}" \
  --framerate 20 --elevation 45 --device "$DEVICE"
time python -m $APPS.render_360_app -s "$SCENE" -m "$MODEL" \
  --exp_name "$EXP" --render_type head --n_frames "${HEAD_FRAMES:-100}" \
  --framerate 10 --elevation 30 --device "$DEVICE"

# Morphology traits over the discovered per-head point clouds.
OUT=${MORPH_OUT:-$MODEL/wheat-head/$EXP/morph_envelope_results}
mkdir -p "$OUT"
# The config's paths are read relative to the config's own directory.
OUT=$(cd "$OUT" && pwd)
PLY=$(cd "$MODEL/wheat-head/$EXP/ply" && pwd)
CONFIG=$OUT/morph_envelope3.yaml
cat > "$CONFIG" <<EOF
data_folder: "$PLY/"
output_folder: "$OUT/"
file_format: "ply"
subsampling_threshold: 5000
clusterer_definition:
  type: "hdbscan"
  epsilon: 15
  min_samples: 15
  min_cluster_size: 250
  epsilon_hdbscan: 0.015
sor_parameters:
  k: 200
  std_ratio: 3
splines_smoothing_value: 1
distance_percentile: 99
get_bboxes: true
get_processed_pcd: true
EOF
time python -m $APPS.morphology_app -c "$CONFIG" --device "$DEVICE"
ls -la "$OUT"
