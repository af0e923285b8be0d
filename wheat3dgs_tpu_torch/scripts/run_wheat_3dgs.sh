#!/bin/bash
# Full 5-step Wheat3DGS pipeline for one plot on the PyTorch/CUDA port: the
# counterpart of the repo's root run_wheat_3dgs.sh, with the same
# arguments, steps, flags and order, each `python X.py` replaced by the
# port's app (`python -m wheat3dgs_tpu_torch.apps.<app>`) on $DEVICE.
#
# Usage: [DEVICE=cuda|cpu] [ITERS=15000] [FIELD_FRAMES=200] [HEAD_FRAMES=100] \
#   bash wheat3dgs_tpu_torch/scripts/run_wheat_3dgs.sh <data_dir> <model_dir> [exp_name] [iou]
# (FIELD_FRAMES / HEAD_FRAMES: the 360 videos' frames, the root script's
# by default.)
set -euo pipefail

DATA_DIR=${1:?usage: run_wheat_3dgs.sh <data_dir> <model_dir> [exp] [iou]}
MODEL_DIR=${2:?}
EXP_NAME=${3:-default}
IOU=${4:-0.6}
ITERS=${ITERS:-15000}
DEVICE=${DEVICE:-cuda}
FIELD_FRAMES=${FIELD_FRAMES:-200}
HEAD_FRAMES=${HEAD_FRAMES:-100}
# The package resolves from any working directory.
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
APPS=wheat3dgs_tpu_torch.apps

echo "=== 1/5 train vanilla 3DGS ==="
python -m $APPS.train_vanilla -s "$DATA_DIR" -m "$MODEL_DIR" \
  --iterations "$ITERS" --save_iterations 7000 "$ITERS" \
  --test_iterations 7000 "$ITERS" --device "$DEVICE"

echo "=== 2/5 render + NVS metrics ==="
python -m $APPS.render_sets -m "$MODEL_DIR" --device "$DEVICE"
python -m $APPS.metrics_app -m "$MODEL_DIR" --device "$DEVICE"

echo "=== 3/5 3D instance segmentation ==="
python -m $APPS.run_3d_seg_app -s "$DATA_DIR" -m "$MODEL_DIR" \
  --exp_name "$EXP_NAME" --iou_threshold "$IOU" --device "$DEVICE"

echo "=== 4/5 seg eval + 360 videos ==="
python -m $APPS.eval_wheatgs_app -m "$MODEL_DIR" --exp_name "$EXP_NAME" \
  --device "$DEVICE"
python -m $APPS.render_360_app -m "$MODEL_DIR" --exp_name "$EXP_NAME" \
  --render_type field --n_frames "$FIELD_FRAMES" --framerate 20 --elevation 45 \
  --device "$DEVICE"
python -m $APPS.render_360_app -m "$MODEL_DIR" --exp_name "$EXP_NAME" \
  --render_type head --n_frames "$HEAD_FRAMES" --framerate 10 --elevation 30 \
  --device "$DEVICE"

echo "=== 5/5 morphology ==="
# run_pipeline writes into output_folder and does not create it (nor does
# any earlier step): the root script's step 5 stops there on a fresh model.
mkdir -p "$MODEL_DIR/wheat-head/$EXP_NAME/morphology"
python - <<PYEOF
from wheat3dgs_tpu_torch.morphology import run_pipeline
run_pipeline({
    "data_folder": "$MODEL_DIR/wheat-head/$EXP_NAME/ply",
    "output_folder": "$MODEL_DIR/wheat-head/$EXP_NAME/morphology",
    "file_format": "ply", "subsampling_threshold": 5000,
    "clusterer_definition": {"type": "hdbscan", "min_samples": 15,
                             "min_cluster_size": 250,
                             "epsilon_hdbscan": 0.015},
    "sor_parameters": {"k": 200, "std_ratio": 3},
    "splines_smoothing_value": 1, "distance_percentile": 99,
    "get_bboxes": True, "get_processed_pcd": True,
}, device="$DEVICE")
PYEOF
echo "pipeline complete: $MODEL_DIR"
