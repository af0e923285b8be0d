#!/bin/bash
# Evaluation-only pass over a trained model on the PyTorch/CUDA port: the
# counterpart of the repo's root eval.sh (same arguments and steps, each
# app the port's, on $DEVICE).
#
# Usage: [DEVICE=cuda|cpu] bash wheat3dgs_tpu_torch/scripts/eval.sh <data_dir> <model_dir> [exp_name]
set -euo pipefail
DATA_DIR=${1:?usage: eval.sh <data_dir> <model_dir> [exp]}
MODEL_DIR=${2:?}
EXP_NAME=${3:-default}
DEVICE=${DEVICE:-cuda}
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
APPS=wheat3dgs_tpu_torch.apps

python -m $APPS.render_sets -m "$MODEL_DIR" --device "$DEVICE"
python -m $APPS.metrics_app -m "$MODEL_DIR" --device "$DEVICE"
python -m $APPS.eval_wheatgs_app -m "$MODEL_DIR" --exp_name "$EXP_NAME" \
  --device "$DEVICE"
