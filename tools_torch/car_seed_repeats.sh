#!/bin/bash
# Seed repeats of the synvf car sender: train the car of
# v2x_pointpillar_basic_car.yaml on the visible-faces urban world (the synvf
# recipe of pcp_tpu_torch/workspace/synth_experiments.sh: 25 epochs, b4 x
# 32768 points, LR 0.003, DATASET_DOWNSAMPLING_RATIO 4) once per seed and
# evaluate it on the val split, printing each epoch's mean loss and the
# eval's mAP line. Outputs go under $OUTPUT_ROOT (default build/carseeds).
#
#   tools_torch/car_seed_repeats.sh [SEED ...]      # default: 101 202
set -e -o pipefail
cd "$(dirname "$0")/.."
SEEDS=${*:-101 202}
PY=${PYTHON:-python3}
ROOT=${OUTPUT_ROOT:-build/carseeds}
CFG=tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml
SYN="{'NUM_SCENES': 15, 'KEYFRAMES_PER_SCENE': 12, 'NUM_CARS': 24, 'NUM_PEDS': 8, 'WORLD': 'urban', 'NUM_PARKED': 16, 'VISIBLE_FACES': True}"
COMMON=(DATA_CONFIG.USE_SYNTHETIC_DATA True DATA_CONFIG.MAX_POINTS_PER_SAMPLE 32768
        DATA_CONFIG.SYNTHETIC "$SYN" DATA_CONFIG.MINI_TRAINVAL_STRIDE 1 OPTIMIZATION.LR 0.003)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for SEED in $SEEDS; do
  $PY -m pcp_tpu_torch.tools.train --cfg_file $CFG --batch_size 4 --epochs 25 \
    --extra_tag synvf_s$SEED --seed $SEED --num_epochs_to_eval 0 --workers 6 --output_root "$ROOT" \
    --set "${COMMON[@]}" DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 4 2>&1 | grep -E "epoch [0-9]+ done|trained"
  $PY -m pcp_tpu_torch.tools.test --cfg_file $CFG --batch_size 4 --extra_tag synvf_s$SEED --eval_tag car \
    --ckpt "$ROOT/cfgs/v2x_sim_models/v2x_pointpillar_basic_car/synvf_s$SEED/ckpt/checkpoint_epoch_25.pth" \
    --workers 6 --output_root "$ROOT" --set "${COMMON[@]}" DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 2>&1 \
    | grep -E "mAP:|car: AP"
done
