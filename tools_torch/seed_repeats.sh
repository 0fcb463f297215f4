#!/bin/bash
# Seed repeats of one synvf row on the port's CLIs: train the row's model
# with the synvf recipe of pcp_tpu_torch/workspace/synth_experiments.sh
# (the visible-faces urban world, b4, 32768 points, LR 0.003) once per
# seed and evaluate it on the val split, printing each epoch's mean loss
# and terms and the eval's mAP line. ROW is one of
#   car          the car sender (25 epochs, DATASET_DOWNSAMPLING_RATIO 4)
#   early_sync   the early-fusion ego, other agents at the current keyframe (30 epochs)
#   early_async  the early-fusion ego, other agents at the previous keyframe (30 epochs)
#   single       the single-agent ego (30 epochs, EXCHANGE_MODAR False)
#   disco_sync   DiscoNet mid fusion, other agents at the current keyframe (30 epochs)
#   disco_async  DiscoNet mid fusion, other agents at the previous keyframe (30 epochs)
# None of these reads the exchange database. DiscoNet's frozen BEV makers
# take the car, RSU and sync early-ego checkpoints of a synvf run of
# pcp_tpu_torch/workspace/synth_experiments.sh under $MAKERS_ROOT (default
# build/synvf, that script's OUTPUT_ROOT in the chip runs); they are the
# same for every seed. Outputs go under $OUTPUT_ROOT (default build/seeds);
# CLI_ARGS is handed to the train and the test CLI (e.g. "--tf32 off").
#
#   tools_torch/seed_repeats.sh ROW [SEED ...]      # default seeds: 101 202
set -e -o pipefail
cd "$(dirname "$0")/.."
ROW=$1; shift
SEEDS=${*:-101 202}
PY=${PYTHON:-python3}
ROOT=${OUTPUT_ROOT:-build/seeds}
SYN="{'NUM_SCENES': 15, 'KEYFRAMES_PER_SCENE': 12, 'NUM_CARS': 24, 'NUM_PEDS': 8, 'WORLD': 'urban', 'NUM_PARKED': 16, 'VISIBLE_FACES': True}"
COMMON=(DATA_CONFIG.USE_SYNTHETIC_DATA True DATA_CONFIG.MAX_POINTS_PER_SAMPLE 32768
        DATA_CONFIG.SYNTHETIC "$SYN" DATA_CONFIG.MINI_TRAINVAL_STRIDE 1 OPTIMIZATION.LR 0.003)
case $ROW in
  car)         MODEL=v2x_pointpillar_basic_car; EPOCHS=25; RATIO=4; EXTRA=() ;;
  early_sync)  MODEL=v2x_pointpillar_basic_ego_early; EPOCHS=30; RATIO=1
               EXTRA=(DATA_CONFIG.EXCHANGE_PREVIOUS False) ;;
  early_async) MODEL=v2x_pointpillar_basic_ego_early; EPOCHS=30; RATIO=1
               EXTRA=(DATA_CONFIG.EXCHANGE_PREVIOUS True) ;;
  single)      MODEL=v2x_pointpillar_basic_ego; EPOCHS=30; RATIO=1
               EXTRA=(DATA_CONFIG.EXCHANGE_MODAR False) ;;
  disco_sync|disco_async)
               MODEL=v2x_pointpillar_disco; EPOCHS=30; RATIO=1
               PREV=$([ $ROW = disco_async ] && echo True || echo False)
               EXTRA=(DATA_CONFIG.EXCHANGE_PREVIOUS $PREV) ;;
  *) echo "unknown row $ROW (car, early_sync, early_async, single, disco_sync, disco_async)" >&2
     exit 2 ;;
esac
TRAIN_EXTRA=()
if [ $MODEL = v2x_pointpillar_disco ]; then
  RUNS=${MAKERS_ROOT:-build/synvf}/cfgs/v2x_sim_models
  for MAKER in RSU:v2x_pointpillar_basic_rsu/synvf/ckpt/checkpoint_epoch_25.pth \
               CAR:v2x_pointpillar_basic_car/synvf/ckpt/checkpoint_epoch_25.pth \
               EARLY:v2x_pointpillar_basic_ego_early/synvf_sync/ckpt/checkpoint_epoch_30.pth; do
    CKPT=$RUNS/${MAKER#*:}
    [ -f "$CKPT" ] || { echo "no maker checkpoint $CKPT (set MAKERS_ROOT)" >&2; exit 2; }
    TRAIN_EXTRA+=(MODEL.BEV_MAKER_${MAKER%%:*}.CKPT "$CKPT")
  done
fi
CFG=tools/cfgs/v2x_sim_models/$MODEL.yaml
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for SEED in $SEEDS; do
  TAG=synvf_${ROW}_s$SEED
  $PY -m pcp_tpu_torch.tools.train --cfg_file $CFG --batch_size 4 --epochs $EPOCHS \
    --extra_tag $TAG --seed $SEED --num_epochs_to_eval 0 --workers 6 --output_root "$ROOT" \
    $CLI_ARGS --set "${COMMON[@]}" DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO $RATIO "${EXTRA[@]}" \
    "${TRAIN_EXTRA[@]}" 2>&1 | grep -E "epoch [0-9]+ done|trained|overlaid"
  $PY -m pcp_tpu_torch.tools.test --cfg_file $CFG --batch_size 4 --extra_tag $TAG --eval_tag $ROW \
    --ckpt "$ROOT/cfgs/v2x_sim_models/$MODEL/$TAG/ckpt/checkpoint_epoch_$EPOCHS.pth" \
    --workers 6 --output_root "$ROOT" $CLI_ARGS \
    --set "${COMMON[@]}" DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 "${EXTRA[@]}" 2>&1 \
    | grep -E "mAP:|car: AP"
done
