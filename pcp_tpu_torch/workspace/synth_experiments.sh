#!/bin/bash
# The synthetic-world matrix on the port's CLIs: train the car and the RSU
# sender, clear and regenerate the exchange database from both, train the
# lately ego on the merged clouds and the early-fusion egos (sync and
# async), evaluate lately_sync, lately_async, lately_async_noflow, early_sync,
# early_async and the car, the six late-fusion rows (a host model on the
# senders' exchanged boxes: NMS and weighted box fusion, sync and async,
# async without flow and with oracle flow), train and evaluate the
# single-agent ego, then train DiscoNet mid fusion async and sync (its
# frozen BEV makers from this run's car, RSU and sync early-fusion
# checkpoints) and evaluate it matched (disco_sync, disco_async) and
# crossed (disco_xsync: async-trained on sync; disco_xasync: sync-trained
# on async), and export the table to results/<tag>_torch/. Counterpart of
# the lately, early, late, single and DiscoNet stages of
# workspace/synth_experiments.sh.
#
#   SMOKE=1 pcp_tpu_torch/workspace/synth_experiments.sh   # tiny world, 2 epochs
#   VF=1 pcp_tpu_torch/workspace/synth_experiments.sh      # visible-faces world (tag synvf)
#
# Every output lies under $OUTPUT_ROOT (default output/torch), the exchange
# database too: the JAX package's database is keyed by the same sample
# tokens, and one written from another world would poison the ego's
# training. WORKERS (default 4) is handed to the loaders. Stages write
# markers into $OUTPUT_ROOT/stamps_<tag>, so a rerun resumes after the last
# finished one; a failing stage stops the pipeline. ONLY, a bash regular
# expression, runs just the stages whose names it matches (e.g.
# ONLY='^(train_(car|rsu|early_sync|disco.*)|eval_(car|early_sync|disco.*))$'
# for the DiscoNet rows and what they need).
set -e
cd "$(dirname "$0")/../.."

if [ -n "$SMOKE" ]; then
  SYN="{'NUM_SCENES': 3, 'KEYFRAMES_PER_SCENE': 4, 'NUM_CARS': 12, 'NUM_PEDS': 4, 'WORLD': 'urban', 'NUM_PARKED': 8}"
  EPOCHS_CAR=2; EPOCHS_EGO=2; TAG=smokeurb; NPTS=16384
else
  SYN="{'NUM_SCENES': 15, 'KEYFRAMES_PER_SCENE': 12, 'NUM_CARS': 24, 'NUM_PEDS': 8, 'WORLD': 'urban', 'NUM_PARKED': 16}"
  EPOCHS_CAR=25; EPOCHS_EGO=30; TAG=${TAG_OVERRIDE:-synurb}; NPTS=32768
fi
if [ -n "$VF" ]; then
  SYN="${SYN%\}}, 'VISIBLE_FACES': True}"
  [ -z "$SMOKE" ] && TAG=${TAG_OVERRIDE:-synvf}
fi
OUTPUT_ROOT=${OUTPUT_ROOT:-output/torch}
OUTPUT_ROOT=$(mkdir -p "$OUTPUT_ROOT" && cd "$OUTPUT_ROOT" && pwd)
WORKERS=${WORKERS:-4}
PY=${PYTHON:-python3}
EXCHANGE=$OUTPUT_ROOT/exchange_database_$TAG

COMMON_SET=(DATA_CONFIG.USE_SYNTHETIC_DATA True
            DATA_CONFIG.MAX_POINTS_PER_SAMPLE "$NPTS"
            DATA_CONFIG.SYNTHETIC "$SYN"
            DATA_CONFIG.MINI_TRAINVAL_STRIDE 1
            DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY "$EXCHANGE"
            OPTIMIZATION.LR 0.003)
CFGS=tools/cfgs/v2x_sim_models
OUT=$OUTPUT_ROOT/stamps_$TAG; mkdir -p "$OUT"
ARGS=(--workers "$WORKERS" --output_root "$OUTPUT_ROOT")
log() { echo "[$(date +%H:%M:%S)] $*"; }

run_stage() {  # run_stage <name> <cmd...>
  local name=$1; shift
  if [ -f "$OUT/$name.done" ]; then log "skip $name (done)"; return 0; fi
  if [ -n "$ONLY" ] && ! [[ $name =~ $ONLY ]]; then log "skip $name (not in ONLY)"; return 0; fi
  log "=== $name ==="
  local t0=$(date +%s.%N)
  "$@"
  touch "$OUT/$name.done"
  log "done $name in $(awk "BEGIN {print $(date +%s.%N) - $t0}") s"
}

ckpt_of() { ls -d "$OUTPUT_ROOT"/cfgs/v2x_sim_models/$1/$2/ckpt/checkpoint_epoch_* 2>/dev/null | sort -V | tail -1; }

train() {  # train <stagename> <cfg> <epochs> <train tag> [extra --set pairs...]
  local name=$1 cfgf=$2 epochs=$3 tag=$4; shift 4
  run_stage "$name" $PY -m pcp_tpu_torch.tools.train --cfg_file $CFGS/$cfgf.yaml \
    --batch_size 4 --epochs "$epochs" --extra_tag "$tag" --num_epochs_to_eval 0 --profile "${ARGS[@]}" \
    --set "${COMMON_SET[@]}" "$@"
}

ev() {  # ev <stagename> <cfg> <train tag> [extra --set pairs...]
  local name=$1 cfgf=$2 tag=$3; shift 3
  run_stage "eval_$name" $PY -m pcp_tpu_torch.tools.test --cfg_file $CFGS/$cfgf.yaml \
    --batch_size 4 --extra_tag "$tag" --eval_tag "$name" --ckpt "$(ckpt_of $cfgf $tag)" "${ARGS[@]}" \
    --set "${COMMON_SET[@]}" DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 "$@"
}

late() {  # late <stagename> [extra --set pairs...]: a host model, no checkpoint
  local name=$1; shift
  run_stage "eval_$name" $PY -m pcp_tpu_torch.tools.test --cfg_file $CFGS/v2x_late_fusion.yaml \
    --batch_size 4 --extra_tag $TAG --eval_tag "$name" "${ARGS[@]}" \
    --set "${COMMON_SET[@]}" DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 "$@"
}

gen() {  # gen <agent>
  run_stage gen_exchange_$1 $PY -m pcp_tpu_torch.workspace.v2x_gen_exchange_database \
    --agent $1 --ckpt "$(ckpt_of v2x_pointpillar_basic_$1 $TAG)" --synthetic \
    --workers "$WORKERS" \
    --set MAX_POINTS_PER_SAMPLE "$NPTS" SYNTHETIC "$SYN" MINI_TRAINVAL_STRIDE 1 \
    EXCHANGE_DATABASE_DIRECTORY "$EXCHANGE"
}

EGO=v2x_pointpillar_basic_ego EARLY=v2x_pointpillar_basic_ego_early
train train_car v2x_pointpillar_basic_car $EPOCHS_CAR $TAG DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 4
train train_rsu v2x_pointpillar_basic_rsu $EPOCHS_CAR $TAG DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1
run_stage clean_exchange rm -rf "$EXCHANGE"
gen car
gen rsu
train train_ego $EGO $EPOCHS_EGO $TAG DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1
# early fusion: matched train and eval settings for each latency column
train train_early_sync $EARLY $EPOCHS_EGO ${TAG}_sync DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_PREVIOUS False
train train_early_async $EARLY $EPOCHS_EGO ${TAG}_async DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_PREVIOUS True
ev lately_sync $EGO $TAG DATA_CONFIG.EXCHANGE_NOW True
ev lately_async $EGO $TAG
ev lately_async_noflow $EGO $TAG DATA_CONFIG.EXCHANGE_FLOW_PROPAGATION False
ev early_sync $EARLY ${TAG}_sync DATA_CONFIG.EXCHANGE_PREVIOUS False
ev early_async $EARLY ${TAG}_async DATA_CONFIG.EXCHANGE_PREVIOUS True
ev car v2x_pointpillar_basic_car $TAG
late late_sync DATA_CONFIG.EXCHANGE_SETTING now
late late_async DATA_CONFIG.EXCHANGE_SETTING prev
late late_async_noflow DATA_CONFIG.EXCHANGE_SETTING prev DATA_CONFIG.EXCHANGE_FLOW_PROPAGATION False
late late_sync_wnms DATA_CONFIG.EXCHANGE_SETTING now MODEL.BOX_FUSION_METHOD weighted_nms
late late_async_wnms DATA_CONFIG.EXCHANGE_SETTING prev MODEL.BOX_FUSION_METHOD weighted_nms
late late_async_oracleflow DATA_CONFIG.EXCHANGE_SETTING prev DATA_CONFIG.EXCHANGE_ORACLE_FLOW True
# single agent: the same ego val samples and merged gt, exchange off
train train_single $EGO $EPOCHS_EGO ${TAG}_nocollab DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_MODAR False
ev single $EGO ${TAG}_nocollab DATA_CONFIG.EXCHANGE_MODAR False
# mid fusion (DiscoNet): frozen makers from this run's car, RSU and sync
# early ego; matched training per latency column, plus the cross cells
DISCO=v2x_pointpillar_disco
MAKERS=(MODEL.BEV_MAKER_RSU.CKPT "$(ckpt_of v2x_pointpillar_basic_rsu $TAG)"
        MODEL.BEV_MAKER_CAR.CKPT "$(ckpt_of v2x_pointpillar_basic_car $TAG)"
        MODEL.BEV_MAKER_EARLY.CKPT "$(ckpt_of $EARLY ${TAG}_sync)")
train train_disco $DISCO $EPOCHS_EGO $TAG DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_PREVIOUS True "${MAKERS[@]}"
train train_disco_sync $DISCO $EPOCHS_EGO ${TAG}_dsync DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_PREVIOUS False "${MAKERS[@]}"
ev disco_sync $DISCO ${TAG}_dsync DATA_CONFIG.EXCHANGE_PREVIOUS False
ev disco_async $DISCO $TAG DATA_CONFIG.EXCHANGE_PREVIOUS True
ev disco_xsync $DISCO $TAG DATA_CONFIG.EXCHANGE_PREVIOUS False
ev disco_xasync $DISCO ${TAG}_dsync DATA_CONFIG.EXCHANGE_PREVIOUS True
$PY -m pcp_tpu_torch.workspace.collect_results "$TAG" --output_root "$OUTPUT_ROOT" \
  $( [ -z "$SMOKE" ] && echo --export )
log "ALL DONE"
