#!/bin/bash
# The synthetic-world matrix on the port's CLIs, stage for stage as
# workspace/synth_experiments.sh runs it (its export_bench_ckpt aside: the
# port's bench reads results/bench_ckpt_torch.pt):
#   1. the car and the RSU sender; the exchange database cleared and
#      written by both; the lately ego and the early-fusion egos (sync and
#      async); the evals lately_sync, lately_async, lately_async_noflow,
#      early_sync, early_async and car; the six late-fusion rows (a host
#      model on the senders' boxes: NMS and weighted box fusion, sync and
#      async, async without flow and with oracle flow); the bandwidth of
#      each fusion mode; the lately ego fed oracle senders at eval only
#      (oracleswap) and with each sender's broadcast dropped with p 0.2 and
#      0.5 (drop02, drop05);
#   2. seed repeats (101, 202) of the lately ego and the sync early ego;
#   3. the single-agent ego; the lately ego trained and evaluated with
#      oracle senders (gt boxes and flow);
#   4. DiscoNet mid fusion async and sync (its frozen BEV makers from this
#      run's car, RSU and sync early-fusion checkpoints), matched
#      (disco_sync, disco_async) and crossed (disco_xsync: async-trained on
#      sync; disco_xasync: sync-trained on async);
#   5. the loose broadcast: both senders write a second database with score
#      threshold 0.03 and up to 200 boxes, and a lately ego trains and
#      evaluates on it;
# then the table is exported to results/<tag>_torch/.
#
#   SMOKE=1 pcp_tpu_torch/workspace/synth_experiments.sh   # tiny world, 2 epochs
#   VF=1 pcp_tpu_torch/workspace/synth_experiments.sh      # visible-faces world (tag synvf)
#
# Every output lies under $OUTPUT_ROOT (default output/torch), the exchange
# databases too: the JAX package's database is keyed by the same sample
# tokens, and one written from another world would poison the ego's
# training. A full (not SMOKE) run also writes the bandwidth to
# results/<tag>_torch/bandwidth.json. WORKERS (default 4) is handed to the
# loaders. Stages write markers into $OUTPUT_ROOT/stamps_<tag>, so a rerun
# resumes after the last finished one; a failing stage stops the pipeline.
# ONLY, a bash regular expression, runs just the stages whose names it
# matches (e.g.
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
LOOSE=$OUTPUT_ROOT/exchange_database_loose_$TAG

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

train() {  # train <stagename> <cfg> <epochs> <train tag> [--seed N] [extra --set pairs...]
  local name=$1 cfgf=$2 epochs=$3 tag=$4 seed=(); shift 4
  if [ "$1" = --seed ]; then seed=(--seed "$2"); shift 2; fi
  run_stage "$name" $PY -m pcp_tpu_torch.tools.train --cfg_file $CFGS/$cfgf.yaml \
    --batch_size 4 --epochs "$epochs" --extra_tag "$tag" "${seed[@]}" --num_epochs_to_eval 0 \
    --profile "${ARGS[@]}" --set "${COMMON_SET[@]}" "$@"
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

gen() {  # gen <stagename> <agent> <database> [extra flags...]
  local name=$1 agent=$2 db=$3; shift 3
  run_stage "$name" $PY -m pcp_tpu_torch.workspace.v2x_gen_exchange_database \
    --agent $agent --ckpt "$(ckpt_of v2x_pointpillar_basic_$agent $TAG)" --synthetic \
    --workers "$WORKERS" --out_dir "$db" "$@" \
    --set MAX_POINTS_PER_SAMPLE "$NPTS" SYNTHETIC "$SYN" MINI_TRAINVAL_STRIDE 1
}

EGO=v2x_pointpillar_basic_ego EARLY=v2x_pointpillar_basic_ego_early
# ===== 1. the senders, the exchange, the headline rows and their ablations
train train_car v2x_pointpillar_basic_car $EPOCHS_CAR $TAG DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 4
train train_rsu v2x_pointpillar_basic_rsu $EPOCHS_CAR $TAG DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1
run_stage clean_exchange rm -rf "$EXCHANGE" "$LOOSE"
gen gen_exchange_car car "$EXCHANGE"
gen gen_exchange_rsu rsu "$EXCHANGE"
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
# the bandwidth of each fusion mode (host only: the datasets and the database)
BANDWIDTH=(); [ -z "$SMOKE" ] && BANDWIDTH=(--json "results/${TAG}_torch/bandwidth.json")
run_stage measure_bandwidth $PY -m pcp_tpu_torch.workspace.measure_exchange_size --synthetic \
  "${BANDWIDTH[@]}" --set MAX_POINTS_PER_SAMPLE "$NPTS" SYNTHETIC "$SYN" MINI_TRAINVAL_STRIDE 1 \
  EXCHANGE_DATABASE_DIRECTORY "$EXCHANGE"
# oracle senders at eval only, on the ego trained with the real senders
ev lately_oracleswap_sync $EGO $TAG DATA_CONFIG.EXCHANGE_ORACLE True DATA_CONFIG.EXCHANGE_NOW True
ev lately_oracleswap_async $EGO $TAG DATA_CONFIG.EXCHANGE_ORACLE True
# a lossy broadcast: each sender's message dropped at eval (a hash of the sample)
ev lately_drop02_sync $EGO $TAG DATA_CONFIG.EXCHANGE_NOW True DATA_CONFIG.EXCHANGE_DROPOUT 0.2
ev lately_drop02_async $EGO $TAG DATA_CONFIG.EXCHANGE_DROPOUT 0.2
ev lately_drop05_sync $EGO $TAG DATA_CONFIG.EXCHANGE_NOW True DATA_CONFIG.EXCHANGE_DROPOUT 0.5
ev lately_drop05_async $EGO $TAG DATA_CONFIG.EXCHANGE_DROPOUT 0.5
# ===== 2. seed repeats of the lately ego and the sync early ego (training
# draws only: the world is the same)
for SEED in 101 202; do
  train train_ego_s$SEED $EGO $EPOCHS_EGO ${TAG}_s$SEED --seed $SEED DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1
  ev lately_sync_s$SEED $EGO ${TAG}_s$SEED DATA_CONFIG.EXCHANGE_NOW True
  ev lately_async_s$SEED $EGO ${TAG}_s$SEED
  train train_early_sync_s$SEED $EARLY $EPOCHS_EGO ${TAG}_sync_s$SEED --seed $SEED \
    DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 DATA_CONFIG.EXCHANGE_PREVIOUS False
  ev early_sync_s$SEED $EARLY ${TAG}_sync_s$SEED DATA_CONFIG.EXCHANGE_PREVIOUS False
done
# ===== 3. the single-agent floor and the oracle-sender ceiling
# single agent: the same ego val samples and merged gt, exchange off
train train_single $EGO $EPOCHS_EGO ${TAG}_nocollab DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_MODAR False
ev single $EGO ${TAG}_nocollab DATA_CONFIG.EXCHANGE_MODAR False
# oracle senders (gt boxes, exact constant-velocity flow), matched training
train train_ego_oracle $EGO $EPOCHS_EGO ${TAG}_oracle DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  DATA_CONFIG.EXCHANGE_ORACLE True
ev lately_oracle_sync $EGO ${TAG}_oracle DATA_CONFIG.EXCHANGE_ORACLE True DATA_CONFIG.EXCHANGE_NOW True
ev lately_oracle_async $EGO ${TAG}_oracle DATA_CONFIG.EXCHANGE_ORACLE True
# ===== 4. mid fusion (DiscoNet): frozen makers from this run's car, RSU and
# sync early ego; matched training per latency column, plus the cross cells
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
# ===== 5. the loose broadcast: the senders' score threshold 0.03 and up to
# 200 boxes a cloud, into a second database; a lately ego trained on it
LOOSE_SET=(DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY "$LOOSE")
gen gen_exchange_loose_car car "$LOOSE" --broadcast_score_thresh 0.03 --broadcast_post_max 200
gen gen_exchange_loose_rsu rsu "$LOOSE" --broadcast_score_thresh 0.03 --broadcast_post_max 200
train train_ego_loose $EGO $EPOCHS_EGO ${TAG}_loose DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1 \
  "${LOOSE_SET[@]}"
ev lately_loose_sync $EGO ${TAG}_loose DATA_CONFIG.EXCHANGE_NOW True "${LOOSE_SET[@]}"
ev lately_loose_async $EGO ${TAG}_loose "${LOOSE_SET[@]}"
$PY -m pcp_tpu_torch.workspace.collect_results "$TAG" --output_root "$OUTPUT_ROOT" \
  $( [ -z "$SMOKE" ] && echo --export )
log "ALL DONE"
