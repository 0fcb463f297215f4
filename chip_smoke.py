"""Smoke run of the PyTorch port (pcp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; a failing phase raises and the script
exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build: every CUDA kernel of the port, compiled from ``pcp_tpu_torch/ops/csrc``
   with ``-Xptxas -v``; for the fused and the one-hot kernel, what ptxas
   printed and registers, shared memory, spills and resident blocks an SM.
3. kernels: each of the five BEV scatter-max kernels against its plain
   PyTorch version at the main path's shapes (b8 x 32768 points, 64 channels,
   512x512 grid, the "realistic" occupancy of bench.py), plus edge cases
   (all padding, one pillar with -0.0, long runs across tile borders, about
   100 real rows in the whole batch, a few crowded tiles between long empty
   stretches, odd sizes); equality must be exact, for the one-hot kernel within rtol 1.2e-7.
   Every variant also against the default kernel's output, and the gradient
   through each kernel forward against that through its plain forward. Times
   (median of 20 CUDA-event timings after warm-up, one call a timing) of the
   kernel, the plain version and one library call, beside the kernel's least
   possible time; and the kernel's device time (5 launches in a row a
   timing, so that the host's way to the launch does not count).
4. slice: the lately-fusion ego CenterPoint from
   ``v2x_pointpillar_basic_ego.yaml`` at full width on the card, with weights
   made from ``--seed``, under each ``MODEL.VFE.PRE_REDUCE`` setting (unset,
   True, fused, onehot). One b8 forward with every launch count at 0 before
   it: exactly the setting's kernel must have 1 launch after it; BEV and
   final boxes must equal the default setting's (that forward runs under
   ``torch.use_deterministic_algorithms``, the timed ones do not). b1 on the card against b1
   on the CPU for unset and fused; then the forward's and the stages' times
   (20 iterations for the default setting, 10 for the others). The default
   setting once more with the trained checkpoint
   (``results/bench_ckpt_torch.pt``): NMS candidates a cloud beside the
   seeded weights', b1 card against CPU, the forward and its stages.
5. train: the same model trained on the card at b4 x 32768 points
   (``BATCH_SIZE_PER_GPU``; ``MAX_POINTS_PER_SAMPLE`` as the synthetic-data
   train recipe sets it), synthetic car boxes
   (about 30 a cloud, on pillar centres of the cloud), initial weights from
   ``create_train_state`` seeded by ``--seed``, the config's adam_onecycle.
   It overfits one batch in up to 50 steps (every loss finite, the last
   under 0.7 of the first), each step launching ``bev_scatter_max`` once and
   no other kernel; one step under each other ``PRE_REDUCE`` setting
   launches its own kernel once, and under deterministic algorithms its
   parameter gradients equal the default setting's (exactly for the tails
   and fused kernels, within a stated tolerance for the one-hot kernel).
   One b1 step on the card against the same step on the CPU: loss, every
   gradient after the clip, running statistics, the largest error of each
   module group beside its limit (a group whose limit the CPU's own spread
   puts at GRAD_LIMIT_CAP or more is reported as loosely held). Then the b4 step time (host clock,
   median of 10 after 3 warm-ups), samples/s, the split into forward+loss,
   backward and optimizer (CUDA events) and the peak memory.
6. exchange: the car and then the RSU sender (CenterPoint with the HunterJr
   corrector, ``v2x_pointpillar_basic_{car,rsu}.yaml``) at full width on the
   card, weights from ``--seed`` with the seg head's output bias shifted so
   that both branches of the corrector run and the writer has foreground to
   send (``balance_seg_bias``), b4 (``BATCH_SIZE_PER_GPU``) x 65536
   7-feature points with a padding tail. One deterministic forward with
   every launch count at 0 before it: exactly one launch of
   ``bev_scatter_max``; the points the corrector moved and left; B1 on the
   inputs that forward gave it against its plain version (exact) and timed
   at that shape; b1 card against b1 CPU (tolerances printed); the b4
   forward's time (median of 20 after 3 warm-ups), clouds/s, stages with
   the corrector split in three, peak memory. Then both senders broadcast
   through the port's writer into an exchange database under ``build/``
   (two keyframes: the car's clouds are lidars 2-5, the RSU's first two
   lidar 0), the ego reads each boxflow back with
   ``load_and_propagate_modar``, moves it into its frame with seeded poses
   and appends it with ``modar_to_points`` to two ego clouds of 32768 raw
   rows; every MoDAR row must equal the sender's valid box after
   propagation and the pose (computed on the card); the ego forward on the
   merged batch launches ``bev_scatter_max`` once and equals the CPU's.
7. sender_train: the car and then the RSU trained at full width on the card,
   b4 x 65536 7-feature points (``sender_train_batch``: 48 instances a cloud
   padded to 256, a fifth of the points on them, a quarter of them moving,
   gt boxes padded to 500, a padding tail), initial weights from
   ``create_train_state``, the config's adam_onecycle. SENDER_TRAIN_STEPS
   steps on one batch with every launch count at 0 before them: one
   ``bev_scatter_max`` a step and no other kernel, every loss and tb key
   finite, the loss falling; B1 on the inputs the first step gave it against
   its plain version (exact) and timed there; the step's time (host clock,
   median of 10 after 3 warm-ups), samples/s, its forward+loss / backward /
   optimizer split, a ``torch.profiler`` trace of one step (top device
   operations, idle share), the training forward's stages, the memory held
   for the backward and the peak memory; one b1 step from seeded weights on the
   card against the CPU as phase 5 holds the ego's, the points' class
   probabilities and flow too, with the corrector's discrete decisions of the
   card and of the CPU at half its threads pinned to the CPU's, each one
   that would differ within its noise band of the boundary.
8. bench: ``pcp_tpu_torch/bench.py`` with the trained checkpoint (its
   profile lines, and its result line printed before the last three lines);
   the timed passes launch ``bev_scatter_max`` once a forward.
9. pipeline: the ``SMOKE=1`` stages of
   ``pcp_tpu_torch/workspace/synth_experiments.sh`` through the port's CLIs
   (their ``main``), in ``build/pipeline``: the car and the RSU trained 2
   epochs at 16384 points on the SMOKE world, both exchange passes, the
   lately ego and the sync early-fusion ego trained 2 epochs, the
   evaluations lately_sync, lately_async, early_sync and car, the late-fusion
   evaluations late_sync and late_sync_wnms (a host model on the exchanged
   boxes), the lately ego evaluated with oracle senders swapped in
   (lately_oracleswap_sync: every MoDAR row of its items must carry score 1)
   and with each broadcast dropped with p 0.5 (lately_drop05_async: more
   agents must send the ego no MoDAR row than in lately_async, by the
   items' ``metadata["exchange"]``), then the single-agent ego trained and
   evaluated. The car's training and the lately_async evaluation load
   through 4 spawned workers, the other stages in the main process. Each
   stage's
   seconds and kernel launches (every launch count at 0 before it; a
   network stage must launch ``bev_scatter_max`` and no other kernel, a
   late-fusion stage none); for training the steps, the median data and
   step milliseconds a batch, the losses (finite) and the device's idle
   share of the traced steps; for the exchange the clouds written; for
   evaluations mAP, NDS and recall (finite). Then DiscoNet trained sync
   (``train_disco_sync``, its frozen makers from this phase's car, RSU and
   sync early checkpoints: the saved makers must hold those checkpoints'
   VFE and backbone tensors, bitwise) and evaluated (``eval_disco_sync``).
   B1 on the inputs of the lately ego's, the early ego's and DiscoNet's
   first training step (its RSU maker's branch) and of the oracle-swap and
   dropout evaluations' first batch against its plain version (exact),
   timed there.
10. disco (run after phase 8, before phase 9): DiscoNet mid fusion at full
   width on the card, seeded weights, b4 x 32768 merged clouds of six agents
   from the DiscoNet dataset on a few scenes of the synvf world, agent 3
   taken out of the second sample. One eval forward with every count at 0:
   6 launches of ``bev_scatter_max`` (the ego, the RSU maker, the car maker
   for agents 2-5), no other kernel; B1 exact against its plain version on
   the car maker's agent-3 branch (the second sample all sentinels), timed
   there; the eval forward's time, stages (the three makers, the ego's VFE,
   scatter and backbone, the fusion, the head), the makers' share and peak
   memory; one agent's compressed BEV in bytes beside phase 6's boxflow; b1
   (the sample with the absent agent) card against CPU: the ego's BEV
   (1e-5), each agent's BEV (1e-4), the surviving boxes under the margin
   rule. Then DISCO_STEPS training steps on the batch from
   ``create_train_state``: 7 launches a step (the early maker too), the
   loss falling, ``distill_loss`` finite, the makers' parameters and
   buffers bitwise unchanged and without gradients; the step's time, its
   split (the makers' forward from the stages, the ego's forward and loss,
   backward, optimizer), the training forward's stages and peak memory.
11. serving (run after phase 8): the trained ego at b8 x 32768 on the
   bench's first batch under each of the bench's serving modes
   (``pcp_tpu_torch/bench.py``: ``--fold-bn``, ``--wpack``, both,
   ``--bf16``, ``--bf16 --fold-bn``, ``--pre-reduce 1``, ``--pre-reduce
   fused``), TF32 off: each mode's counted forward (deterministic) launches
   its kernel once; FOLD_BN and W_PACK equal the float32 forward within the
   CPU tests' tolerances (2e-5, 1e-5, 1e-4 both) with the surviving boxes
   matched under the margin rule; BF16's hm logits within max 0.2, mean
   0.02 of float32's, with the share of float32 boxes a BF16 box matches;
   the ``PRE_REDUCE`` modes' BEV and boxes equal float32's and B2 / B3
   exact against their plain versions on the forward's own inputs, timed
   there. One bench timing (8 batches, best of 2) and the stages a mode.
12. dp (after phase 11): ``entry.dryrun_multichip`` over NCCL on every
   card (the JAX package's gate: full grid, one sample a rank, the staged
   boxflow database, three steps with the loss falling, a merged eval), then
   two spawned ranks sharing the card over gloo on CUDA tensors against one
   process, TF32 off in every process, each model at full width on its
   global batch: the ego (b2 x 32768), the car (b2 x 65536, phase 7's
   batch) and DiscoNet (b2 merged clouds, phase 10's, agent 3 out of the
   second). In float32 through B1 (a rank's step launches it once, seven
   times for DiscoNet) the loss, terms, statistics, gradient and parameters
   after the Adam step against the standard one-process step (the car's
   ranks take the one process's corrector decisions where theirs differ),
   and for the ego, tighter, against the one-process step rounding as the
   ranks do; in float64 (the scatter's plain version) everything within
   1e-9; the ranks bitwise equal; the ego's step time. The ego in BF16 too:
   two ranks against one process, both in BF16.
13. bf16_train (after phase 12): the full-width ego's BF16 train step
   (``MODEL.BF16``) at b4 x 32768 against its float32 step from the same
   weights and batch: loss, terms, each gradient leaf over its largest |g|
   and in norm, running statistics, each within a limit read on the card
   first; one B1 launch a step; parameters, optimizer moments and
   statistics float32; each step's time, its forward+loss / backward /
   optimizer split on the card and on the host, and peak memory.

a11. (after phase 9) the anchor-head PointPillar car
   (``v2x_pointpillar_anchor_car.yaml``) and SECOND's car, RSU and ego
   (``v2x_second_{car,rsu,ego}.yaml``) at full width on the card, weights
   from ``--seed`` (the senders' seg bias balanced as in phase 6, the anchor
   head's cls bias so that a fifth of the anchors pass SCORE_THRESH), b4
   x 65536 points (the ego 32768). For each: one deterministic forward with
   every count at 0 (the anchor car exactly one B1 launch, SECOND none; the
   voxels kept and each level's active sites printed); B1 exact on the
   anchor car's inputs, timed beside its bound; b1 card against CPU (the
   senders as phase 6 holds them, the others: voxel and output ids equal,
   the BEV, the head, the boxes under the margin rule); the forward's time,
   stages (vfe, backbone_3d, map_to_bev, backbone_2d, corrector, the head's
   convs, post-processing) and peak memory; A11_TRAIN_STEPS steps on one
   batch (launches as in the forward, every loss finite, the last under the
   first), the step's time, split, stages and peak memory, and a b1 step
   against the CPU held as phase 5 holds the ego's (the SECOND car leaves
   out the step's; the RSU, whose model is the car's, runs only in the CLI
   stages; see A11_MODELS). Then the CLIs on the SMOKE world in
   ``build/a11``, loading in the main process: the anchor car, the SECOND
   car and the SECOND RSU trained A11_CLI_EPOCHS epochs, both SECOND
   senders broadcast into ``exchange_database_second``, the SECOND ego
   trained on it and
   evaluated (its items must carry MoDAR rows from there); each stage's
   seconds and launches.

jr. (after a11) the nuScenes "pointpillar_jr" family at full width on the
   card: ``pointpillar_jr_nomap``, ``_withmap``, ``_corr_withmap`` and
   ``oracle_pointpillar_jr_withmap`` (``tools/cfgs/nuscenes_models``: 512x512
   grid, the SCConv stride-4 backbone to 384 channels at 128x128, six
   CenterHeads of the ten classes with the vel and iou branches), weights
   from ``--seed`` (every hm output bias at JR_HM_BIAS, the corrector's seg
   bias balanced as in phase 6), b4 x 262144 points made as
   ``tests/test_nuscenes_stack.py`` makes them, at each config's width (7
   or 12 features; the VFE reads 5 or 10). For each: one deterministic
   forward with every count at 0 (one B1 launch, 9-column boxes); B1 exact
   on its inputs, timed beside its bound; b1 card against CPU (the VFE's
   BEV within JR_BEV_TOL, the head's input within JR_HEAD_INPUT_REL of its
   largest |value|, every head branch within JR_HEAD_TOL, each head's
   surviving boxes under the margin rule, the corrector's decisions as
   phase 6 holds them); the forward's time, stages
   (vfe, map_to_bev, backbone_2d, corrector, dense_head, post_processing)
   and peak memory; JR_TRAIN_STEPS train steps on 10-column gt (velocity),
   one B1 launch each, every loss finite, the step's time, split, stages
   and peak memory (the batch halved if a step does not fit). Then
   ``pointpillar_jr_corr_withmap_teacher``: its teacher overlaid bitwise
   from the oracle model's checkpoint of this phase, an eval forward, and
   the train step refusing with HunterJr's shape error where the JAX
   package's step fails. Then the CLIs in ``build/jr/nuscenes`` on a fake
   nuScenes database of 2 scenes of 3 keyframes after 9 sweeps of 26000
   points (``tests/torch_fake_devkit.py``):
   ``create_nuscenes_infos`` and a map raster an info without the devkit,
   OpenCV or matplotlib, and each model evaluated from this phase's weights
   (no CLI training: the dataset's gt has no velocity, and the JAX
   package's training step fails on it). Last the a11_2 check: the fake
   V2X-Sim database through ``NuScenesV2XSource``, the split, RSU and car
   info pickles, and one car forward on the card from them.

kitti. (after jr) KITTI data and PointRCNN (``kitti_models/pointrcnn.yaml``)
   at full width: a fake KITTI tree in ``build/kitti`` (four training and
   two validation frames of about 24000 returns, two or three objects of
   each class, ``tests/torch_fake_kitti.py``), its infos and gt database
   through ``create_kitti_infos``; the b2 x 16384 validation batch's eval
   forward (no kernel of the five launched: PointRCNN has no pillar VFE;
   proposals and boxes finite); b1 card against CPU (FPS and ball-query
   indices equal, the point features and scores and the ROI stage on the
   card's proposals within KITTI_TOL or 3x the CPU's 8-vs-4-thread spread,
   the surviving boxes under the margin rule, the proposal and the final
   NMS's kept indices equal on the card's own inputs); the forward's time,
   stages (backbone_3d, point_head, proposal_layer, roi_head,
   post_processing) and peak memory; KITTI_TRAIN_STEPS train steps on a
   training batch with gt_sampling, each loss finite, their times and peak
   memory, the last on jittered gt boxes handed in as ROIs (foreground for
   the ROI head's reg and corner losses; the reg tower's gradient nonzero
   and finite); then the train CLI for one epoch with gt_sampling and the test
   CLI's KITTI AP table. Phase a11's CLI stages train one epoch each
   (A11_CLI_EPOCHS; two until this phase came).

pvrcnn. (after kitti) PV-RCNN (``custom_models/pv_rcnn.yaml`` with
   ``entry.PVRCNN_Z_RANGE``: 40 z slices, a 1408 x 800 x 40 grid; every
   width as published) at full width: a fake custom tree in
   ``build/pvrcnn`` (four training and two validation frames of 32768
   returns), its infos through ``create_custom_infos``; the b2 x 32768
   validation batch's eval forward at a voxel budget of 40000 (no kernel of
   the five launched: the mean VFE has no scatter; 4096 keypoints, 300
   ROIs, boxes finite); b1 card against CPU (FPS and ball-query indices
   equal, the keypoint features and scores and the ROI stage on the card's
   proposals within PVRCNN_TOL or 3x the CPU's spread, the surviving boxes
   under the margin rule, the proposal and the final NMS's kept indices
   equal on the card's own inputs); the forward's time, stages and peak
   memory; PVRCNN_TRAIN_STEPS train steps at a budget of 16000, the last on
   jittered gt boxes handed in as ROIs (the reg tower's gradient nonzero
   and finite), their times and peak memory; PV-RCNN++
   (``entry.PVRCNN_PLUSPLUS`` over the config) at b1: an eval forward and
   one train step on jittered gt boxes handed in as ROIs (the reg tower's
   gradient nonzero and finite), their times and peak memory; then the
   train CLI for one epoch and the test CLI's KITTI AP table through
   MAP_CLASS_TO_KITTI.

The last three lines are the kernels' record (JSON, with the train phase's
numbers under ``"train"``, phase 6's under ``"senders"``, phase 7's under
``"sender_train"``, the trained ego's under ``"trained_ego"``, the bench's
profile under ``"bench_profile"``, phase 11's under ``"serving"``, phase
12's under ``"dp"``, phase 10's under ``"disco"``, phase 9's under
``"pipeline"`` and phase a11's under ``"a11"``; each kernel's launches in
each a11 model's forward, train step and CLI stage under
``"launches_per_a11_forward"``, ``"launches_per_a11_train_step"`` and
``"launches_in_a11_cli"``, and in each JR model's forward, train step and
CLI stage under ``"launches_per_jr_forward"``, ``"..._jr_train_step"`` and
``"launches_in_jr_cli"``, phase jr's record under ``"jr"``; in PointRCNN's
forward, train step and CLI stages under ``"launches_per_kitti_forward"``,
``"launches_per_kitti_train_step"`` and ``"launches_in_kitti_cli"``, phase
kitti's record under ``"kitti"``; in PV-RCNN's under
``"launches_per_pvrcnn_forward"``, ``"launches_per_pvrcnn_train_step"`` and
``"launches_in_pvrcnn_cli"``, in PV-RCNN++'s forward and train step under
``"launches_per_pvrcnn_plusplus_forward"`` and ``"..._train_step"``, phase
pvrcnn's record under ``"pvrcnn"``; in each pipeline stage under
``"launches_in_pipeline"``, in a DiscoNet eval forward and train step under
``"launches_per_disco_eval_forward"`` and ``"..._train_step"``, in a
serving mode's forward under ``"launches_per_serving_forward"``, in a
rank's DP step of each model under ``"launches_per_dp_step_per_rank"`` and
in a BF16 ego step under ``"launches_per_bf16_train_step"``; phase 12's
record, each model's comparisons among them, under ``"dp"`` and phase
13's under ``"bf16_train"``),
the card as nvidia-smi names it, and
``{"ok": true, "device": ...}``; the bench's line comes just before them.
Without a CUDA device the script exits 1 and prints no result.
"""
import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CFG_EGO = REPO / "tools" / "cfgs" / "v2x_sim_models" / "v2x_pointpillar_basic_ego.yaml"

# H100 SXM peaks from NVIDIA's data sheet: HBM3 bytes/s, f32 (non-tensor) ops/s,
# dense bf16 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

B, N, C, GRID = 8, 32768, 64, 512
PC_RANGE = (-51.2, -51.2)
VOXEL = 0.2


START = time.perf_counter()


def log(phase, msg):
    """One line ``[phase] seconds since the script started | msg``."""
    print(f"[{phase}] {time.perf_counter() - START:.1f} s | {msg}", flush=True)


def realistic_points(rng, b, n, num_features, n_pillars=4096):
    """bench.py's "realistic" profile: n_pillars random pillar centres per
    sample, each point within 0.1 m of one (about 8 points a pillar)."""
    pts = np.zeros((b, n, num_features), dtype=np.float32)
    centers = rng.uniform(-50, 50, size=(b, n_pillars, 2))
    idx = rng.integers(0, n_pillars, size=n)
    pts[..., 0:2] = centers[:, idx, :] + rng.uniform(-0.1, 0.1, size=(b, n, 2))
    pts[..., 2] = rng.uniform(-3.0, -0.5, size=(b, n))
    pts[..., 3] = rng.uniform(0, 1, size=(b, n))
    return pts


def cuda_ms(fn, warmup=3, iters=20, reps=1):
    """Median milliseconds of ``fn()`` over ``iters`` CUDA-event timings, each
    around ``reps`` calls in a row. With one call the card is idle when the
    first event is recorded, so the time the host takes to reach the launch
    counts; with several in a row the card always has the next launch queued
    and the time is the device's alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_device():
    from pcp_tpu_torch.bench import card_name

    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("device", "TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
                  "torch.backends.cudnn.allow_tf32 = False")
    return card


def phase_build():
    from pcp_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build()
    log("build", f"{len(libs)} kernel libraries in {time.perf_counter() - t0:.3f} s: "
                 + ", ".join(str(p.relative_to(REPO)) for p in libs.values()))
    from pcp_tpu_torch.ops import bev_scatter as bs

    for name in ("bev_scatter_fused", "bev_scatter_onehot"):
        for line in cuda_build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log("build", f"{name} ptxas: {line.strip()}")
        for c in (C, 24):
            log("build", f"{name} at c{c}: {bs.stream_kernel_resources(name, c)}")


def _sort_by_pid(feats, pids):
    """Numpy features and pids -> CUDA tensors sorted by pid within a sample."""
    dev = torch.device("cuda", 0)
    p, order = torch.sort(torch.from_numpy(pids).to(dev), dim=1, stable=True)
    f = torch.from_numpy(feats).to(dev)
    f = torch.gather(f, 1, order[..., None].expand(-1, -1, f.shape[2])).contiguous()
    return f, p.contiguous()


def _sorted_scatter_inputs(rng):
    """Pillar-sorted ReLU features and pids as the VFE hands them to the
    kernel: realistic occupancy with 1024 padding rows per sample."""
    hw = GRID * GRID
    pts = realistic_points(rng, B, N, 4)
    cx = np.floor((pts[..., 0] - PC_RANGE[0]) / VOXEL).astype(np.int64)
    cy = np.floor((pts[..., 1] - PC_RANGE[1]) / VOXEL).astype(np.int64)
    pids = (cy * GRID + cx).astype(np.int32)
    pids[:, -1024:] = hw
    feats = np.maximum(rng.standard_normal((B, N, C)).astype(np.float32), 0.0)
    return _sort_by_pid(feats, pids)


def kernel_table(bs):
    """Per kernel: its name, the line of the Pallas kernel it replaces, its
    public function, the stem of the wrappers of the kernel alone
    (``<stem>_cuda`` / ``<stem>_plain``), what makes the kernel's inputs from
    (feats, pids), and the rtol it is held to (0: exact equality)."""
    def same(f, p):
        return f, p

    def prereduced(f, p):
        red, tails = bs.prereduce(f, p)
        return red.contiguous(), p, tails.contiguous()

    return [
        ("bev_scatter_max", 341, "bev_scatter_max_sorted", "bev_scatter_max_sorted", same, 0.0),
        ("bev_scatter_tails", 33, "bev_scatter_max_sorted_prereduced", "bev_scatter_max_tails",
         prereduced, 0.0),
        ("bev_scatter_fused", 92, "bev_scatter_max_sorted_fused", "bev_scatter_max_sorted_fused",
         same, 0.0),
        ("bev_scatter_onehot", 256, "bev_scatter_max_sorted_onehot",
         "bev_scatter_max_sorted_onehot", same, bs.ONEHOT_RTOL),
        ("bev_scatter_runs", 176, "bev_scatter_max_runs", "bev_scatter_max_runs", same, 0.0),
    ]


def _hold(got, want, rtol, what):
    """Raise unless ``got`` equals ``want``: exactly for rtol 0, else within
    rtol and atol 0. Returns the largest absolute error."""
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if rtol:
        torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=lambda m: f"{what}: {m}")
    elif not torch.equal(got, want):
        raise AssertionError(f"{what}: not equal, max_abs_err {err}")
    return err


def scatter_bound(feats, pids, hw, tails=None):
    """(bytes, least ms by bytes, least ms by operations) of a scatter of
    these sorted rows into a (B, hw, C) grid. Only the features of rows
    whose pid lies on the grid are needed (for the tails kernel, only those
    of each pillar's last row): a sentinel row costs its pid alone. Every
    pid (and tails flag) is read once, the grid written once; one max per
    needed feature (none for the tails kernel, whose rows arrive reduced)."""
    b, _, c = feats.shape
    rows = pids < hw
    if tails is not None:
        rows = rows & tails.bool()
    needed = rows.sum().item() * c
    bytes_moved = (needed * feats.element_size() + pids.numel() * pids.element_size()
                   + (0 if tails is None else tails.numel() * tails.element_size())
                   + b * hw * c * feats.element_size())
    ops = 0 if tails is not None else needed
    return bytes_moved, bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def onehot_product_ops(pids, hw, tile_cells, chunk, span_tiles, cp):
    """Tensor-core operations the one-hot kernel does on these sorted pids,
    counted as its walk makes the chunks. A block takes ``span_tiles`` tiles
    of one sample; its windows of ``chunk`` rows start at the span's first
    row, and a chunk is what one window holds of one tile, so a tile that
    straddles a window's border costs two. Every chunk is one
    (tile_cells x chunk) @ (chunk x 3*cp) product, where cp is the channels
    padded to the kernel's groups."""
    b, n = pids.shape
    tile = pids.long() // tile_cells
    span_cell0 = tile // span_tiles * (span_tiles * tile_cells)
    first_row = torch.searchsorted(pids.long(), span_cell0)  # of the row's span
    window = (torch.arange(n, device=pids.device) - first_row) // chunk
    starts = torch.ones_like(pids, dtype=torch.bool)  # the row opens a chunk
    starts[:, 1:] = (tile[:, 1:] != tile[:, :-1]) | (window[:, 1:] != window[:, :-1])
    chunks = (starts & (pids < hw)).sum().item()
    return chunks * 2 * tile_cells * chunk * 3 * cp


def phase_kernels(seed):
    from pcp_tpu_torch.ops import bev_scatter as bs

    rng = np.random.default_rng(seed)
    hw = GRID * GRID
    feats, pids = _sorted_scatter_inputs(rng)

    # edge cases at the same shapes: every row padding; every point in one
    # pillar, with some -0.0 features (they must come out as 0); runs of 100
    # rows in consecutive cells, which cross every tile border they meet and
    # every chunk; about 100 real rows in the whole batch, so that whole spans
    # of tiles are empty; six crowded tiles a sample (5000 rows each, many
    # chunks a tile, several tails a chunk) between long empty stretches; and
    # a small batch whose N, C and H*W are multiples of nothing the kernels
    # tile by
    all_pad = torch.full_like(pids, hw)
    one = torch.full_like(pids, 12345)
    neg_zero = feats.clone()
    neg_zero[:, ::7, ::3] = -0.0
    long_runs = torch.arange(N, device=pids.device, dtype=torch.int32) // 100 + 1000
    long_runs = long_runs[None].repeat(B, 1)
    long_runs[:, -500:] = hw
    nearly_empty = np.full((B, N), hw, dtype=np.int32)
    for i in range(B):
        nearly_empty[i, :12 + i] = rng.integers(0, hw, size=12 + i)
    nearly_empty = torch.from_numpy(np.sort(nearly_empty, axis=1)).to(pids.device)
    few_tiles = np.full((B, N), hw, dtype=np.int32)
    for i in range(B):
        starts = rng.choice(hw // 64 - 1, size=6, replace=False) * 64 + rng.integers(0, 64)
        few_tiles[i, :30000] = (np.repeat(starts, 5000) + rng.integers(0, 64, size=30000))
    few_tiles = torch.from_numpy(np.sort(few_tiles, axis=1)).to(pids.device)
    odd_hw = 20 * 13
    odd = _sort_by_pid(np.maximum(rng.standard_normal((3, 1000, 24)).astype(np.float32), 0.0),
                       rng.integers(0, odd_hw + 1, size=(3, 1000)).astype(np.int32))
    cases = {"realistic": (feats, pids, GRID, GRID), "all_padding": (feats, all_pad, GRID, GRID),
             "one_pillar": (neg_zero, one, GRID, GRID),
             "long_runs": (feats, long_runs, GRID, GRID),
             "nearly_empty": (feats, nearly_empty, GRID, GRID),
             "few_tiles": (feats, few_tiles, GRID, GRID),
             "odd_shapes": (*odd, 20, 13)}
    table = kernel_table(bs)
    max_err = {name: 0.0 for name, *_ in table}
    with torch.inference_mode():
        for case, (f, p, h, w) in cases.items():
            first = None
            for name, _, public, alone, prep, rtol in table:
                args = prep(f, p)
                got = getattr(bs, alone + "_cuda")(*args, h, w)
                want = getattr(bs, alone + "_plain")(*args, h, w)
                torch.cuda.synchronize()
                err = _hold(got, want, rtol, f"{name} kernel vs its plain version on {case}")
                max_err[name] = max(max_err[name], err)
                if first is None:
                    first = got
                    occupied = int((want.amax(-1) > 0).sum())
                    log("kernels", f"{case}: {tuple(f.shape)} on {h}x{w}, {occupied} occupied cells")
                else:
                    whole = got if alone == public else getattr(bs, public + "_cuda")(f, p, h, w)
                    _hold(whole, first, rtol, f"{public} vs bev_scatter_max's kernel on {case}")
                log("kernels", f"  {name}: max_abs_err {err} vs plain "
                               f"({f'rtol {rtol}, atol 0' if rtol else 'exact equality'} required)")
                del got, want
            del first

    # the shared backward on the card: the gradient through each kernel's
    # forward against the gradient through its plain forward, same tensors
    f, p, h, w = cases["odd_shapes"]
    weight = torch.from_numpy(rng.standard_normal((3, h, w, 24)).astype(np.float32)).cuda()
    for name, _, public, _, _, rtol in table:
        grads = []
        for fwd in (getattr(bs, public + "_cuda"), getattr(bs, public + "_plain")):
            leaf = f.clone().requires_grad_(True)
            out = bs.ScatterMax.apply(leaf, p, h, w, fwd, rtol)
            grads.append(torch.autograd.grad((out * weight).sum(), leaf)[0])
        public_leaf = f.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((getattr(bs, public)(public_leaf, p, h, w) * weight).sum(),
                                         public_leaf)[0])
        if not (torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])):
            raise AssertionError(f"{public}: gradient through the kernel != through the plain version")
        if not grads[0].any():
            raise AssertionError(f"{public}: gradient is all zero")
    log("kernels", "backward on odd_shapes: gradient through each kernel forward == through its "
                   "plain forward (torch.equal), 5 functions")

    records = {}
    with torch.inference_mode():
        zeros = torch.zeros((B, hw + 1, C), device=feats.device)
        idx = pids.long()[..., None].expand(B, N, C)
        for name, line, _, alone, prep, _ in table:
            args = prep(feats, pids)
            cuda_fn, plain_fn = getattr(bs, alone + "_cuda"), getattr(bs, alone + "_plain")
            # "ms" keys: one call per timing, which adds the host's way to the
            # launch; device_ms: 5 launches in a row per timing, so that the
            # card never waits for the host
            kernel_ms = cuda_ms(lambda: cuda_fn(*args, GRID, GRID))
            device_ms = cuda_ms(lambda: cuda_fn(*args, GRID, GRID), reps=5)
            plain_ms = cuda_ms(lambda: plain_fn(*args, GRID, GRID))
            library_ms = cuda_ms(lambda: torch.scatter_reduce(zeros, 1, idx, args[0], "amax",
                                                              include_self=True))
            # least time: the bytes the function needs over the HBM rate, or
            # the operations over their peak rate (scatter_bound), plus the
            # one-hot kernel's bf16 products
            bytes_moved, t_bytes, t_ops = scatter_bound(
                args[0], pids, hw, args[2] if name == "bev_scatter_tails" else None)
            if name == "bev_scatter_onehot":
                plan = bs.onehot_plan(B, C, hw, bs._sm_count(feats.device))
                cp = -(-C // plan["group"]) * plan["group"]
                t_ops += onehot_product_ops(pids, hw, bs.ONEHOT_TILE_CELLS, bs.ONEHOT_CHUNK,
                                            plan["span_tiles"], cp) / BF16_OPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            log("kernels", f"{name} b{B} n{N} c{C} {GRID}x{GRID}: kernel_ms {kernel_ms:.6f} "
                           f"(5 launches a timing: device_ms {device_ms:.6f}) plain_ms "
                           f"{plain_ms:.6f} library_ms {library_ms:.6f} "
                           f"(torch.scatter_reduce amax) bound_ms {bound_ms:.6f} "
                           f"({bytes_moved} bytes, operations {t_ops:.6f} ms)")
            records[name] = {
                "name": name, "route": "cuda", "source": f"pcp_tpu_torch/ops/csrc/{name}.cu",
                "replaces": f"pcp_tpu/ops/pallas/bev_scatter.py:{line}", "launches": None,
                "max_abs_err": max_err[name], "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "device_ms": device_ms}
        grid = torch.empty((B, GRID, GRID, C), device=feats.device)
        fill_ms, fill_device_ms = cuda_ms(grid.zero_), cuda_ms(grid.zero_, reps=5)
        log("kernels", f"for scale: zero_() of the (b{B}, {GRID}, {GRID}, {C}) grid alone, the write "
                       f"every kernel must do: {fill_ms:.6f} ms (5 calls a timing: device_ms "
                       f"{fill_device_ms:.6f})")
        # the streaming kernels on a batch of padding only: one search a block,
        # no row, every tile written as zeros -- their write path alone
        for name in ("bev_scatter_fused", "bev_scatter_onehot"):
            fn = getattr(bs, name.replace("bev_scatter_", "bev_scatter_max_sorted_") + "_cuda")
            pad_ms = cuda_ms(lambda: fn(feats, all_pad, GRID, GRID), reps=5)
            log("kernels", f"{name} on the all_padding batch (zeros only): device_ms {pad_ms:.6f}")
        pre_ms = cuda_ms(lambda: bs.prereduce(feats, pids))
        whole_ms = cuda_ms(lambda: bs.bev_scatter_max_sorted_prereduced_cuda(feats, pids, GRID, GRID))
        log("kernels", f"bev_scatter_tails' pre-reduction (torch ops, segmented max and tail flags) "
                       f"alone: {pre_ms:.6f} ms; bev_scatter_max_sorted_prereduced whole: {whole_ms:.6f} ms")
    return records


def seeded_state_dict(model, seed):
    """Weights for ``model`` from a numpy generator: conv, sparse conv and
    linear weights normal with std 1/sqrt(fan-in), BN affine and running
    statistics random, conv biases 0 except the hm output's -2.19, so that
    scores straddle SCORE_THRESH and NMS has candidates."""
    from torch import nn

    from pcp_tpu_torch.models.backbones_3d.spconv_backbone import SparseConv3d

    rng = np.random.default_rng(seed)
    sd = {}
    for name, m in model.named_modules():
        if isinstance(m, SparseConv3d):  # (Cout, kz, ky, kx, Cin): fan-in K * Cin
            sd[f"{name}.weight"] = rng.normal(0, m.weight[0].numel() ** -0.5, m.weight.shape)
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # a transposed conv with kernel == stride feeds each output from
            # one tap of every input channel
            fan_in = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            sd[f"{name}.weight"] = rng.normal(0, fan_in ** -0.5, w.shape)
            if m.bias is not None:
                is_hm_out = name.split(".")[-2] == "hm"  # the hm branch's last conv
                sd[f"{name}.bias"] = np.full(m.bias.shape, -2.19 if is_hm_out else 0.0)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            sd[f"{name}.weight"] = rng.uniform(0.8, 1.2, c)
            sd[f"{name}.bias"] = rng.normal(0, 0.1, c)
            sd[f"{name}.running_mean"] = rng.normal(0, 0.5, c)
            sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c)
            sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64 if k.endswith("tracked")
                                           else np.float32)) for k, v in sd.items()}


# MODEL.VFE.PRE_REDUCE value -> the kernel its forward must launch, once
SETTINGS = [(None, "bev_scatter_max"), (True, "bev_scatter_tails"),
            ("fused", "bev_scatter_fused"), ("onehot", "bev_scatter_onehot")]


def _card_vs_cpu(model, sd, batch, pre_reduce, pp, post_max, phase="slice", clouds=1):
    """The first ``clouds`` clouds of ``batch`` on the card against the same
    on the CPU, same weights and points. Returns the largest errors."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    _, _, cpu_model = build(CFG_EGO, device="cpu", pre_reduce=pre_reduce)
    cpu_model.load_state_dict(sd, strict=True)
    one = {k: v[:clouds] for k, v in batch.items()}
    with torch.inference_mode():
        gpu = model(one)
        t0 = time.perf_counter()
        cpu = cpu_model({k: v.cpu() for k, v in one.items()})
        cpu_s = time.perf_counter() - t0
    bev_err = (gpu["spatial_features"].cpu() - cpu["spatial_features"]).abs().max().item()
    torch.testing.assert_close(gpu["spatial_features"].cpu(), cpu["spatial_features"],
                               atol=1e-5, rtol=1e-5)
    head_err = {}
    for name, t in cpu["head_preds"][0].items():
        g = gpu["head_preds"][0][name].cpu()
        head_err[name] = (g - t).abs().max().item()
        torch.testing.assert_close(g, t, atol=1e-3, rtol=0)
    n_matched = 0
    for i in range(clouds):
        heat = torch.sigmoid(cpu["head_preds"][0]["hm"][i].double()).numpy().reshape(-1)
        n_matched += match_surviving_boxes(
            {k: v[i].cpu().numpy() for k, v in gpu["final_box_dicts"].items()},
            {k: v[i].numpy() for k, v in cpu["final_box_dicts"].items()}, heat,
            top_k=int(pp.MAX_OBJ_PER_SAMPLE), score_thresh=float(pp.SCORE_THRESH),
            post_max=post_max)
    log(phase, f"PRE_REDUCE {pre_reduce}: b{clouds} card vs CPU ({cpu_s:.1f} s on the CPU): BEV "
               f"max_abs_err {bev_err} (atol 1e-5, rtol 1e-5); head max_abs_err {head_err} "
               f"(atol 1e-3); {n_matched} surviving boxes matched under the margin rule")
    return {"bev": bev_err, "head": head_err, "boxes_matched": n_matched, "cpu_s": cpu_s}


def phase_slice(seed):
    """The full-width ego model under every PRE_REDUCE setting. Returns
    ``{kernel: launches in one forward of its setting}``."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter

    launches, default_out, sd, batch, vfes = {}, None, None, None, {}
    for pre_reduce, kernel in SETTINGS:
        cfg, info, model = build(CFG_EGO, device="cuda", pre_reduce=pre_reduce)
        if sd is None:  # PRE_REDUCE adds no parameter: one weight set for all settings
            sd = seeded_state_dict(model, seed)
            pts = realistic_points(np.random.default_rng(seed + 1), B, N, info.num_point_features)
            batch = {"points": torch.from_numpy(pts).cuda(),
                     "points_mask": torch.ones((B, N), dtype=torch.bool, device="cuda")}
        model.load_state_dict(sd, strict=True)
        pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
        post_max = int(pp.NMS_CONFIG.NMS_POST_MAXSIZE)

        # Sums by index_add_ in front of the scatter use float atomics, whose
        # order changes from run to run; this one forward runs with PyTorch's
        # deterministic algorithms so that two settings can be held to equality.
        torch.use_deterministic_algorithms(True, warn_only=True)
        with torch.inference_mode():
            bev_scatter.reset_launches()
            out = model(batch)
            torch.cuda.synchronize()
            counts = dict(bev_scatter.launches)
        torch.use_deterministic_algorithms(False)
        log("slice", f"PRE_REDUCE {pre_reduce}: one b{B} x {N} forward of the ego model: "
                     f"kernel launches {counts}")
        if counts != {k: int(k == kernel) for k in counts}:
            raise AssertionError(f"PRE_REDUCE {pre_reduce}: expected one launch of {kernel} and "
                                 f"none of the others, got {counts}")
        launches[kernel] = counts[kernel]
        fbd = out["final_box_dicts"]
        boxes, valid = fbd["pred_boxes"], fbd["pred_valid"]
        if tuple(boxes.shape) != (B, post_max, 7) or not torch.isfinite(boxes).all():
            raise AssertionError(f"pred_boxes {tuple(boxes.shape)}, finite "
                                 f"{bool(torch.isfinite(boxes).all())}")
        if not valid.any():
            raise AssertionError("no valid box in the b8 forward")
        if default_out is None:
            default_out = out
            log("slice", f"pred_boxes {tuple(boxes.shape)} finite; valid boxes per cloud "
                         f"{valid.sum(1).tolist()}")
        else:
            bev_err = _hold(out["spatial_features"], default_out["spatial_features"],
                            bev_scatter.ONEHOT_RTOL if kernel == "bev_scatter_onehot" else 0.0,
                            f"PRE_REDUCE {pre_reduce}: BEV vs the default setting's")
            for key, value in default_out["final_box_dicts"].items():
                if not torch.equal(fbd[key], value):
                    raise AssertionError(f"PRE_REDUCE {pre_reduce}: {key} differs from the "
                                         "default setting's")
            log("slice", f"PRE_REDUCE {pre_reduce}: BEV max_abs_err {bev_err} vs the default "
                         "setting's; final boxes identical")

        if pre_reduce in (None, "fused"):
            _card_vs_cpu(model, sd, batch, pre_reduce, pp, post_max)

        iters = 20 if pre_reduce is None else 10
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(batch), warmup=3, iters=iters)
            stages = stage_ms(serving_stages(model), batch)
        log("slice", f"PRE_REDUCE {pre_reduce}: forward b{B} x {N} points, full width, seeded "
                     f"weights, TF32 off: median {ms:.6f} ms over {iters} iterations, "
                     f"{B / ms * 1e3:.3f} clouds/s")
        log("slice", f"PRE_REDUCE {pre_reduce}: stages (median ms of 10, CUDA events between "
                     "stages): " + ", ".join(f"{k} {v:.6f}" for k, v in stages.items()))
        if pre_reduce is None:
            trained = with_trained_weights(model, batch, pp, post_max, default_out, ms, stages)
        vfes[pre_reduce] = model.vfe
        del model

    # the stage the setting changes, alone and in turns, so that the settings
    # share the card's state: median over 3 rounds of the median of 20
    with torch.inference_mode():
        rounds = {k: [] for k in vfes}
        for _ in range(3):
            for k, vfe in vfes.items():
                rounds[k].append(cuda_ms(lambda: vfe(batch)))
    log("slice", "vfe alone, settings in turns (median of 3 rounds of the median of 20, ms): "
                 + ", ".join(f"PRE_REDUCE {k}: {statistics.median(v):.6f}" for k, v in rounds.items()))
    return launches, trained


def nms_candidates(head_preds, pp):
    """Boxes each cloud hands to NMS: of its MAX_OBJ_PER_SAMPLE best
    heatmap scores, those over SCORE_THRESH."""
    hm = torch.sigmoid(head_preds[0]["hm"].float()).flatten(1)
    top = hm.topk(int(pp.MAX_OBJ_PER_SAMPLE), dim=1).values
    return (top > float(pp.SCORE_THRESH)).sum(1).tolist()


def with_trained_weights(model, batch, pp, post_max, seeded_out, seeded_ms, seeded_stages):
    """The default setting's forward again with the trained checkpoint
    (``results/bench_ckpt_torch.pt``, loaded with strict=True): the NMS
    candidates and boxes a cloud, b1 card against CPU, the forward's time
    and its stages beside the seeded weights'. Returns the record."""
    from pcp_tpu_torch.bench import CKPT

    sd = torch.load(CKPT, map_location="cuda", weights_only=True)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        out = model(batch)
    valid = out["final_box_dicts"]["pred_valid"].sum(1).tolist()
    cand = {"seeded": nms_candidates(seeded_out["head_preds"], pp),
            "trained": nms_candidates(out["head_preds"], pp)}
    if not all(valid) or not torch.isfinite(out["final_box_dicts"]["pred_boxes"]).all():
        raise AssertionError(f"trained weights: valid boxes per cloud {valid}")
    log("slice", f"trained checkpoint {CKPT.relative_to(REPO)}: NMS candidates per cloud "
                 f"{cand['trained']} (seeded weights: {cand['seeded']}); valid boxes per cloud {valid}")
    # the trained VFE's BN scales amplify the order in which the card's
    # atomics sum the pillar means: its forward runs deterministic here
    torch.use_deterministic_algorithms(True, warn_only=True)
    check = _card_vs_cpu(model, sd, batch, None, pp, post_max)
    torch.use_deterministic_algorithms(False)
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(batch), warmup=3, iters=20)
        stages = stage_ms(serving_stages(model), batch)
    log("slice", f"trained checkpoint: forward b{B} x {N} median {ms:.6f} ms over 20 iterations, "
                 f"{B / ms * 1e3:.3f} clouds/s (seeded weights: {seeded_ms:.6f} ms); stages "
                 "(median ms of 10): " + ", ".join(f"{k} {v:.6f} (seeded {seeded_stages[k]:.6f})"
                                                   for k, v in stages.items()))
    return {"forward_ms": ms, "clouds_per_s": B / ms * 1e3, "stages_ms": stages,
            "seeded_forward_ms": seeded_ms, "seeded_stages_ms": seeded_stages,
            "nms_candidates": cand, "valid_boxes": valid, "card_vs_cpu": check}


def serving_stages(model):
    """The eval forward cut at module boundaries: (name, fn) in order."""
    head = model.dense_head
    return [("vfe", model.vfe), ("map_to_bev", model.map_to_bev),
            ("backbone_2d", model.backbone_2d),
            ("head_convs", lambda d: dict(d, head_preds=[h(head.shared_conv(
                d["spatial_features_2d"])) for h in head.heads_list])),
            ("decode_nms", lambda d: dict(d, final_box_dicts=head.generate_predicted_boxes(
                d["head_preds"])))]


def stage_ms(stages, batch, iters=10):
    """``stages`` run in turn on ``batch``, each timed with CUDA events
    recorded between them; median ms per stage."""
    times = {name: [] for name, _ in stages}
    for it in range(iters + 2):  # two warm-up passes
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        d = dict(batch)
        events[0].record()
        for i, (_, fn) in enumerate(stages):
            d = fn(d)
            events[i + 1].record()
        events[-1].synchronize()
        if it >= 2:
            for i, (name, _) in enumerate(stages):
                times[name].append(events[i].elapsed_time(events[i + 1]))
    return {name: statistics.median(t) for name, t in times.items()}


# --------------------------------------------------------------- 5. train

TRAIN_STEPS = 50  # the overfit run: up to this many steps on one batch
# card against CPU, one b1 step: loss rtol; a gradient leaf's largest error
# over its largest |g|; conv biases in front of a BN (gradient 0 in exact
# arithmetic) against the model's largest |g|; running statistics. At this
# depth and these initial weights the training-mode network amplifies
# rounding: the CPU's own step differs by up to 13% of a leaf's largest |g|
# between two thread counts, which only reorder its sums. So each quantity
# is held to the larger of its tolerance here and SPREAD_FACTOR times that
# spread, measured in the same run. A gradient group whose limit comes to
# GRAD_LIMIT_CAP or more is reported as loosely held: there a gradient of
# half its size would pass.
LOSS_RTOL, GRAD_RTOL, GRAD_ZERO_ATOL, STATS_ATOL = 1e-5, 1e-4, 1e-6, 1e-5
SPREAD_FACTOR = 3.0
GRAD_LIMIT_CAP = 0.5
# one-hot setting against the default, same step: its BEV rounds by up to
# 2^-23 relative, which the backbone carries into every gradient
ONEHOT_GRAD_RTOL = 1e-3


def train_batch(rng, b, n, info, boxes_per_cloud=30):
    """``realistic_points`` and car boxes (class 1, 4.2 x 1.8 x 1.6, random
    yaw) centred on pillar centres of the cloud, ``boxes_per_cloud`` a cloud,
    padded to 500 rows as the target assigner takes them."""
    pts = realistic_points(rng, b, n, info.num_point_features)
    gt = np.zeros((b, 500, 8), np.float32)
    vx, vy = info.voxel_size[0], info.voxel_size[1]
    for i in range(b):
        rows = rng.choice(n, size=boxes_per_cloud, replace=False)
        cx = np.floor((pts[i, rows, 0] - info.point_cloud_range[0]) / vx)
        cy = np.floor((pts[i, rows, 1] - info.point_cloud_range[1]) / vy)
        gt[i, :boxes_per_cloud, 0] = info.point_cloud_range[0] + (cx + 0.5) * vx
        gt[i, :boxes_per_cloud, 1] = info.point_cloud_range[1] + (cy + 0.5) * vy
        gt[i, :boxes_per_cloud, 2] = -1.0
        gt[i, :boxes_per_cloud, 3:6] = [4.2, 1.8, 1.6]
        gt[i, :boxes_per_cloud, 6] = rng.uniform(-np.pi, np.pi, boxes_per_cloud)
        gt[i, :boxes_per_cloud, 7] = 1
    return {"points": torch.from_numpy(pts), "points_mask": torch.ones((b, n), dtype=torch.bool),
            "gt_boxes": torch.from_numpy(gt)}


def _on(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def _one_step(model, state_dict, cfg, batch, pin=None):
    """Load ``state_dict`` and take one train step with a fresh optimizer,
    a sender's corrector decisions pinned to those of the step ``pin``
    (``pin_decisions``) where one is given. Returns the loss, tb, gradients
    after the clip and the state dict after the step; for a sender also the
    training forward's point probabilities and flow, the valid rows, and the
    corrector's own decisions and their margins, on the CPU."""
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import take_train_step

    model.load_state_dict(state_dict, strict=True)
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    if pin is not None:
        pin_decisions(model, pin)
    out = take_train_step(model, optimizer, batch)
    if pin is not None:
        del model.corrector.move_points
    step = {"loss": out["loss"].item(), "tb": {k: v.item() for k, v in out["tb_dict"].items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    if "points_cls_prob" in out:
        with torch.no_grad():
            step["decisions"], step["margin"] = corrector_decisions(model, batch, out)
        step["prob"] = out["points_cls_prob"].detach().cpu()
        step["flow"] = out["points_flow3d"].detach().cpu()
        step["mask"] = batch["points_mask"].cpu()
    return step


def card_and_cpu_steps(model, cfg_path, cfg, state_dict, one):
    """One b1 train step from ``state_dict`` on the card and on the CPU with
    all its threads and with half, under deterministic algorithms; a
    sender's two later steps take the corrector decisions of the CPU's
    first where theirs differ (``pin_decisions``). Returns (card, CPU, CPU at
    half the threads, the CPU step's seconds)."""
    from pcp_tpu_torch.entry import build

    _, _, cpu_model = build(cfg_path, device="cpu")
    cpu_sd = {k: v.cpu() for k, v in state_dict.items()}
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    cpu = _one_step(cpu_model, cpu_sd, cfg, one)
    cpu_s = time.perf_counter() - t0
    pin = cpu if hasattr(model, "corrector") else None
    torch.set_num_threads(max(1, threads // 2))
    cpu_half = _one_step(cpu_model, cpu_sd, cfg, one, pin)
    torch.set_num_threads(threads)
    gpu = _one_step(model, state_dict, cfg, _on(one, "cuda"), pin)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    return gpu, cpu, cpu_half, cpu_s


def hold_to_cpu_spread(phase, name, gpu, cpu, cpu_half, zero_names, cpu_s, grad_rtol=GRAD_RTOL):
    """The card's step against the CPU's: loss and tb (relative), gradients
    after the clip by group (``grad_errors``), running statistics by group
    and, for a sender, the training forward's point probabilities and flow
    on valid rows (absolute), each held to max(its tolerance, SPREAD_FACTOR
    x the same error of the CPU's step at half the threads). Returns
    ``{quantity: (error, limit)}`` and the gradient groups whose limit is
    GRAD_LIMIT_CAP or more (loosely held)."""
    def errors(got):
        stats, out = {}, {}
        for key, v in cpu["state"].items():
            if ".running_" in key:
                group = key.split(".")[0]
                stats[group] = max(stats.get(group, 0.0),
                                   (got["state"][key].cpu() - v).abs().max().item())
        tb = max(abs(got["tb"][k] - v) / max(abs(v), 1e-30) for k, v in cpu["tb"].items())
        for key in ("prob", "flow"):
            if key in cpu:
                out[key] = (got[key] - cpu[key])[cpu["mask"]].abs().max().item()
        return (abs(got["loss"] - cpu["loss"]) / abs(cpu["loss"]), tb,
                grad_errors(got["grads"], cpu["grads"], zero_names), stats, out)

    loss_rel, tb_rel, errs, stats_err, point_err = errors(gpu)
    loss_spread, tb_spread, spread, stats_spread, point_spread = errors(cpu_half)
    limits = {"loss": (loss_rel, max(LOSS_RTOL, SPREAD_FACTOR * loss_spread)),
              "tb": (tb_rel, max(LOSS_RTOL, SPREAD_FACTOR * tb_spread))}
    for key, atol in (("prob", CLS_PROB_ATOL), ("flow", FLOW_ATOL)):
        if key in point_err:
            limits[f"points_{key}"] = (point_err[key], max(atol, SPREAD_FACTOR * point_spread[key]))
    for group, d in errs.items():
        for key, (err, _) in d.items():
            base = GRAD_ZERO_ATOL if key == "zero_grad" else grad_rtol
            limits[f"{group} {key}"] = (err, max(base, SPREAD_FACTOR * spread[group][key][0]))
        if group in stats_err:  # a group without BN (the anchor head) has no statistics
            limits[f"{group} running statistics"] = (
                stats_err[group], max(STATS_ATOL, SPREAD_FACTOR * stats_spread[group]))
    loose = sorted(k for k, (_, lim) in limits.items() if k.endswith(" rel") and lim >= GRAD_LIMIT_CAP)
    log(phase, f"{name}b1 step card vs CPU ({cpu_s:.1f} s on the CPU): loss {gpu['loss']} vs "
               f"{cpu['loss']}; gradients after the clip, by group, largest error over the leaf's "
               f"largest |g| (biases in front of a BN: over the model's largest |g|): {errs}; the "
               f"CPU at half its threads: {spread}; each against max(tolerance, {SPREAD_FACTOR} x "
               "the CPU's spread): " + ", ".join(f"{k} {e:.3e} <= {lim:.3e}"
                                                 for k, (e, lim) in limits.items())
               + f"; loosely held (the CPU's own spread puts the limit at {GRAD_LIMIT_CAP} or "
               "more): " + (", ".join(loose) or "none"))
    bad = [f"{k} {e} > {lim}" for k, (e, lim) in limits.items() if e > lim]
    if bad:
        raise AssertionError(f"{name}b1 card vs CPU outside tolerance: " + "; ".join(bad))
    return limits, loose


def time_train_steps(model, optimizer, batch, iters=10, warmup=3):
    """The train step: host clock around steps that end in a synchronize
    (median of ``iters`` after ``warmup``), the split into forward+loss,
    backward and optimizer by CUDA events (medians), the host's time to
    issue each part (``host_*``: a device part longer than its issue is
    the card's, one no longer waits on the host), and the peak memory
    allocated. Returns (step ms, split, peak bytes)."""
    model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = ("forward_loss", "backward", "optimizer")
    step_ms, split = [], {k: [] for k in parts + tuple(f"host_{k}" for k in parts)}
    for it in range(warmup + iters):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        events[0].record()
        optimizer.zero_grad(set_to_none=True)
        out = model(batch)
        events[1].record()
        t.append(time.perf_counter())
        out["loss"].backward()
        events[2].record()
        t.append(time.perf_counter())
        optimizer.step()
        events[3].record()
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        del out
        if it >= warmup:
            step_ms.append((time.perf_counter() - t[0]) * 1e3)
            for i, key in enumerate(parts):
                split[key].append(events[i].elapsed_time(events[i + 1]))
                split[f"host_{key}"].append((t[i + 1] - t[i]) * 1e3)
    return (statistics.median(step_ms), {k: statistics.median(v) for k, v in split.items()},
            torch.cuda.max_memory_allocated())


def grad_errors(got, want, zero_names):
    """Per module group (vfe, backbone_2d, dense_head): the largest error of
    a leaf over that leaf's largest |g| (``rel``, with the leaf's name), and,
    for the biases in front of a BN, their largest |g| on either side over
    the model's largest |g| (``zero_grad``)."""
    top = max(w.abs().max().item() for w in want.values())
    out = {}
    for name, w in want.items():
        group = name.split(".")[0]
        g = got[name].to(w.device)
        if name in zero_names:
            key, err = "zero_grad", max(g.abs().max().item(), w.abs().max().item()) / top
        else:
            key, err = "rel", (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        entry = out.setdefault(group, {})
        if err >= entry.get(key, (-1.0, ""))[0]:
            entry[key] = (err, name)
    return out


def phase_train(seed):
    """Training of the full-width ego model on the card. Returns (launches
    of each kernel per train step under its setting, the train record)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import biases_before_bn, create_train_state, make_train_step

    cfg, info, model = build(CFG_EGO, device="cuda")
    # BATCH_SIZE_PER_GPU of the config; MAX_POINTS_PER_SAMPLE 32768, as the
    # synthetic-data train recipe sets it (the config leaves it unset)
    b, n = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), N
    host_batch = train_batch(np.random.default_rng(seed + 2), b, n, info)
    batch = _on(host_batch, "cuda")
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    state = create_train_state(model, optimizer, seed)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    log("train", f"ego model on the card: {n_params} parameters in "
                 f"{len(list(model.parameters()))} tensors; b{b} x {n} points, "
                 f"{int(host_batch['gt_boxes'][..., 7].sum())} gt boxes; adam_onecycle "
                 f"over {TRAIN_STEPS} steps, LR {cfg.OPTIMIZATION.LR}, GRAD_NORM_CLIP "
                 f"{cfg.OPTIMIZATION.GRAD_NORM_CLIP}")

    # overfit one batch; every launch of the run counted
    step = make_train_step(model, optimizer)
    bev_scatter.reset_launches()
    losses = [step(batch)[0] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = dict(bev_scatter.launches)
    losses = [v.item() for v in losses]
    log("train", "loss curve: " + " ".join(f"{v:.6f}" for v in losses))
    log("train", f"{TRAIN_STEPS} steps, kernel launches {counts}; step count {state.step}")
    if counts != {k: TRAIN_STEPS * int(k == "bev_scatter_max") for k in counts}:
        raise AssertionError(f"expected {TRAIN_STEPS} launches of bev_scatter_max and none of the "
                             f"others, got {counts}")
    if not np.isfinite(losses).all() or not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"overfit: last loss {losses[-1]} not under 0.7 x first {losses[0]}")
    launches = {"bev_scatter_max": counts["bev_scatter_max"] // TRAIN_STEPS}

    # one deterministic step under each PRE_REDUCE setting from the initial
    # weights and running statistics
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    zero_names = biases_before_bn(model)
    ref = None
    for pre_reduce, kernel in SETTINGS:
        setting_model = model if pre_reduce is None else build(CFG_EGO, "cuda", pre_reduce)[2]
        bev_scatter.reset_launches()
        one_step = _one_step(setting_model, initial, cfg, batch)
        loss, grads = one_step["loss"], one_step["grads"]
        torch.cuda.synchronize()
        counts = dict(bev_scatter.launches)
        if counts != {k: int(k == kernel) for k in counts}:
            raise AssertionError(f"PRE_REDUCE {pre_reduce}: expected one launch of {kernel}, "
                                 f"got {counts}")
        launches[kernel] = counts[kernel]
        if ref is None:
            ref = (loss, grads)
            log("train", f"PRE_REDUCE {pre_reduce}: one deterministic step, loss {loss}, "
                         f"launches {counts}")
            continue
        errs = grad_errors(grads, ref[1], set())
        worst = max(e["rel"][0] for e in errs.values())
        if kernel == "bev_scatter_onehot":
            ok, rule = worst <= ONEHOT_GRAD_RTOL, f"<= {ONEHOT_GRAD_RTOL} of each leaf's largest |g|"
        else:
            ok, rule = worst == 0.0 and loss == ref[0], "exact equality"
        log("train", f"PRE_REDUCE {pre_reduce}: loss {loss} (default {ref[0]}), launches {counts}; "
                     f"gradients vs the default setting's, largest error over the leaf's largest "
                     f"|g| by group {errs} ({rule} required)")
        if not ok:
            raise AssertionError(f"PRE_REDUCE {pre_reduce}: gradients differ from the default's")
        del setting_model

    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    model.load_state_dict(initial, strict=True)
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    step_ms, split, peak = time_train_steps(model, optimizer, batch)
    # the training forward cut at module boundaries (targets in dense_head)
    head = model.dense_head
    stages = stage_ms([("vfe", model.vfe), ("map_to_bev", model.map_to_bev),
                       ("backbone_2d", model.backbone_2d), ("dense_head", head),
                       ("loss", lambda d: dict(d, loss=head.get_loss(d["head_preds"],
                                                                     d["head_targets"])[0]))],
                      batch)
    log("train", f"b{b} training forward by stage (median ms of 10, CUDA events between "
                 "stages): " + ", ".join(f"{k} {v:.6f}" for k, v in stages.items()))
    # the same backbone on the same BEV in eval mode, as the serving forward
    # runs it, beside the training-mode time above
    model.eval()
    with torch.inference_mode():
        bev = model.map_to_bev(model.vfe(batch))
        eval_backbone_ms = cuda_ms(lambda: model.backbone_2d(bev), iters=10)
    model.train()
    log("train", f"b{b} backbone_2d in eval mode under inference_mode, same BEV: "
                 f"{eval_backbone_ms:.6f} ms (median of 10, CUDA events)")
    record = {"batch": b, "points": n, "step_ms": step_ms, "samples_per_s": b / step_ms * 1e3,
              **{f"{k}_ms": v for k, v in split.items()},
              "peak_bytes": peak, "forward_stages_ms": stages,
              "eval_backbone_ms": eval_backbone_ms,
              "first_loss": losses[0], "last_loss": losses[-1],
              "steps": TRAIN_STEPS}
    log("train", f"b{b} x {n} train step, full width, TF32 off: median {record['step_ms']:.6f} ms "
                 f"over 10 steps after 3 warm-ups (host clock, synchronized), "
                 f"{record['samples_per_s']:.3f} samples/s; split (median ms, CUDA events; host_*: the host's clock to issue it): "
                 + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
                 + f"; peak memory allocated {peak} bytes ({peak / 2**30:.3f} GiB)")

    # b1, card against CPU, from the same weights and cloud; the CPU's step
    # twice, with all its threads and with half, for its own spread
    one = {k: v[:1] for k, v in host_batch.items()}
    gpu, cpu, cpu_half, cpu_s = card_and_cpu_steps(model, CFG_EGO, cfg, initial, one)
    limits, loose = hold_to_cpu_spread("train", "", gpu, cpu, cpu_half, zero_names, cpu_s)
    record["card_vs_cpu"] = {"limits": limits, "loosely_held": loose}
    return launches, record


# ------------------------------------------------------------ 6. exchange

CFG_CAR = REPO / "tools" / "cfgs" / "v2x_sim_models" / "v2x_pointpillar_basic_car.yaml"
CFG_RSU = REPO / "tools" / "cfgs" / "v2x_sim_models" / "v2x_pointpillar_basic_rsu.yaml"
CFG_DISCO = REPO / "tools" / "cfgs" / "v2x_sim_models" / "v2x_pointpillar_disco.yaml"
SENDER_N = 65536  # MAX_POINTS_PER_SAMPLE's default; neither sender config sets it
SENDER_PAD = 1024  # padding rows at the end of each sender cloud
NUM_SWEEPS, NUM_INSTANCES = 11, 8
BG_PROB_THRESH = 0.3  # the writer's foreground cut
# card against CPU, b1 sender forward: the VFE's and the corrector's BEV
# (atol, rtol), points_cls_prob and points_flow3d atol (valid rows), head
# outputs atol; a corrector decision may differ only within DECISION_BAND of
# its boundary (probability, or pixel units for a moved point's coords)
SENDER_BEV_TOL, CLS_PROB_ATOL, FLOW_ATOL, HEAD_ATOL = (1e-4, 1e-4), 1e-5, 1e-4, 1e-3
DECISION_BAND = 1e-4
MODAR_ATOL = 1e-5  # MoDAR rows in the ego batch against the sender's boxes
# (keyframe, lidar id) of the clouds each sender broadcasts: the car's four
# clouds are lidars 2-5 of two keyframes, the RSU's first two its lidar 0
KEYFRAMES = ("kf0", "kf1")
BROADCAST = {"car": [("kf0", 2), ("kf0", 3), ("kf1", 4), ("kf1", 5)],
             "rsu": [("kf0", 0), ("kf1", 0)]}


def sender_points(rng, b, n):
    """7-feature sender clouds as ``tests/test_hunter_jr.py`` lays them out,
    on ``realistic_points``' xyz and intensity (4096 pillars a cloud, 16
    points each at n 65536): instance -1 or 0..7, sweep 0..10 for instance
    points and 10 for the rest, time 1 - sweep / 10; the last SENDER_PAD rows
    padding."""
    pts = realistic_points(rng, b, n, 7)
    inst = rng.integers(-1, NUM_INSTANCES, size=(b, n))
    sweep = np.where(inst >= 0, rng.integers(0, NUM_SWEEPS, size=(b, n)), NUM_SWEEPS - 1)
    pts[..., 4] = 1.0 - sweep / (NUM_SWEEPS - 1)
    pts[..., 5] = sweep
    pts[..., 6] = inst
    mask = np.ones((b, n), bool)
    mask[:, -SENDER_PAD:] = False
    return {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)}


def sender_stages(model):
    """The sender's eval forward cut at module boundaries, the corrector
    split into its conv_input, its point work (point head, resample,
    mean-scatter) and its weightor convs and blend."""
    c = model.corrector

    def points(d):
        corrected, prob, flow, _ = c.correct_points(d, d["bev_img"])
        return dict(d, corrected=corrected, points_cls_prob=prob, points_flow3d=flow)

    stages = serving_stages(model)
    stages[3:3] = [
        ("corrector.conv_input", lambda d: dict(d, bev_img=c.conv_input(d["spatial_features_2d"]))),
        ("corrector.points", points),
        ("corrector.weightor", lambda d: dict(d, spatial_features_2d=c.blend(d["bev_img"],
                                                                             d["corrected"])))]
    return stages


def corrector_decisions(model, batch, out):
    """The corrector's discrete decisions per point, recomputed from its
    outputs by its own ``move_points``: whether the point moves, and the
    pixel (floor of its possibly moved coords) where its features are
    sampled and scattered. Also how close each decision is to its boundary:
    the top two class probabilities' gap, the max probability's distance
    from the threshold, and the moved coords' distance from a pixel
    border."""
    c = model.corrector
    prob, flow = out["points_cls_prob"], out["points_flow3d"]
    dyn, moved = type(c).move_points(c, batch["points"][..., 0:2], prob, flow, batch["points_mask"])
    coord = (moved - c.pc_range[:2]) / c.pixel_size
    top2 = prob.topk(2, dim=-1).values
    margin = torch.stack([top2[..., 0] - top2[..., 1], (top2[..., 0] - c.thresh_point_cls_prob).abs(),
                          torch.where(dyn[..., 0], (coord - coord.round()).abs().min(-1).values, 1.0)],
                         -1)
    return torch.cat([dyn.float(), coord.floor()], -1).cpu(), margin.cpu()


def pin_decisions(model, ref):
    """Make ``model``'s corrector take the decisions of the step ``ref``
    (``_one_step``'s) wherever its own differ: the point moves or stays as in
    ``ref``, and a moved point lands where ``ref``'s flow put it, the
    gradient to its own flow kept. Steps of two devices then take every
    decision alike and differ by their rounding alone. Undo with
    ``del model.corrector.move_points``."""
    c = model.corrector
    dev = c.pixel_size.device
    ref_dyn = ref["decisions"][..., 0:1].bool().to(dev)
    ref_pixel = ref["decisions"][..., 1:3].to(dev)
    ref_flow = ref["flow"][..., 0:2].to(dev)

    def move_points(xy, cls_prob, flow, pmask):
        dyn, moved = type(c).move_points(c, xy, cls_prob, flow, pmask)
        apart = (dyn != ref_dyn) | (((moved - c.pc_range[:2]) / c.pixel_size).floor()
                                    != ref_pixel).any(-1, keepdim=True)
        own = flow[..., 0:2]
        pinned = torch.where(ref_dyn, xy + ref_flow + (own - own.detach()), xy)
        return torch.where(apart, ref_dyn, dyn), torch.where(apart, pinned, moved)

    c.move_points = move_points


def _sender_card_vs_cpu(name, cfg_path, sd, model, batch, pp, post_max, phase="exchange"):
    """b1 on the card against b1 on the CPU, the card's forward under
    deterministic algorithms. A corrector decision (move a point or not, the
    pixel of a moved point) may fall either way where the two devices'
    values straddle its boundary, and then the corrected BEV differs there
    by far more than rounding; such points must lie within DECISION_BAND of
    the boundary, are dropped from the cloud (masked) and both forwards run
    again, up to three rounds. Returns the largest errors."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    _, _, cpu_model = build(cfg_path, device="cpu")
    cpu_model.load_state_dict(sd, strict=True)
    one = {k: v[:1].clone() for k, v in batch.items()}
    dropped = 0
    for _ in range(3):
        torch.use_deterministic_algorithms(True, warn_only=True)
        with torch.inference_mode():
            gpu_one = _on(one, "cuda")
            gpu = model(gpu_one)
            torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        t0 = time.perf_counter()
        with torch.inference_mode():
            cpu = cpu_model(one)
        cpu_s = time.perf_counter() - t0
        got, _ = corrector_decisions(model, gpu_one, gpu)
        want, margin = corrector_decisions(cpu_model, one, cpu)
        flips = (got != want).any(-1) & one["points_mask"]
        if not flips.any():
            break
        if not (margin[flips] < DECISION_BAND).any(-1).all():
            raise AssertionError(f"{name}: a corrector decision differs between card and CPU away "
                                 f"from its boundary: margins {margin[flips].tolist()}")
        dropped += int(flips.sum())
        one["points_mask"] = one["points_mask"] & ~flips
    else:
        raise AssertionError(f"{name}: corrector decisions still differ after three rounds")
    mask = one["points_mask"]
    err = {}

    def hold(key, got, want, atol, rtol=0.0):
        err[key] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{name} b1 card vs CPU, {key}: {m}")

    hold("vfe_bev", gpu["spatial_features"].cpu(), cpu["spatial_features"], *SENDER_BEV_TOL)
    hold("points_cls_prob", gpu["points_cls_prob"].cpu()[mask], cpu["points_cls_prob"][mask],
         CLS_PROB_ATOL)
    hold("points_flow3d", gpu["points_flow3d"].cpu()[mask], cpu["points_flow3d"][mask], FLOW_ATOL)
    hold("corrected_bev", gpu["spatial_features_2d"].cpu(), cpu["spatial_features_2d"],
         *SENDER_BEV_TOL)
    for branch, t in cpu["head_preds"][0].items():
        hold(f"head.{branch}", gpu["head_preds"][0][branch].cpu(), t, HEAD_ATOL)
    heat = torch.sigmoid(cpu["head_preds"][0]["hm"].double()).numpy().reshape(-1)
    n_matched = match_surviving_boxes(
        {k: v[0].cpu().numpy() for k, v in gpu["final_box_dicts"].items()},
        {k: v[0].numpy() for k, v in cpu["final_box_dicts"].items()}, heat,
        top_k=int(pp.MAX_OBJ_PER_SAMPLE), score_thresh=float(pp.SCORE_THRESH), post_max=post_max)
    log(phase, f"{name}: b1 card vs CPU ({cpu_s:.1f} s on the CPU), max_abs_err {err}; "
                    f"tolerances: vfe_bev and corrected_bev atol {SENDER_BEV_TOL[0]} rtol "
                    f"{SENDER_BEV_TOL[1]}, points_cls_prob atol {CLS_PROB_ATOL}, points_flow3d "
                    f"atol {FLOW_ATOL} (valid rows), head atol {HEAD_ATOL}; every corrector "
                    f"decision equal ({dropped} points within {DECISION_BAND} of a boundary "
                    f"decided apart and dropped); {n_matched} surviving boxes matched under the "
                    "margin rule")
    return dict(err, boxes_matched=n_matched, points_dropped=dropped, cpu_s=cpu_s)


def balance_seg_bias(model, sd, batch):
    """Seeded weights make one class win every point, so the corrector would
    move none of them (or all) and the writer would send no foreground.
    Shift the seg head's output bias, in ``sd`` and in ``model``, so that
    over the batch's valid points the mean background logit is that of
    probability 0.3 (the writer's cut) and the mean static and dynamic
    logits are 0: about half the points then go out as foreground and the
    dynamic class wins about half, so both branches of the corrector run
    and the flow pooling has points to pool."""
    with torch.inference_mode():
        prob = model(batch)["points_cls_prob"][batch["points_mask"]].double()
    target = torch.tensor([np.log(BG_PROB_THRESH / (1 - BG_PROB_THRESH)), 0.0, 0.0],
                          dtype=torch.float64)
    key = f"corrector.point_head.seg.{len(model.corrector.point_head.seg) - 1}.bias"
    shift = (torch.log(prob) - torch.log1p(-prob)).mean(0).cpu() - target
    sd[key] = (sd[key].double() - shift).float()
    model.load_state_dict(sd, strict=True)


def b1_on_inputs(phase, what, feats, pids, h, w):
    """B1 on inputs a model gave it: exact against its plain version, and
    timed there beside its plain version, the library call and its bound.
    Returns the record."""
    from pcp_tpu_torch.ops import bev_scatter as bs

    with torch.inference_mode():
        err = _hold(bs.bev_scatter_max_sorted_cuda(feats, pids, h, w),
                    bs.bev_scatter_max_sorted_plain(feats, pids, h, w), 0.0,
                    f"{what} bev_scatter_max inputs: kernel vs its plain version")
        kernel_ms = cuda_ms(lambda: bs.bev_scatter_max_sorted_cuda(feats, pids, h, w))
        device_ms = cuda_ms(lambda: bs.bev_scatter_max_sorted_cuda(feats, pids, h, w), reps=5)
        plain_ms = cuda_ms(lambda: bs.bev_scatter_max_sorted_plain(feats, pids, h, w))
        zeros = torch.zeros((feats.shape[0], h * w + 1, feats.shape[2]), device=feats.device)
        idx = pids.long()[..., None].expand(-1, -1, feats.shape[2])
        library_ms = cuda_ms(lambda: torch.scatter_reduce(zeros, 1, idx, feats, "amax",
                                                          include_self=True))
        del zeros, idx
    bytes_moved, t_bytes, t_ops = scatter_bound(feats, pids, h * w)
    bound_ms = max(t_bytes, t_ops)
    log(phase, f"{what} bev_scatter_max inputs {tuple(feats.shape)} on {h}x{w}: max_abs_err {err} "
               f"(exact equality required); kernel_ms {kernel_ms:.6f} (5 launches a timing: "
               f"device_ms {device_ms:.6f}) plain_ms {plain_ms:.6f} library_ms {library_ms:.6f} "
               f"(torch.scatter_reduce amax) bound_ms {bound_ms:.6f} ({bytes_moved} bytes, "
               f"{(pids < h * w).sum().item()} of {pids.numel()} rows on the grid)")
    return {"shape": list(feats.shape), "grid": [h, w], "max_abs_err": err, "ms": kernel_ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": library_ms}


def run_sender(name, cfg_path, seed):
    """One sender at full width on the card. Returns (record, launches in one
    forward, the host batch, the counted forward's outputs)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs

    cfg, info, model = build(cfg_path, device="cuda")
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    b, n = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), SENDER_N
    host = sender_points(np.random.default_rng(seed + 3), b, n)
    batch = _on(host, "cuda")
    balance_seg_bias(model, sd, batch)
    pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    post_max = int(pp.NMS_CONFIG.NMS_POST_MAXSIZE)

    # the counted forward, deterministic; the scatter's inputs kept for the
    # kernel check below
    seen, scatter = [], model.vfe.scatter_max
    model.vfe.scatter_max = lambda *args: seen.append(args) or scatter(*args)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.inference_mode():
        bs.reset_launches()
        out = model(batch)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
    torch.use_deterministic_algorithms(False)
    model.vfe.scatter_max = scatter
    log("exchange", f"{name}: one b{b} x {n} forward ({int(host['points_mask'].sum())} valid "
                    f"points), full width: kernel launches {counts}")
    if counts != {k: int(k == "bev_scatter_max") for k in counts}:
        raise AssertionError(f"{name}: expected one launch of bev_scatter_max, got {counts}")
    fbd = out["final_box_dicts"]
    for key, shape in (("points_cls_prob", (b, n, 3)), ("points_flow3d", (b, n, 3))):
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"{name}: {key} {tuple(out[key].shape)} not finite {shape}")
    if tuple(fbd["pred_boxes"].shape) != (b, post_max, 7) or not torch.isfinite(
            fbd["pred_boxes"]).all() or not fbd["pred_valid"].any(1).all():
        raise AssertionError(f"{name}: pred_boxes {tuple(fbd['pred_boxes'].shape)}, valid per "
                             f"cloud {fbd['pred_valid'].sum(1).tolist()}")
    dyn = model.corrector.move_points(batch["points"][..., 0:2], out["points_cls_prob"],
                                      out["points_flow3d"], batch["points_mask"])[0][..., 0]
    moved, left = int(dyn.sum()), int((batch["points_mask"] & ~dyn).sum())
    log("exchange", f"{name}: the corrector moved {moved} valid points by their flow and left "
                    f"{left}; valid boxes per cloud {fbd['pred_valid'].sum(1).tolist()}")
    if not moved or not left:
        raise AssertionError(f"{name}: one branch of the corrector unused ({moved} moved, {left} left)")

    # B1 at the sender's shape, on the inputs the forward gave it
    (feats, pids, h, w), = seen
    kernel = b1_on_inputs("exchange", f"{name}: the forward's", feats, pids, h, w)
    del seen, feats, pids

    check = _sender_card_vs_cpu(name, cfg_path, sd, model, host, pp, post_max)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(batch), warmup=3, iters=20)
        peak = torch.cuda.max_memory_allocated()
        stages = stage_ms(sender_stages(model), batch)
    log("exchange", f"{name}: forward b{b} x {n} points, full width, seeded weights, TF32 off: "
                    f"median {ms:.6f} ms over 20 iterations after 3 warm-ups, "
                    f"{b / ms * 1e3:.3f} clouds/s; peak memory allocated {peak} bytes "
                    f"({peak / 2**30:.3f} GiB)")
    log("exchange", f"{name}: stages (median ms of 10, CUDA events between stages): "
                    + ", ".join(f"{k} {v:.6f}" for k, v in stages.items()))
    record = {"config": str(Path(cfg_path).relative_to(REPO)), "batch": b, "points": n,
              "forward_ms": ms, "clouds_per_s": b / ms * 1e3, "stages_ms": stages,
              "peak_bytes": peak, "points_moved": moved, "points_left": left,
              "bev_scatter_max": kernel, "card_vs_cpu": check}
    keep = {"final_box_dicts": fbd, "points_cls_prob": out["points_cls_prob"],
            "points_flow3d": out["points_flow3d"]}
    return record, counts, batch, keep


def seeded_pose(rng):
    """A random SE(3) pose in the ground plane: yaw, x and y within 10 m,
    z within 1 m, so that many boxes land inside the ego's range."""
    yaw = rng.uniform(-np.pi, np.pi)
    tf = np.eye(4)
    tf[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    tf[:3, 3] = rng.uniform([-10, -10, -1], [10, 10, 1])
    return tf


def expected_modar(batch, out, i, target):
    """Reference for one broadcast cloud, on the card and independent of the
    host path: the sender's valid boxes moved by twice the mean flow of the
    foreground points in each, then by ``target`` in float64. Returns
    (rows (K, 9): box7, score, label, in the ego's frame)."""
    from pcp_tpu_torch.ops.points_in_boxes import points_in_boxes

    fbd = out["final_box_dicts"]
    valid = fbd["pred_valid"][i]
    boxes = fbd["pred_boxes"][i][valid].double()
    k = boxes.shape[0]
    send = (out["points_cls_prob"][i][:, 0] < BG_PROB_THRESH) & batch["points_mask"][i]
    idx = points_in_boxes(batch["points"][i][send], fbd["pred_boxes"][i][valid])
    idx = torch.where(idx >= 0, idx, k)
    flow = out["points_flow3d"][i][send].double()
    sums = torch.zeros((k + 1, 3), dtype=torch.float64, device=boxes.device).index_add_(0, idx, flow)
    cnt = torch.zeros(k + 1, dtype=torch.float64, device=boxes.device).index_add_(
        0, idx, torch.ones_like(flow[:, 0]))
    center = boxes[:, :3] + 2.0 * sums[:k] / cnt[:k].clamp(min=1.0)[:, None]
    tf = torch.from_numpy(target).to(boxes.device)
    yaw = torch.atan2(tf[1, 0], tf[0, 0])
    heading = boxes[:, 6] + yaw
    heading = torch.atan2(torch.sin(heading), torch.cos(heading))
    return torch.cat([center @ tf[:3, :3].T + tf[:3, 3], boxes[:, 3:6], heading[:, None],
                      fbd["pred_scores"][i][valid].double()[:, None],
                      fbd["pred_labels"][i][valid].double()[:, None]], 1)


def phase_exchange(seed):
    """The senders broadcast and the ego reads: phase 6. Returns (launches of
    each kernel in one sender forward, the ``senders`` record)."""
    import tempfile

    from pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_ego import (load_and_propagate_modar,
                                                                     modar_to_points)
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.exchange.database import ExchangeDatabase
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.eval_utils import make_exchange_writer
    from pcp_tpu_torch.utils.geometry import se3_inverse

    record, runs, launches = {}, {}, None
    for name, cfg_path in (("car", CFG_CAR), ("rsu", CFG_RSU)):
        record[name], counts, batch, out = run_sender(name, cfg_path, seed)
        if launches not in (None, counts):
            raise AssertionError(f"launches differ between senders: {launches} vs {counts}")
        launches, runs[name] = counts, (batch, out)

    rng = np.random.default_rng(seed + 4)
    ego_pose = {kf: seeded_pose(rng) for kf in KEYFRAMES}
    pose = {cloud: seeded_pose(rng) for clouds in BROADCAST.values() for cloud in clouds}
    target = {cloud: se3_inverse(ego_pose[cloud[0]]) @ tf for cloud, tf in pose.items()}
    ego_raw = realistic_points(rng, len(KEYFRAMES), N, 13)
    ego_raw[..., 11] = rng.integers(0, NUM_SWEEPS, size=ego_raw.shape[:2])  # sweep index
    ego_raw[..., 4] = 1.0 - ego_raw[..., 11] / (NUM_SWEEPS - 1)
    ego_raw[..., 12] = -1
    wire, rows, want = {}, {kf: [] for kf in KEYFRAMES}, {kf: [] for kf in KEYFRAMES}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        db = ExchangeDatabase(tmp)
        writer = make_exchange_writer(db, BG_PROB_THRESH)
        for name, clouds in BROADCAST.items():
            batch, out = runs[name]
            k = len(clouds)
            writer({"points": batch["points"][:k], "points_mask": batch["points_mask"][:k],
                    "metadata": [{"sample_token": t, "lidar_id": lid} for t, lid in clouds]},
                   {"final_box_dicts": {key: v[:k] for key, v in out["final_box_dicts"].items()},
                    "points_cls_prob": out["points_cls_prob"][:k],
                    "points_flow3d": out["points_flow3d"][:k]})
            for i, cloud in enumerate(clouds):
                kf = cloud[0]
                modar, n_fg = load_and_propagate_modar(db, *cloud, propagate=True)
                if modar is None or n_fg:
                    raise AssertionError(f"{cloud}: no boxflow read back")
                max_sweep = ego_raw[KEYFRAMES.index(kf), :, 11].max()
                rows[kf].append(modar_to_points(modar, target[cloud], max_sweep))
                want[kf].append(expected_modar(batch, out, i, target[cloud]))
                boxflow = db.load(*cloud, "boxflow")
                wire[f"{kf}_id{cloud[1]}"] = {
                    "boxes": int(modar.shape[0]),
                    "boxes_with_flow": int(np.abs(boxflow[:, 9:]).sum(1).astype(bool).sum()),
                    "boxflow_bytes": db.size_bytes(*cloud, "boxflow"),
                    "foreground_bytes": db.size_bytes(*cloud, "foreground"),
                    "modar_bytes": db.size_bytes(*cloud, "modar")}
        for kf in KEYFRAMES:  # agents that sent nothing for a keyframe read as misses
            for lid in (0, 2, 3, 4, 5):
                if (kf, lid) not in pose and load_and_propagate_modar(db, kf, lid)[0] is not None:
                    raise AssertionError(f"({kf}, {lid}) was not broadcast but reads back")
    if not any(v["boxes_with_flow"] for v in wire.values()):
        raise AssertionError("no broadcast box holds a foreground point: the propagation is untested")
    log("exchange", "bytes per agent and keyframe (boxflow, against the foreground it replaces): "
                    + "; ".join(f"{k}: {v['boxes']} boxes ({v['boxes_with_flow']} with pooled "
                                f"flow), boxflow {v['boxflow_bytes']} B vs "
                                f"foreground {v['foreground_bytes']} B (modar {v['modar_bytes']} B)"
                                for k, v in wire.items()))

    # the ego's batch: each keyframe's raw cloud, then its MoDAR rows
    merged = [np.concatenate([ego_raw[j]] + rows[kf]) for j, kf in enumerate(KEYFRAMES)]
    n_tot = max(len(m) for m in merged)
    pts = np.zeros((len(merged), n_tot, 13), np.float32)
    mask = np.zeros((len(merged), n_tot), bool)
    for j, m in enumerate(merged):
        pts[j, :len(m)], mask[j, :len(m)] = m, True
    host = {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)}
    batch = _on(host, "cuda")
    modar_err = 0.0
    for j, kf in enumerate(KEYFRAMES):
        got = batch["points"][j, N:N + sum(len(r) for r in rows[kf])].double()
        ref = torch.cat(want[kf])
        if got.shape[0] != ref.shape[0] or got[:, [3, 4]].any() or (got[:, 12] != -1).any():
            raise AssertionError(f"{kf}: MoDAR rows {tuple(got.shape)} against {tuple(ref.shape)}")
        got = torch.cat([got[:, 0:3], got[:, 5:11]], 1)
        dh = torch.atan2(torch.sin(got[:, 6] - ref[:, 6]), torch.cos(got[:, 6] - ref[:, 6]))
        err = max((got[:, [0, 1, 2, 3, 4, 5, 7, 8]] - ref[:, [0, 1, 2, 3, 4, 5, 7, 8]]).abs().max().item(),
                  dh.abs().max().item())
        if err > MODAR_ATOL:
            raise AssertionError(f"{kf}: MoDAR rows differ from the senders' boxes by {err}")
        modar_err = max(modar_err, err)
    log("exchange", f"ego batch b{len(merged)}: {N} raw rows a cloud, then "
                    f"{[sum(len(r) for r in rows[kf]) for kf in KEYFRAMES]} MoDAR rows from "
                    f"agents {[[c[1] for c in BROADCAST['rsu'] + BROADCAST['car'] if c[0] == kf] for kf in KEYFRAMES]}; "
                    f"every row equals the sender's valid box after propagation and the pose "
                    f"(max_abs_err {modar_err}, atol {MODAR_ATOL})")

    cfg, _, ego = build(CFG_EGO, device="cuda")
    sd = seeded_state_dict(ego, seed)
    ego.load_state_dict(sd, strict=True)
    pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.inference_mode():
        bs.reset_launches()
        out = ego(batch)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
    torch.use_deterministic_algorithms(False)
    if counts != {k: int(k == "bev_scatter_max") for k in counts}:
        raise AssertionError(f"ego on the merged cloud: expected one launch of bev_scatter_max, "
                             f"got {counts}")
    log("exchange", f"ego forward on the merged batch: kernel launches {counts}; valid boxes per "
                    f"cloud {out['final_box_dicts']['pred_valid'].sum(1).tolist()}")
    # deterministic, so that the card's sums come in the same order in every run
    torch.use_deterministic_algorithms(True, warn_only=True)
    ego_check = _card_vs_cpu(ego, sd, batch, None, pp, int(pp.NMS_CONFIG.NMS_POST_MAXSIZE),
                             phase="exchange", clouds=len(merged))
    torch.use_deterministic_algorithms(False)
    record["exchange"] = {"keyframes": list(KEYFRAMES), "wire": wire, "modar_max_abs_err": modar_err,
                          "ego_points": [int(m.sum()) for m in mask], "ego_launches": counts,
                          "ego_card_vs_cpu": ego_check}
    return launches, record


# ------------------------------------------------------ 7. sender training

MAX_INSTANCES = 256  # the JAX dataset's default padding of instances_tf
SENDER_INSTANCES = 48  # real instances a cloud
SENDER_FG_SHARE = 0.2  # of a cloud's rows, on instances
SENDER_TRAIN_STEPS = 6  # the loss curve: steps on one batch
# the loss falls over SENDER_TRAIN_STEPS: the last under this share of the first
SENDER_LOSS_DROP = 0.95
CORRECTOR_TB = ("corrector_loss", "l_points_cls", "l_points_embed", "l_fg_offset", "l_locals_transl",
                "l_locals_rot", "l_recon", "l_dtl_locals_feat")


def sender_train_batch(rng, b, n, info):
    """A sender's training batch as the JAX dataset pads it: 7-feature
    points (x, y, z, i, t, sweep, inst) on ``realistic_points``, of which
    SENDER_FG_SHARE lie on SENDER_INSTANCES instances a cloud (boxes 4.2 x
    1.8 x 1.6 at random centres and yaws, gt rows in instance order, padded
    to 500); a quarter of the instances move, their translation growing with
    sweep age as ``tests/test_hunter_jr.py`` lays it out, and their older
    points lie where the motion left them, so that ``instances_tf`` (padded
    to MAX_INSTANCES with zeros) brings them together; background points
    are on the last sweep; the last SENDER_PAD rows are padding."""
    s = NUM_SWEEPS
    pts = realistic_points(rng, b, n, 7)
    inst = np.full((b, n), -1, np.int64)
    sweep = np.full((b, n), s - 1, np.int64)
    tf = np.zeros((b, MAX_INSTANCES, s, 4, 4), np.float32)
    tf[:, :SENDER_INSTANCES] = np.eye(4, dtype=np.float32)
    gt = np.zeros((b, 500, 8), np.float32)
    n_fg = int(SENDER_FG_SHARE * (n - SENDER_PAD))
    lo, hi = info.point_cloud_range[0] + 5, info.point_cloud_range[3] - 5
    for i in range(b):
        centres = rng.uniform(lo, hi, (SENDER_INSTANCES, 2))
        yaw = rng.uniform(-np.pi, np.pi, SENDER_INSTANCES)
        gt[i, :SENDER_INSTANCES, 0:2] = centres
        gt[i, :SENDER_INSTANCES, 2] = -1.0
        gt[i, :SENDER_INSTANCES, 3:6] = [4.2, 1.8, 1.6]
        gt[i, :SENDER_INSTANCES, 6] = yaw
        gt[i, :SENDER_INSTANCES, 7] = 1
        rows = rng.choice(n - SENDER_PAD, size=n_fg, replace=False)
        ids = rng.integers(0, SENDER_INSTANCES, n_fg)
        local = rng.uniform(-0.5, 0.5, (n_fg, 2)) * [4.2, 1.8]
        c, sn = np.cos(yaw[ids]), np.sin(yaw[ids])
        pts[i, rows, 0] = centres[ids, 0] + c * local[:, 0] - sn * local[:, 1]
        pts[i, rows, 1] = centres[ids, 1] + sn * local[:, 0] + c * local[:, 1]
        pts[i, rows, 2] = rng.uniform(-1.8, -0.2, n_fg)
        inst[i, rows] = ids
        sweep[i, rows] = rng.integers(0, s, n_fg)
        for k in range(s):
            tf[i, 0:SENDER_INSTANCES:4, k, 0, 3] = 0.2 * (s - 1 - k)
        moving = ids % 4 == 0
        pts[i, rows[moving], 0] -= 0.2 * (s - 1 - sweep[i, rows[moving]])
    pts[..., 4] = 1.0 - sweep / (s - 1)
    pts[..., 5] = sweep
    pts[..., 6] = inst
    mask = np.ones((b, n), bool)
    mask[:, -SENDER_PAD:] = False
    return {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask),
            "gt_boxes": torch.from_numpy(gt), "instances_tf": torch.from_numpy(tf)}


def _sender_train_card_vs_cpu(name, cfg_path, cfg, model, sd, host_batch):
    """One b1 train step from the seeded weights ``sd`` on the card against
    the CPU's (``card_and_cpu_steps``, whose later steps take the CPU's
    corrector decisions). Each decision the card or the CPU at half its
    threads would have taken apart from the CPU's must lie, on both sides,
    within its band of the boundary: DECISION_BAND or SPREAD_FACTOR times
    the CPU's own spread of the quantity that decides it (probabilities;
    flow over the pixel size), whichever is larger. Then every quantity is
    held as phase 5 holds the ego's (``hold_to_cpu_spread``)."""
    from pcp_tpu_torch.train.train_state import biases_before_bn

    one = {k: v[:1] for k, v in host_batch.items()}
    gpu, cpu, cpu_half, cpu_s = card_and_cpu_steps(model, cfg_path, cfg, sd, one)
    mask = cpu["mask"]
    d_prob = (cpu_half["prob"] - cpu["prob"])[mask].abs().max().item()
    d_coord = ((cpu_half["flow"] - cpu["flow"])[..., 0:2]
               / model.corrector.pixel_size.cpu())[mask].abs().max().item()
    band = torch.tensor([max(DECISION_BAND, SPREAD_FACTOR * d_prob)] * 2
                        + [max(DECISION_BAND, SPREAD_FACTOR * d_coord)])
    apart = {}
    for side, other in (("card", gpu), ("cpu_threads", cpu_half)):
        flips = (other["decisions"] != cpu["decisions"]).any(-1) & mask
        margin = torch.minimum(other["margin"], cpu["margin"])[flips]
        if not (margin < band).any(-1).all():
            raise AssertionError(f"{name}: a corrector decision of the {side} step differs from the "
                                 f"CPU's away from its boundary: bands {band.tolist()}, margins "
                                 f"{margin.tolist()}")
        apart[side] = int(flips.sum())
    log("sender_train", f"{name}: b1 step, corrector decisions that would differ from the CPU's "
                        f"and were pinned to them: {apart}, each within its band of the boundary "
                        f"(probability, probability, pixel: {band.tolist()})")
    limits, loose = hold_to_cpu_spread("sender_train", f"{name}: ", gpu, cpu, cpu_half,
                                       biases_before_bn(model), cpu_s)
    return {"limits": limits, "loosely_held": loose, "decisions_pinned": apart,
            "decision_bands": band.tolist(), "cpu_s": cpu_s}


def run_sender_training(name, cfg_path, seed):
    """One sender trained at full width on the card. Returns (its record,
    launches of each kernel in one train step)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg, info, model = build(cfg_path, device="cuda")
    b, n = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), SENDER_N
    host = sender_train_batch(np.random.default_rng(seed + 5), b, n, info)
    batch = _on(host, "cuda")
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model,
                                   total_iters_each_epoch=SENDER_TRAIN_STEPS, total_epochs=1)
    state = create_train_state(model, optimizer, seed)
    fg = int(((host["points"][..., 6] >= 0) & host["points_mask"]).sum())
    log("sender_train", f"{name}: {sum(p.numel() for p in model.parameters())} parameters; b{b} x "
                        f"{n} points ({int(host['points_mask'].sum())} valid, {fg} on instances), "
                        f"instances_tf {tuple(host['instances_tf'].shape)} "
                        f"({b * MAX_INSTANCES * NUM_SWEEPS} dense locals), gt_boxes "
                        f"{tuple(host['gt_boxes'].shape)}; adam_onecycle, LR {cfg.OPTIMIZATION.LR}")

    # the loss curve on one batch, every launch counted; the scatter's inputs
    # of the first step kept for the kernel check below
    seen, scatter = [], model.vfe.scatter_max

    def spy(feats, pids, h, w):
        if not seen:
            seen.append((feats.detach(), pids, h, w))
        return scatter(feats, pids, h, w)

    model.vfe.scatter_max = spy
    step = make_train_step(model, optimizer)
    bs.reset_launches()
    curve = [step(batch) for _ in range(SENDER_TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = dict(bs.launches)
    model.vfe.scatter_max = scatter
    losses = [loss.item() for loss, _ in curve]
    tbs = [{k: v.item() for k, v in tb.items()} for _, tb in curve]
    log("sender_train", f"{name}: loss curve " + " ".join(f"{v:.6f}" for v in losses)
                        + f"; launches {counts} in {SENDER_TRAIN_STEPS} steps, step count {state.step}")
    log("sender_train", f"{name}: corrector tb, first -> last step: " + ", ".join(
        f"{k} {tbs[0][k]:.6f} -> {tbs[-1][k]:.6f}" for k in CORRECTOR_TB))
    bad = [k for tb in tbs for k, v in tb.items() if not np.isfinite(v)]
    if bad or set(CORRECTOR_TB) - set(tbs[0]):
        raise AssertionError(f"{name}: tb keys not finite {sorted(set(bad))} or missing "
                             f"{sorted(set(CORRECTOR_TB) - set(tbs[0]))}")
    if not np.isfinite(losses).all() or not losses[-1] < SENDER_LOSS_DROP * losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if counts != {k: SENDER_TRAIN_STEPS * int(k == "bev_scatter_max") for k in counts}:
        raise AssertionError(f"{name}: expected {SENDER_TRAIN_STEPS} launches of bev_scatter_max "
                             f"and none of the others, got {counts}")
    launches = {k: v // SENDER_TRAIN_STEPS for k, v in counts.items()}

    # B1 on the inputs the sender's own training step gave it
    (feats, pids, h, w), = seen
    kernel = b1_on_inputs("sender_train", f"{name}: the training step's", feats, pids, h, w)
    del seen, feats, pids

    step_ms, split, peak = time_train_steps(model, optimizer, batch)
    profile = trace_train_step(name, model, optimizer, batch)
    # what the backward holds: memory allocated after a training forward,
    # beyond the model and its optimizer state
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = model(batch)
    torch.cuda.synchronize()
    saved = torch.cuda.memory_allocated() - before
    del out
    stages = stage_ms(sender_train_stages(model), batch)
    log("sender_train", f"{name}: b{b} training forward by stage (median ms of 10, CUDA events "
                        "between stages): " + ", ".join(f"{k} {v:.6f}" for k, v in stages.items())
                        + f"; memory held for the backward after one forward {saved} bytes")
    record = {"config": str(Path(cfg_path).relative_to(REPO)), "batch": b, "points": n,
              "instances": [SENDER_INSTANCES, MAX_INSTANCES], "step_ms": step_ms,
              "samples_per_s": b / step_ms * 1e3, **{f"{k}_ms": v for k, v in split.items()},
              "peak_bytes": peak,
              "saved_for_backward_bytes": saved, "forward_stages_ms": stages, "profile": profile,
              "losses": losses, "launches_per_step": launches, "bev_scatter_max": kernel}
    log("sender_train", f"{name}: b{b} x {n} train step, full width, TF32 off: median "
                        f"{record['step_ms']:.6f} ms over 10 steps after 3 warm-ups (host clock, "
                        f"synchronized), {record['samples_per_s']:.3f} samples/s; split (median ms, "
                        "CUDA events; host_*: the host's clock to issue it): "
                        + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
                        + f"; peak memory allocated {peak} bytes ({peak / 2**30:.3f} GiB)")

    # card against CPU at b1, from seeded weights (random BN affine and
    # statistics: at the initial BN bias of 0, a local of one point sits on
    # a ReLU kink of the shape encoder)
    sd = seeded_state_dict(model, seed)
    record["card_vs_cpu"] = _sender_train_card_vs_cpu(name, cfg_path, cfg, model, sd, host)
    del model, optimizer, state, batch
    torch.cuda.empty_cache()
    return record, launches


def trace_train_step(name, model, optimizer, batch):
    """A ``torch.profiler`` trace of one train step (forward, backward,
    optimizer): the top device operations, the idle share, the longest
    gaps. Returns the summary."""
    from pcp_tpu_torch.bench import short_name, trace, trace_summary
    from pcp_tpu_torch.train.train_state import take_train_step

    summary = trace_summary(trace(lambda: take_train_step(model, optimizer, batch)), top=10, gaps=3)
    log("sender_train", f"{name}: one train step traced: window {summary['window_ms']:.6f} ms, "
                        f"device busy {summary['device_busy_ms']:.6f} ms in {summary['device_ops']} "
                        f"operations, idle share {summary['device_idle_share']:.6f}; top device "
                        "operations: " + "; ".join(f"{op['ms']:.6f} ms in {op['calls']} calls "
                                                  f"{short_name(op['name'], 70)}"
                                                  for op in summary["top_ops"]))
    return summary


def sender_train_stages(model):
    """The sender's training forward cut at module boundaries, the corrector
    split into its conv_input, its point work (point head, resample,
    mean-scatter), its losses (object head, targets, CE+Lovász, the hard
    miners) and its weightor; the head with its targets, then the loss."""
    c, head = model.corrector, model.dense_head

    def points(d):
        corrected, _, _, point = c.correct_points(d, d["bev_img"])
        return dict(d, corrected=corrected, point=point)

    return [("vfe", model.vfe), ("map_to_bev", model.map_to_bev),
            ("backbone_2d", model.backbone_2d),
            ("corrector.conv_input", lambda d: dict(d, bev_img=c.conv_input(d["spatial_features_2d"]))),
            ("corrector.points", points),
            ("corrector.losses", lambda d: dict(d, corrector_loss=c.train_loss(d, *d["point"])[0])),
            ("corrector.weightor", lambda d: dict(d, spatial_features_2d=c.blend(d["bev_img"],
                                                                                d["corrected"]))),
            ("dense_head", head),
            ("loss", lambda d: dict(d, loss=head.get_loss(d["head_preds"], d["head_targets"])[0]
                                    + d["corrector_loss"]))]


def phase_sender_train(seed):
    """Phase 7: the car and the RSU trained on the card. Returns (launches of
    each kernel in one sender train step, the record)."""
    record, launches = {}, None
    for name, cfg_path in (("car", CFG_CAR), ("rsu", CFG_RSU)):
        record[name], counts = run_sender_training(name, cfg_path, seed)
        if launches not in (None, counts):
            raise AssertionError(f"launches differ between senders: {launches} vs {counts}")
        launches = counts
    return launches, record


# ------------------------------------------------------------ 8. bench

def phase_bench(card):
    """The port's bench (``pcp_tpu_torch/bench.py``) with the trained
    checkpoint: its profile lines, and its result line, which ``main``
    prints before the last three. Every timed forward launches
    ``bev_scatter_max`` once."""
    from pcp_tpu_torch import bench

    result = bench.run(log=lambda msg: log("bench", msg), card=card)
    launches = result.pop("launches")
    expected = bench.REPS * bench.ITERS + 1
    if launches != {k: expected * int(k == "bev_scatter_max") for k in launches}:
        raise AssertionError(f"bench: expected {expected} launches of bev_scatter_max in the timed "
                             f"run, got {launches}")
    log("bench", f"timed run: {bench.REPS} passes of {bench.ITERS} b{bench.BATCH} batches, kernel "
                 f"launches {launches}; valid boxes per cloud {result['valid_boxes_per_cloud']}")
    return result




# ------------------------------------------------------- 11. serving modes

# (name, the bench's flags, the kernel its forward launches once)
SERVING_MODES = [("f32", [], "bev_scatter_max"),
                 ("fold_bn", ["--fold-bn"], "bev_scatter_max"),
                 ("wpack", ["--wpack"], "bev_scatter_max"),
                 ("fold_bn_wpack", ["--fold-bn", "--wpack"], "bev_scatter_max"),
                 ("bf16", ["--bf16"], "bev_scatter_max"),
                 ("bf16_fold_bn", ["--bf16", "--fold-bn"], "bev_scatter_max"),
                 ("pre_reduce_1", ["--pre-reduce", "1"], "bev_scatter_tails"),
                 ("pre_reduce_fused", ["--pre-reduce", "fused"], "bev_scatter_fused")]
# against the f32 forward, rtol = atol, on the backbone's and the head's
# outputs: the CPU tests' tolerances (tests/test_torch_serving_modes.py)
SERVING_TOL = {"fold_bn": 2e-5, "wpack": 1e-5, "fold_bn_wpack": 1e-4}
# BF16's hm logits against f32's: tests/test_model_forward.py::TestBF16Mode
BF16_HM_BOUND = {"max": 0.2, "mean": 0.02}
BF16_MATCH_M = 0.5  # a BF16 box matches an f32 box whose centre lies this close (BEV)
SERVING_TIMED = 8  # bench batches a timing pass


def _excess(got, want, tol):
    """The largest ``|got - want| - (tol + tol * |want|)`` (positive where
    the pair fails allclose at rtol = atol = tol) and the largest error."""
    diff = (got.float() - want.float()).abs()
    return (diff - tol - tol * want.float().abs()).max().item(), diff.max().item()


def bf16_box_share(got, want):
    """Of ``want``'s valid boxes, the share that a valid box of ``got`` of
    the same label has within BF16_MATCH_M metres (BEV centres)."""
    hits = total = 0
    for i in range(want["pred_boxes"].shape[0]):
        wv, gv = want["pred_valid"][i], got["pred_valid"][i]
        wb, gb = want["pred_boxes"][i][wv], got["pred_boxes"][i][gv]
        wl, gl = want["pred_labels"][i][wv], got["pred_labels"][i][gv]
        total += wb.shape[0]
        if wb.shape[0] and gb.shape[0]:
            dist = torch.cdist(wb[:, :2].float(), gb[:, :2].float())
            dist = torch.where(wl[:, None] == gl[None, :], dist, float("inf"))
            hits += int((dist.min(1).values < BF16_MATCH_M).sum())
    return hits / max(total, 1), total


def kernel_on_inputs(phase, what, kernel, feats, pids, h, w):
    """``kernel`` (a name of ``kernel_table``) on the inputs a forward gave
    the VFE's scatter: exact against its plain version, and timed there.
    Returns the record."""
    from pcp_tpu_torch.ops import bev_scatter as bs

    (_, _, _, alone, prep, rtol), = [row for row in kernel_table(bs) if row[0] == kernel]
    cuda_fn, plain_fn = getattr(bs, alone + "_cuda"), getattr(bs, alone + "_plain")
    with torch.inference_mode():
        args = prep(feats, pids)
        err = _hold(cuda_fn(*args, h, w), plain_fn(*args, h, w), rtol,
                    f"{what} {kernel} inputs: kernel vs its plain version")
        kernel_ms = cuda_ms(lambda: cuda_fn(*args, h, w))
        device_ms = cuda_ms(lambda: cuda_fn(*args, h, w), reps=5)
        plain_ms = cuda_ms(lambda: plain_fn(*args, h, w))
    bytes_moved, t_bytes, t_ops = scatter_bound(
        args[0], pids, h * w, args[2] if kernel == "bev_scatter_tails" else None)
    bound_ms = max(t_bytes, t_ops)
    log(phase, f"{what} {kernel} inputs {tuple(feats.shape)} on {h}x{w}: max_abs_err {err} "
               f"(exact equality required); kernel_ms {kernel_ms:.6f} (5 launches a timing: "
               f"device_ms {device_ms:.6f}) plain_ms {plain_ms:.6f} bound_ms {bound_ms:.6f} "
               f"({bytes_moved} bytes)")
    return {"max_abs_err": err, "ms": kernel_ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


def phase_serving():
    """The trained ego at b8 x 32768 on the bench's first batch under each
    of the bench's serving modes (``SERVING_MODES``), TF32 off. Each mode's
    counted forward runs under deterministic algorithms and launches its
    kernel once. FOLD_BN and W_PACK are held to the f32 forward at
    SERVING_TOL with the surviving boxes matched under the margin rule;
    BF16's hm logits to BF16_HM_BOUND, with the share of f32 boxes that a
    BF16 box matches reported; the PRE_REDUCE modes' BEV and boxes equal the
    f32 forward's and their kernel is exact against its plain version on the
    forward's own inputs. Then one bench timing a mode (``time_batches`` over
    SERVING_TIMED batches) and the forward's stages (``stage_ms``). Returns
    ({mode: launches of each kernel in its forward}, the record)."""
    from pcp_tpu_torch import bench
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    launches, record, ref, batches, failures = {}, {}, None, None, []
    for name, flags, kernel in SERVING_MODES:
        args = bench.parse_args(flags)
        cfg, info, model = bench.load_trained_ego("cuda", args)
        if batches is None:
            batches = bench.bench_batches(args.occupancy, info.num_point_features)[:SERVING_TIMED]
        batch = batches[0]
        pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
        post_max = int(pp.NMS_CONFIG.NMS_POST_MAXSIZE)
        seen, scatter = [], model.vfe.scatter_max
        model.vfe.scatter_max = lambda *a: seen.append(a) or scatter(*a)
        torch.use_deterministic_algorithms(True, warn_only=True)
        with torch.inference_mode():
            bs.reset_launches()
            out = model(batch)
            torch.cuda.synchronize()
            counts = dict(bs.launches)
        torch.use_deterministic_algorithms(False)
        model.vfe.scatter_max = scatter
        launches[name] = counts
        if counts != {k: int(k == kernel) for k in counts}:
            raise AssertionError(f"serving {name}: expected one launch of {kernel}, got {counts}")
        fbd = out["final_box_dicts"]
        heads = out["head_preds"][0]
        if (out["spatial_features_2d"].dtype != torch.float32
                or any(v.dtype != torch.float32 for v in heads.values())
                or tuple(fbd["pred_boxes"].shape) != (B, post_max, 7)
                or not torch.isfinite(fbd["pred_boxes"]).all() or not fbd["pred_valid"].any()):
            raise AssertionError(f"serving {name}: outputs not float32, finite boxes of "
                                 f"({B}, {post_max}, 7) with some valid")
        rec = {"flags": flags, "launches": counts,
               "valid_boxes": fbd["pred_valid"].sum(1).tolist()}
        if ref is None:
            ref = {"bev": out["spatial_features"], "bev2d": out["spatial_features_2d"],
                   "heads": heads, "boxes": fbd}
        elif name in SERVING_TOL:
            tol = SERVING_TOL[name]
            errs = {"spatial_features_2d": _excess(out["spatial_features_2d"], ref["bev2d"], tol)}
            errs.update({k: _excess(v, ref["heads"][k], tol) for k, v in heads.items()})
            n_matched = 0
            try:
                for i in range(B):
                    heat = torch.sigmoid(ref["heads"]["hm"][i].double()).cpu().numpy().reshape(-1)
                    n_matched += match_surviving_boxes(
                        {k: v[i].cpu().numpy() for k, v in fbd.items()},
                        {k: v[i].cpu().numpy() for k, v in ref["boxes"].items()}, heat,
                        top_k=int(pp.MAX_OBJ_PER_SAMPLE), score_thresh=float(pp.SCORE_THRESH),
                        post_max=post_max)
            except AssertionError as e:
                failures.append(f"{name}: boxes: {e}")
            rec.update(tol=tol, max_abs_err={k: v[1] for k, v in errs.items()},
                       boxes_matched=n_matched)
            log("serving", f"{name} vs f32 (rtol = atol = {tol}): max_abs_err "
                           + ", ".join(f"{k} {v[1]:.3e}" for k, v in errs.items())
                           + f"; {n_matched} surviving boxes matched under the margin rule")
            failures += [f"{name}: {k} beyond rtol = atol = {tol} by {v[0]:.3e}"
                         for k, v in errs.items() if v[0] > 0]
        elif name.startswith("bf16"):
            d = (heads["hm"] - ref["heads"]["hm"]).abs()
            share, total = bf16_box_share(fbd, ref["boxes"])
            rec.update(hm_max=d.max().item(), hm_mean=d.mean().item(), f32_boxes=total,
                       f32_boxes_matched_share=share)
            log("serving", f"{name} vs f32: hm logits max_abs_err {d.max().item():.6f} "
                           f"(bound {BF16_HM_BOUND['max']}), mean {d.mean().item():.6f} (bound "
                           f"{BF16_HM_BOUND['mean']}); {share:.6f} of the {total} f32 boxes "
                           f"matched by a BF16 box of the same label within {BF16_MATCH_M} m")
            if d.max().item() >= BF16_HM_BOUND["max"] or d.mean().item() >= BF16_HM_BOUND["mean"]:
                failures.append(f"{name}: hm logits beyond {BF16_HM_BOUND}")
        else:
            _hold(out["spatial_features"], ref["bev"], 0.0, f"serving {name}: BEV vs f32's")
            for key, value in ref["boxes"].items():
                if not torch.equal(fbd[key], value):
                    failures.append(f"{name}: {key} differs from the f32 forward's")
            (feats, pids, h, w), = seen
            rec["kernel_on_bench_input"] = kernel_on_inputs(
                "serving", f"{name}: the bench forward's", kernel, feats, pids, h, w)
            log("serving", f"{name}: BEV equal to the f32 forward's, final boxes identical")
        del seen
        ms = bench.time_batches(model, batches, reps=2)
        with torch.inference_mode():
            stages = stage_ms(serving_stages(model), batch)
        rec.update(ms_per_batch=ms, clouds_per_s=B / ms * 1e3, stages_ms=stages)
        log("serving", f"{name}: bench timing ({len(batches)} b{B} batches back to back, best of "
                       f"2): {ms:.6f} ms a batch, {B / ms * 1e3:.3f} clouds/s; stages (median ms "
                       "of 10): " + ", ".join(f"{k} {v:.6f}" for k, v in stages.items()))
        record[name] = rec
        del model, out
    if failures:
        raise AssertionError("serving modes: " + "; ".join(failures))
    return launches, record


# ------------------------------------------------------------ 12. data parallel

DP_WORLD, DP_B = 2, 2  # ranks sharing the card over gloo; the global batch
DP_TIMED = 3  # float32 steps timed after the compared one
# The 2-rank step against the 1-process step, on the same card with TF32
# off in every process. In float32 a rank convolves b1 where one process
# convolves b2, so cuDNN may pick another algorithm, and a rank takes its
# BN sums over its share before the all-reduce adds them: rounding apart
# (the loss 1.9e-7, the gradient's L2 error over all leaves 3.0e-3 on an
# H100). The standard one-process step is held at DP_F32_TOL. The same step
# arranged to round as the ranks do (``_like_ranks``) closes that (the
# loss equal, the gradient 3.9e-6) and is held at DP_LIKE_RANKS_TOL. Both
# hold the gradient's L2 error over all leaves and its worst entry over its
# leaf's largest |g|. The parameters after the first Adam step are held
# within DP_ADAM_FLIP learning rates: that step moves an entry by about lr
# whatever its gradient's size, so a gradient within rounding of 0 may
# step the other way. In float64 (the scatter's plain version: B1 takes
# float32 only) the standard step is held at DP_F64_TOL: the loss, terms
# and statistics relative, every gradient entry over its leaf's largest
# |g|, every parameter after the Adam step; the conv biases in front of a
# BN (gradient 0 in exact arithmetic, so rounding picks their first Adam
# step's sign) within two learning rates.
DP_F32_TOL = {"loss": 1e-6, "tb": 1e-6, "stats": 1e-6, "grad_l2": 1e-2, "grad_entry": 0.2}
DP_LIKE_RANKS_TOL = {"loss": 1e-6, "tb": 1e-6, "stats": 1e-6, "grad_l2": 5e-5,
                     "grad_entry": 5e-4}
DP_F64_TOL, DP_ADAM_FLIP = 1e-9, 2.1


def _like_ranks(model):
    """Makes a one-process training step round as DP_WORLD ranks, each with
    its share of the batch, do: every conv and transposed conv of the
    backbone and the head, and every linear of the VFE, takes one share at
    a time (cuDNN and cuBLAS pick their algorithms by shape), and every BN
    trains through the global batch's two-pass sums, each sum taken share by
    share and then added, as the all-reduce adds them. Returns the function
    that puts the BNs' sums back."""
    from pcp_tpu_torch.models.model_utils import norm

    def by_share(f):
        return lambda x: torch.cat([f(p) for p in x.chunk(DP_WORLD)])

    def bn_forward(m, x):
        m.num_batches_tracked.add_(1)
        return m._global_batch_forward(x)

    for name, m in model.named_modules():
        if name.startswith(("backbone_2d.", "dense_head.")):
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.forward = by_share(m.forward)
            elif isinstance(m, norm.BatchNorm2d):
                m.forward = lambda x, m=m: bn_forward(m, x)
        elif name.startswith("vfe.") and isinstance(m, torch.nn.Linear):
            m.forward = by_share(m.forward)
    rank_sum = norm.rank_sum
    norm.rank_sum = lambda t, dim: sum(p.sum(dim) for p in t.chunk(DP_WORLD))
    return lambda: setattr(norm, "rank_sum", rank_sum)


def exact_zero_leaves(model):
    """Names of the leaves whose gradient is 0 in exact arithmetic, which the
    checks hold apart since rounding alone decides their sign: the conv
    biases that a BN follows (``biases_before_bn``; DiscoNet's pixel weightor
    has two outside an ``nn.Sequential``) and a sender's last BN bias of the
    object head's shape encoder (every local pools a positive value in every
    channel, so that bias moves them all alike, and the next masked BN takes
    it out)."""
    from pcp_tpu_torch.train.train_state import biases_before_bn

    names = biases_before_bn(model)
    if hasattr(model, "v2x_mid_fusion"):
        names |= {f"v2x_mid_fusion.pixel_weightor.conv1_{i}.bias" for i in (1, 2)}
    if hasattr(model, "corrector"):
        enc = model.corrector.object_head.points_shape_encoder
        names.add(f"corrector.object_head.points_shape_encoder.{len(enc) - 2}.bias")
    return names


# the models of phase 12 and the ``--set`` pairs each is built with
DP_MODELS = {"ego": (CFG_EGO, []), "car": (CFG_CAR, []), "disco": (CFG_DISCO, []),
             "ego_bf16": (CFG_EGO, ["MODEL.BF16", "True"])}
# The car and DiscoNet: two ranks against the standard one-process step in
# float32, the car's ranks taking the one process's corrector decisions on
# their rows where theirs differ (``pin_decisions``), and in float64 at
# DP_F64_TOL without pinning. Limits: the first reading on an H100 80GB
# HBM3 at 700 W with margin (car: loss 6.7e-7, terms 1.1e-6, statistics
# 1.2e-7, gradient L2 2.0e-3, worst entry 3.7e-2; DiscoNet: 0, 3.2e-7,
# 1.8e-7, 2.5e-3, 3.8e-2). The ego in BF16: two ranks against one process,
# both in BF16; a rank convolves b1 where one process convolves b2, so
# cuDNN's bfloat16 roundings differ and the layers grow them. Over seeds
# 0-3 on that card (tools_torch/bf16_rank_spread.py) the loss read
# 1.5e-6 to 1.6e-3, terms up to 2.3e-3, statistics up to 6.0e-5, gradient
# L2 0.25-0.44, worst entry 0.56-1.03 of its leaf's largest |g| (so that
# limit cannot tell a lost leaf) and a leaf's norm 0.07-0.20 off (a lost
# leaf reads 1), with flax's fast variance in the BN as widely. So it is
# also held, tighter, against the one-process BF16 step rounding as the
# ranks do (``_like_ranks``): loss up to 9.6e-8, statistics 0, gradient L2
# 5.9e-3 to 8.6e-3, worst entry 1.3e-2 to 2.1e-2, a leaf's norm 2.4e-3 to
# 5.0e-3 off over the same seeds and both variances.
DP_F32_TOL_BY_MODEL = {
    "ego": DP_F32_TOL,
    "car": {"loss": 1e-5, "tb": 1e-5, "stats": 1e-6, "grad_l2": 1e-2, "grad_entry": 0.2},
    "disco": {"loss": 1e-6, "tb": 1e-5, "stats": 1e-6, "grad_l2": 1e-2, "grad_entry": 0.2},
    "ego_bf16": {"loss": 5e-3, "tb": 5e-3, "stats": 5e-4, "grad_l2": 0.6, "grad_entry": 2.0,
                 "grad_norm": 0.5},
}
DP_BF16_LIKE_RANKS_TOL = {"loss": 1e-6, "tb": 1e-6, "stats": 1e-6, "grad_l2": 3e-2,
                          "grad_entry": 0.1, "grad_norm": 5e-2}
LIKE_RANKS_TOL = {"ego": DP_LIKE_RANKS_TOL, "ego_bf16": DP_BF16_LIKE_RANKS_TOL}


def _dp_step(name, seed, batch, device, dtype=torch.float32, like_ranks=False, timed=0, pin=None):
    """One train step of the full-width model ``name`` (DP_MODELS) from
    ``seed`` on ``batch`` (this rank's share under a process group),
    deterministic, then ``timed`` more, timed on the host's clock (the first
    pays for cuDNN's choices). ``like_ranks``: rounding as DP_WORLD ranks do
    (``_like_ranks``, the ego in float32 and in BF16). ``pin``: a sender's
    corrector decisions and flow to take where its own differ
    (``pin_decisions``). Returns the
    record (global loss and terms, launches, step times, learning rate, the
    exactly-zero leaves and, for a sender's unpinned float32 step, its
    decisions), and the state and gradients after the first step on the
    CPU."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.parallel import all_reduce_sum, replicate_state
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import (create_train_state, make_train_step,
                                                 take_train_step)

    cfg_path, sets = DP_MODELS[name]
    cfg, _, model = build(cfg_path, device=device, set_cfgs=sets)
    model.to(dtype)
    if dtype == torch.float64:  # B1 takes float32 only: its plain version, on the card
        for m in model.modules():
            if hasattr(m, "scatter_max"):
                m.scatter_max = lambda f, p, h, w: bs.ScatterMax.apply(
                    f, p, h, w, bs.bev_scatter_max_sorted_plain, 0.0)
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    replicate_state(create_train_state(model, optimizer, seed))
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _on(batch, device).items()}
    if pin is not None:
        pin_decisions(model, pin)
    restore = _like_ranks(model) if like_ranks else (lambda: None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    bs.reset_launches()
    try:
        out = take_train_step(model, optimizer, batch)
        keys = list(out["tb_dict"])
        total = all_reduce_sum(torch.stack([out["loss"].detach()]
                                           + [out["tb_dict"][k].detach() for k in keys]))
        torch.cuda.synchronize()
    finally:
        restore()
    counts = dict(bs.launches)
    record = {"loss": float(total[0]), "tb": dict(zip(keys, total[1:].tolist())),
              "launches": counts, "lr": optimizer.lr_fn(0),
              "zero_grad": sorted(exact_zero_leaves(model))}
    if hasattr(model, "corrector") and pin is None and dtype == torch.float32:
        with torch.no_grad():
            decisions, _ = corrector_decisions(model, batch, out)
        record["decisions"] = {"decisions": decisions, "flow": out["points_flow3d"].detach().cpu()}
    if pin is not None:
        del model.corrector.move_points
    torch.use_deterministic_algorithms(False)
    del out
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    step, times = make_train_step(model, optimizer), []
    for _ in range(timed):
        t0 = time.perf_counter()
        float(step(batch)[0])
        times.append((time.perf_counter() - t0) * 1e3)
    record["step_ms"] = times
    return record, state, grads


def _dp_dtypes(name):
    return (torch.float32,) if name == "ego_bf16" else (torch.float32, torch.float64)


def _dp_rank(rank, seed, tmp, hosts, pins):
    """A rank of the 2-rank check: ``_dp_step`` of each model in float32
    (a sender's corrector decisions pinned to the one process's on this
    rank's rows) and in float64 (BF16 in float32 only) on its share of
    ``hosts`` over gloo, written to ``{tmp}/rank{rank}.pt``."""
    from pcp_tpu_torch.parallel import process_group, shard_batch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # a spawned process starts from torch's defaults, where cuDNN convolves
    # float32 in TF32: off, as phase 1 has it for the one process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    with process_group(rank, DP_WORLD, f"file://{tmp}/rendezvous", "gloo"):
        for name, host in hosts.items():
            share = shard_batch(host, rank, DP_WORLD)
            b = len(share["points"])
            for dtype in _dp_dtypes(name):
                pin = pins.get(name) if dtype == torch.float32 else None
                if pin is not None:
                    pin = {k: v[rank * b:(rank + 1) * b] for k, v in pin.items()}
                timed = DP_TIMED if (name, dtype) == ("ego", torch.float32) else 0
                out[f"{name} {dtype}"] = _dp_step(name, seed, share, "cuda", dtype, timed=timed,
                                                  pin=pin)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")


def grad_norm_error(got, want, names):
    """The largest | ||got|| / ||want|| - 1 | over the leaves ``names``, and
    its leaf: a leaf whose gradient was lost reads 1."""
    err = {k: abs(float(got[k].double().norm()) / max(float(want[k].double().norm()), 1e-30) - 1)
           for k in names}
    worst = max(err, key=err.get)
    return err[worst], worst


def dp_errors(one, ranks):
    """The ranks' step against one process's: loss and terms (relative),
    running statistics, gradient entries over their leaf's largest |g| (and
    the leaf where that is worst), each leaf's gradient norm against one
    process's (``grad_norm_error``), the gradients' L2 error over all leaves,
    parameters after the step, the exactly-zero leaves apart; and whether
    the ranks agree bitwise."""
    (rec, state, grads), (rrec, rstate, rgrads) = one, ranks[0]
    zero_grad = set(rec["zero_grad"])
    params = set(grads)
    num = sum(float((rgrads[k] - grads[k]).double().pow(2).sum()) for k in params)
    den = sum(float(grads[k].double().pow(2).sum()) for k in params)
    entry = {k: (rgrads[k] - grads[k]).abs().max().item() / max(grads[k].abs().max().item(), 1e-30)
             for k in params - zero_grad}
    worst = max(entry, key=entry.get)
    norm, norm_leaf = grad_norm_error(rgrads, grads, params - zero_grad)
    return {"loss": abs(rrec["loss"] - rec["loss"]) / abs(rec["loss"]),
            "grad_norm": norm, "grad_norm_leaf": norm_leaf,
            "tb": max(abs(rrec["tb"][k] - v) / max(abs(v), 1e-30) for k, v in rec["tb"].items()),
            "stats": max((rstate[k] - v).abs().max().item() / max(v.abs().max().item(), 1.0)
                         for k, v in state.items() if "running_" in k),
            "grad_entry": entry[worst], "grad_worst_leaf": worst,
            "grad_l2": (num / den) ** 0.5,
            "params": max((rstate[k] - state[k]).abs().max().item() for k in params - zero_grad),
            "zero_grad_biases": max([(rstate[k] - state[k]).abs().max().item()
                                     for k in zero_grad & params] or [0.0]),
            "ranks_bitwise_equal": all(torch.equal(ranks[0][1][k], r[1][k])
                                       for r in ranks[1:] for k in state)}


def _dp_hosts(seed):
    """Each model's global batch: the ego's and its BF16 twin's b2 x 32768
    (``train_batch``), the car's b2 x 65536 (``sender_train_batch``, phase
    7's), DiscoNet's two merged clouds (``disco_batch``, phase 10's, agent 3
    out of the second)."""
    from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
    from pcp_tpu_torch.models import DatasetInfo

    cfgs = {name: cfg_from_yaml_file(path, CfgDict()) for name, (path, _) in DP_MODELS.items()}
    info = {name: DatasetInfo.from_data_cfg(c.DATA_CONFIG, c.CLASS_NAMES) for name, c in cfgs.items()}
    ego = train_batch(np.random.default_rng(seed + 5), DP_B, N, info["ego"])
    disco = disco_batch(cfgs["disco"], DP_B, seed + 10)
    return {"ego": ego,
            "car": sender_train_batch(np.random.default_rng(seed + 5), DP_B, SENDER_N, info["car"]),
            "disco": {k: v for k, v in disco.items() if torch.is_tensor(v)},
            "ego_bf16": ego}


def phase_dp(seed):
    """Data-parallel training: ``entry.dryrun_multichip`` at the card count
    over NCCL, then DP_WORLD ranks sharing the card over gloo on CUDA
    tensors against one process, on the same global batch at full width:
    the ego, the car and DiscoNet in float32 through B1 and in float64 (the
    scatter's plain version), the ego also against the one process rounding
    as the ranks do, and the ego in BF16, against one process and one
    process rounding as the ranks do; the ego's float32 step time.
    Returns (launches of each kernel per rank per DP step, by model; the
    record)."""
    import tempfile

    from pcp_tpu_torch.entry import dryrun_multichip

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    gate = dryrun_multichip(n, backend="nccl", device="cuda")
    gate_s = time.perf_counter() - t0
    log("dp", f"dryrun_multichip({n}) over NCCL: {gate_s:.1f} s; losses {gate['losses']}, "
              f"MoDAR rows per rank {gate['modar_rows_per_rank']}, merged eval "
              f"{gate['merged_eval']} samples")

    hosts = _dp_hosts(seed)
    f32, f64 = torch.float32, torch.float64
    one, seconds = {}, {"gate": gate_s}
    runs = [(name, dtype, False) for name in hosts for dtype in _dp_dtypes(name)] + [
        (name, f32, True) for name in LIKE_RANKS_TOL]
    for name, dtype, like in runs:
        key = f"{name} {dtype}" + (" like_ranks" if like else "")
        t0 = time.perf_counter()
        one[key] = _dp_step(name, seed, hosts[name], "cuda", dtype, like_ranks=like,
                            timed=DP_TIMED if key == f"ego {f32}" else 0)
        seconds[f"one_process {key}"] = time.perf_counter() - t0
    pins = {"car": one[f"car {f32}"][0].pop("decisions")}
    (REPO / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        torch.multiprocessing.spawn(_dp_rank, args=(seed, tmp, hosts, pins), nprocs=DP_WORLD,
                                    join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    seconds["ranks"] = time.perf_counter() - t0
    log("dp", "seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    errs = {key: dp_errors(one[key], [r[key.replace(" like_ranks", "")] for r in ranks])
            for key in one}
    # two one-process float32 steps of the ego that differ in rounding alone
    errs["ego one_vs_like_ranks"] = dp_errors(one[f"ego {f32}"], [one[f"ego {f32} like_ranks"]])
    shapes = {"ego": f"b{DP_B} x {N}", "ego_bf16": f"b{DP_B} x {N}",
              "car": f"b{DP_B} x {SENDER_N}", "disco": f"b{DP_B} x {N} merged"}
    for key, e in errs.items():
        name = key.split()[0]
        what = ("one process rounding as the ranks do vs one process" if "one_vs" in key else
                f"{DP_WORLD} ranks over gloo on CUDA tensors (one card) vs one process"
                + (" rounding as the ranks do" if "like_ranks" in key else "")
                + (", ranks' corrector decisions pinned to the one process's"
                   if key == f"car {f32}" else ""))
        log("dp", f"{key}: {what}, {shapes[name]}, full width: loss rel err {e['loss']:.3e}, "
                  f"terms {e['tb']:.3e}, running statistics {e['stats']:.3e}, gradient entries "
                  f"{e['grad_entry']:.3e} of their leaf's largest |g| (worst "
                  f"{e['grad_worst_leaf']}; L2 over all leaves {e['grad_l2']:.3e}; a leaf's norm "
                  f"{e['grad_norm']:.3e} off, {e['grad_norm_leaf']}), parameters "
                  f"after the step {e['params']:.3e}, exactly-zero leaves {e['zero_grad_biases']:.3e}"
                  f" (lr {one[f'{name} {f32}'][0]['lr']:.3e}); ranks bitwise equal: "
                  f"{e['ranks_bitwise_equal']}")
    launches = {name: [r[f"{name} {f32}"][0]["launches"] for r in ranks] for name in hosts}
    single = one[f"ego {f32}"][0]
    log("dp", f"float32 launches a rank a step {launches}; ego step time (host clock, {DP_TIMED} "
              f"steps after the compared one): one process b{DP_B} {single['step_ms']} ms; each of "
              f"{DP_WORLD} ranks sharing the card, b{DP_B // DP_WORLD} a rank: "
              + "; ".join(str(r[f"ego {f32}"][0]["step_ms"]) for r in ranks))
    limits = []
    for name in hosts:
        lr = one[f"{name} {f32}"][0]["lr"]
        tols = [(f"{name} {f32}", DP_F32_TOL_BY_MODEL[name])]
        if name in LIKE_RANKS_TOL:
            tols.append((f"{name} {f32} like_ranks", LIKE_RANKS_TOL[name]))
        for key, tol in tols:
            limits += [(key, k, lim) for k, lim in {**tol, "params": DP_ADAM_FLIP * lr}.items()]
        if f"{name} {f64}" in errs:
            limits += [(f"{name} {f64}", k, DP_F64_TOL)
                       for k in ("loss", "tb", "stats", "grad_entry", "params")]
            limits.append((f"{name} {f64}", "zero_grad_biases", 2 * lr))
    bad = [(key, k, errs[key][k], lim) for key, k, lim in limits if not errs[key][k] <= lim]
    unequal = [key for key, e in errs.items() if "one_vs" not in key and "like_ranks" not in key
               and not e["ranks_bitwise_equal"]]
    per_step = {"ego": 1, "ego_bf16": 1, "car": 1, "disco": 7}
    wrong = {name: c for name, counts in launches.items() for c in counts + [one[f"{name} {f32}"][0][
        "launches"]] if c != {k: per_step[name] * int(k == "bev_scatter_max") for k in c}}
    if bad or unequal or wrong:
        raise AssertionError(f"dp: beyond tolerance {bad}; ranks not bitwise equal {unequal}; "
                             f"launches other than B1's {per_step} a step: {wrong}")
    record = {"gate": gate, "seconds": seconds, "backend": "gloo on CUDA tensors, one card",
              "errors": errs, "single_f32": single,
              "ranks_f32": {name: [r[f"{name} {f32}"][0] for r in ranks] for name in hosts}}
    per_rank = {name: counts[0] for name, counts in launches.items()}
    kernels = {k: {name: c[k] for name, c in per_rank.items()} for k in per_rank["ego"]}
    return kernels, record


# BF16 training of the ego at b4 x 32768 against the float32 step from the
# same weights and batch: the loss and terms (relative), each gradient leaf
# as a share of its largest |g| (the exactly-zero leaves apart) and over
# all leaves in L2, each leaf's norm (``grad_norm_error``), the running
# statistics (relative to max(1, |value|)). Limits: readings on an H100
# 80GB HBM3 at 700 W with margin (loss 2.3e-3 and 3.0e-3, terms 2.9e-3 and
# 3.2e-3, statistics 1.5e-4, gradient L2 0.28 and 0.29, worst entry 0.81
# and 1.10: bfloat16's 2^-8 rounding grows through the 17 backbone layers;
# a leaf's norm 0.56 off, the VFE's first layer, whose gradient sums the
# rounded cotangent over every point). The entry's limit cannot tell a
# lost leaf; the norm's, under the 1 that a lost or doubled leaf reads, can.
BF16_B = 4
BF16_TOL = {"loss": 1e-2, "tb": 1e-2, "stats": 1e-3, "grad_l2": 0.6, "grad_entry": 1.6,
            "grad_norm": 0.8}


def bf16_train(seed):
    """The full-width ego's BF16 train step (``MODEL.BF16``) on the card
    against its float32 step: one deterministic step each from the same
    weights (``create_train_state``) on phase 5's b4 x 32768 batch, one B1
    launch each; the parameters, optimizer moments and running statistics
    stay float32; each step's time, forward+loss / backward / optimizer
    split and peak memory (``time_train_steps``). Returns the record."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, take_train_step

    cfg, info, model = build(CFG_EGO, device="cuda")
    batch = _on(train_batch(np.random.default_rng(seed + 2), BF16_B, N, info), "cuda")
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    create_train_state(model, optimizer, seed)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    models = {"f32": model, "bf16": build(CFG_EGO, "cuda", set_cfgs=["MODEL.BF16", "True"])[2]}
    steps = {}
    for name, m in models.items():
        m.load_state_dict(initial, strict=True)
        opt, _ = build_optimizer(cfg.OPTIMIZATION, m, total_iters_each_epoch=TRAIN_STEPS,
                                 total_epochs=1)
        torch.use_deterministic_algorithms(True, warn_only=True)
        bs.reset_launches()
        out = take_train_step(m, opt, batch)
        torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        moments = [v for st in opt.state.values() for v in st.values()
                   if torch.is_tensor(v) and v.is_floating_point()]
        steps[name] = {
            "loss": out["loss"].item(), "tb": {k: v.item() for k, v in out["tb_dict"].items()},
            "launches": dict(bs.launches), "bev_dtype": str(out["spatial_features_2d"].dtype),
            "grads": {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters()},
            "stats": {k: v.detach().cpu().clone() for k, v in m.state_dict().items()
                      if "running_" in k},
            "dtypes": sorted({str(p.dtype) for p in m.parameters()}
                             | {str(v.dtype) for v in moments}
                             | {str(v.dtype) for k, v in m.state_dict().items() if "running_" in k})}
        del out
        m.load_state_dict(initial, strict=True)
        opt, _ = build_optimizer(cfg.OPTIMIZATION, m, total_iters_each_epoch=TRAIN_STEPS,
                                 total_epochs=1)
        steps[name]["step_ms"], steps[name]["split"], steps[name]["peak_bytes"] = time_train_steps(
            m, opt, batch)
    zero = exact_zero_leaves(model)
    ref, got = steps["f32"], steps["bf16"]
    params = set(ref["grads"]) - zero
    entry = {k: (got["grads"][k] - ref["grads"][k]).abs().max().item()
             / max(ref["grads"][k].abs().max().item(), 1e-30) for k in params}
    worst = max(entry, key=entry.get)
    num = sum(float((got["grads"][k] - ref["grads"][k]).double().pow(2).sum()) for k in params)
    den = sum(float(ref["grads"][k].double().pow(2).sum()) for k in params)
    norm, norm_leaf = grad_norm_error(got["grads"], ref["grads"], params)
    errs = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm": norm, "grad_norm_leaf": norm_leaf,
            "tb": max(abs(got["tb"][k] - v) / max(abs(v), 1e-30) for k, v in ref["tb"].items()),
            "stats": max((got["stats"][k] - v).abs().max().item() / max(v.abs().max().item(), 1.0)
                         for k, v in ref["stats"].items()),
            "grad_entry": entry[worst], "grad_worst_leaf": worst, "grad_l2": (num / den) ** 0.5,
            "grad_entry_by_group": {g: max(v for k, v in entry.items() if k.startswith(g + "."))
                                    for g in ("vfe", "backbone_2d", "dense_head")}}
    for name, st in steps.items():
        log("dp", f"bf16_train {name}: b{BF16_B} x {N} train step, full width: loss {st['loss']:.6f}, "
                  f"launches {st['launches']}, spatial_features_2d {st['bev_dtype']}, parameters, "
                  f"moments and statistics {st['dtypes']}; median {st['step_ms']:.6f} ms over 10 "
                  "steps after 3 warm-ups (host clock, synchronized); split (median ms, CUDA events; host_*: the host's clock to issue it) "
                  + ", ".join(f"{k} {v:.6f}" for k, v in st["split"].items())
                  + f"; peak memory allocated {st['peak_bytes']} bytes "
                  f"({st['peak_bytes'] / 2**30:.3f} GiB)")
    log("dp", f"bf16_train: BF16 vs float32 step from the same weights and batch: loss rel err "
              f"{errs['loss']:.3e}, terms {errs['tb']:.3e}, running statistics {errs['stats']:.3e}, "
              f"gradient entries {errs['grad_entry']:.3e} of their leaf's largest |g| (worst "
              f"{worst}; by group {errs['grad_entry_by_group']}; L2 over all leaves "
              f"{errs['grad_l2']:.3e}; a leaf's norm {norm:.3e} off, {norm_leaf}); limits {BF16_TOL}")
    bad = [(k, errs[k], lim) for k, lim in BF16_TOL.items() if not errs[k] <= lim]
    if got["dtypes"] != ["torch.float32"] or got["bev_dtype"] != "torch.float32":
        bad.append(("dtypes", got["dtypes"], got["bev_dtype"]))
    for name, st in steps.items():
        if st["launches"] != {k: int(k == "bev_scatter_max") for k in st["launches"]}:
            bad.append((f"{name} launches", st["launches"]))
    if bad:
        raise AssertionError(f"bf16_train: {bad}")
    return {"batch": BF16_B, "points": N, "errors": errs, "limits": BF16_TOL,
            **{name: {k: v for k, v in st.items() if k not in ("grads", "stats")}
               for name, st in steps.items()}}

# ------------------------------------------------------------ 9. pipeline

# the SMOKE=1 world, points, epochs and loader workers of
# workspace/synth_experiments.sh:29-31
PIPELINE_SYN = ("{'NUM_SCENES': 3, 'KEYFRAMES_PER_SCENE': 4, 'NUM_CARS': 12, 'NUM_PEDS': 4, "
                "'WORLD': 'urban', 'NUM_PARKED': 8}")
PIPELINE_NPTS, PIPELINE_EPOCHS, PIPELINE_WORKERS = 16384, 2, 4
# The stages whose loader spawns PIPELINE_WORKERS workers, a train and an
# eval loader; the others load in the main process (``--workers 0``, the
# same items): a spawned worker takes about 9 s to start on the card's
# host, which made most of a stage's time (on an H100's host the 18 stages
# took 223 s with one worker a loader, 34 s with none).
WORKER_STAGES = ("train_car", "eval_lately_async")
PIPELINE_CFGS = "tools/cfgs/v2x_sim_models/{}.yaml"


def _pipeline_stages(root):
    """(name, kind, CLI main, argv, run directory) of the SMOKE=1 stages, in
    the order of ``pcp_tpu_torch/workspace/synth_experiments.sh``: the
    senders, their exchange passes, the lately ego and the sync early-fusion
    ego, the evaluations lately_sync, lately_async, early_sync and car, the
    late-fusion evaluations late_sync (NMS) and late_sync_wnms (weighted box
    fusion), the lately ego fed oracle senders (lately_oracleswap_sync) and
    with half the broadcasts dropped (lately_drop05_async), the single-agent
    ego and its evaluation, then DiscoNet trained and evaluated. The loaders
    of WORKER_STAGES spawn PIPELINE_WORKERS workers, the others none."""
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli
    from pcp_tpu_torch.workspace import v2x_gen_exchange_database as genx

    exch = str(root / "exchange_database")
    common = ["DATA_CONFIG.USE_SYNTHETIC_DATA", "True",
              "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", str(PIPELINE_NPTS),
              "DATA_CONFIG.SYNTHETIC", PIPELINE_SYN, "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1",
              "DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY", exch, "OPTIMIZATION.LR", "0.003"]
    base = ["--batch_size", "4", "--device", "cuda", "--output_root", str(root)]

    def workers(name):
        return ["--workers", str(PIPELINE_WORKERS if name in WORKER_STAGES else 0)]

    def run_dir(cfg, tag):
        return root / "cfgs" / "v2x_sim_models" / cfg / tag

    def ckpt(cfg, tag):
        return str(run_dir(cfg, tag) / "ckpt" / f"checkpoint_epoch_{PIPELINE_EPOCHS}.pth")

    def train(name, cfg, tag, ratio, *extra):
        return (name, "train", train_cli.main,
                lambda: ["--cfg_file", PIPELINE_CFGS.format(cfg), *base, *workers(name),
                         "--extra_tag", tag, "--epochs", str(PIPELINE_EPOCHS),
                         "--num_epochs_to_eval", "0", "--profile", "--set", *common,
                         "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", str(ratio), *extra],
                run_dir(cfg, tag))

    def gen(agent):
        return (f"gen_exchange_{agent}", "gen", genx.main,
                lambda: ["--agent", agent, "--ckpt", ckpt(f"v2x_pointpillar_basic_{agent}", "smoke"),
                         "--synthetic", "--device", "cuda", *workers(f"gen_exchange_{agent}"),
                         "--set", "MAX_POINTS_PER_SAMPLE", str(PIPELINE_NPTS), "SYNTHETIC",
                         PIPELINE_SYN, "MINI_TRAINVAL_STRIDE", "1",
                         "EXCHANGE_DATABASE_DIRECTORY", exch], None)

    def ev(name, cfg, tag, *extra):
        weights = [] if cfg == "v2x_late_fusion" else ["--ckpt", ckpt(cfg, tag)]
        return (f"eval_{name}", "late" if not weights else "eval", test_cli.main,
                lambda: ["--cfg_file", PIPELINE_CFGS.format(cfg), *base, *workers(f"eval_{name}"),
                         "--extra_tag", tag, *weights, "--eval_tag", name, "--infer_time", "--set",
                         *common, "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1", *extra],
                run_dir(cfg, tag))

    car, rsu = "v2x_pointpillar_basic_car", "v2x_pointpillar_basic_rsu"
    ego, early, late = ("v2x_pointpillar_basic_ego", "v2x_pointpillar_basic_ego_early",
                        "v2x_late_fusion")
    makers = []
    for key, (cfg, tag) in DISCO_MAKERS.items():
        makers += [f"MODEL.{key}.CKPT", ckpt(cfg, tag)]
    sync, single = ("DATA_CONFIG.EXCHANGE_PREVIOUS", "False"), ("DATA_CONFIG.EXCHANGE_MODAR", "False")
    now = ("DATA_CONFIG.EXCHANGE_SETTING", "now")
    return [train("train_car", car, "smoke", 4), train("train_rsu", rsu, "smoke", 1),
            gen("car"), gen("rsu"), train("train_ego", ego, "smoke", 1),
            train("train_early_sync", early, "smoke_sync", 1, *sync),
            ev("lately_sync", ego, "smoke", "DATA_CONFIG.EXCHANGE_NOW", "True"),
            ev("lately_async", ego, "smoke"), ev("early_sync", early, "smoke_sync", *sync),
            ev("car", car, "smoke"),
            ev("late_sync", late, "smoke", *now),
            ev("late_sync_wnms", late, "smoke", *now, "MODEL.BOX_FUSION_METHOD", "weighted_nms"),
            ev("lately_oracleswap_sync", ego, "smoke", "DATA_CONFIG.EXCHANGE_ORACLE", "True",
               "DATA_CONFIG.EXCHANGE_NOW", "True"),
            ev("lately_drop05_async", ego, "smoke", "DATA_CONFIG.EXCHANGE_DROPOUT", "0.5"),
            train("train_single", ego, "smoke_nocollab", 1, *single),
            ev("single", ego, "smoke_nocollab", *single),
            train("train_disco_sync", DISCO_CFG, "smoke_dsync", 1, *sync, *makers),
            ev("disco_sync", DISCO_CFG, "smoke_dsync", *sync)]


# the stages whose first scatter (a training step's, an eval batch's) phase 9
# keeps for B1's check, and the record's key of each check (DiscoNet's first
# is its RSU maker's branch)
B1_CHECKS = {"train_ego": "bev_scatter_max", "train_early_sync": "bev_scatter_max_early",
             "eval_lately_oracleswap_sync": "bev_scatter_max_oracleswap",
             "eval_lately_drop05_async": "bev_scatter_max_drop05",
             "train_disco_sync": "bev_scatter_max_disco"}
# DiscoNet's frozen makers in phase 9: (config, train tag) of the checkpoint
# each takes
DISCO_CFG = "v2x_pointpillar_disco"
DISCO_MAKERS = {"BEV_MAKER_RSU": ("v2x_pointpillar_basic_rsu", "smoke"),
                "BEV_MAKER_CAR": ("v2x_pointpillar_basic_car", "smoke"),
                "BEV_MAKER_EARLY": ("v2x_pointpillar_basic_ego_early", "smoke_sync")}


def check_overlay(root):
    """The DiscoNet checkpoint of phase 9 holds, in each frozen maker, the
    VFE and backbone of the checkpoint that maker took. Returns the number
    of tensors compared."""
    def state(cfg, tag):
        path = (root / "cfgs" / "v2x_sim_models" / cfg / tag / "ckpt"
                / f"checkpoint_epoch_{PIPELINE_EPOCHS}.pth")
        return torch.load(path, map_location="cpu", weights_only=True)["model_state"]

    disco, compared = state(DISCO_CFG, "smoke_dsync"), 0
    for key, src in DISCO_MAKERS.items():
        for name, value in state(*src).items():
            if name.split(".")[0] in ("vfe", "backbone_2d"):
                if not torch.equal(disco[f"{key.lower()}.{name}"], value):
                    raise AssertionError(f"{key.lower()}.{name} is not the overlaid {src} tensor")
                compared += 1
    return compared


def eval_items(argv):
    """(config, items of the test split) of an eval stage's argv, as its
    CLI builds them."""
    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools.train import load_cfg

    cfg, _ = load_cfg(test_cli.parse_args(argv))
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=1, workers=0,
                                training=False)
    return cfg, [ds[i] for i in range(len(ds))]


def silent_agents(argv):
    """(agents that sent the ego no MoDAR row, agents in all) over the
    items of an eval stage, from each item's ``metadata["exchange"]``."""
    _, items = eval_items(argv)
    counts = [v[1] for item in items for v in item["metadata"]["exchange"].values()]
    return sum(c == 0 for c in counts), len(counts)


def oracle_scores(name, stages):
    """Under oracle senders every MoDAR row of the stage's items has score
    1. Returns the record."""
    cfg, items = eval_items(stages[name])
    features = list(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    points = np.concatenate([item["points"] for item in items])
    modar = points[:, features.index("box_label")] > 0
    scores = points[modar, features.index("box_score")]
    if not modar.any() or not (scores == 1.0).all():
        raise AssertionError(f"pipeline {name}: {modar.sum()} MoDAR rows, scores "
                             f"{np.unique(scores)[:8]} (1 required)")
    log("pipeline", f"{name}: {int(modar.sum())} MoDAR rows in {len(items)} items, every score 1")
    return {"modar_rows": int(modar.sum()), "items": len(items)}


def dropped_broadcasts(name, stages):
    """Under broadcast dropout more agents send the ego nothing than in
    lately_async. Returns the record."""
    dropped, agents = silent_agents(stages[name])
    base, _ = silent_agents(stages["eval_lately_async"])
    if dropped <= base:
        raise AssertionError(f"pipeline {name}: {dropped} of {agents} agents sent nothing, "
                             f"{base} in lately_async (more required)")
    log("pipeline", f"{name}: {dropped} of {agents} agents sent the ego no MoDAR row, "
                    f"{base} in eval_lately_async")
    return {"silent_agents": dropped, "agents": agents, "silent_agents_lately_async": base}


# the eval stages of phase 9 whose exchange is checked, and the check of each
EXCHANGE_CHECKS = {"eval_lately_oracleswap_sync": oracle_scores,
                   "eval_lately_drop05_async": dropped_broadcasts}


def phase_pipeline():
    """Phase 9: the SMOKE=1 pipeline through the port's CLIs on the card, in
    ``build/pipeline``, then DiscoNet from its checkpoints. Returns the
    record of each stage (the two exchange checks too), the overlay check
    and B1's checks on the lately ego's, the early ego's and DiscoNet's
    training inputs and the oracle-swap and dropout evaluations' inputs."""
    import shutil

    from pcp_tpu_torch.models.vfe import dynamic_pillar_vfe as vfe_module
    from pcp_tpu_torch.ops import bev_scatter as bs

    root = REPO / "build" / "pipeline"
    shutil.rmtree(root, ignore_errors=True)
    record, seen, stages = {}, {}, {}
    scatter = vfe_module.bev_scatter_max_sorted

    for name, kind, main_fn, argv, run_dir in _pipeline_stages(root):
        stages[name] = argv()
        def spy(feats, pids, h, w, name=name):  # the stage's first training scatter
            if name not in seen:
                seen[name] = (feats.detach().clone(), pids.clone(), h, w)
            return scatter(feats, pids, h, w)

        vfe_module.bev_scatter_max_sorted = spy if name in B1_CHECKS else scatter
        bs.reset_launches()
        t0 = time.perf_counter()
        try:
            out = main_fn(argv())
            torch.cuda.synchronize()
        finally:
            vfe_module.bev_scatter_max_sorted = scatter
        seconds = time.perf_counter() - t0
        launches = dict(bs.launches)
        rec = {"seconds": seconds, "launches": launches}
        if kind == "late":  # a host model: no kernel, nothing on the card
            if any(launches.values()):
                raise AssertionError(f"pipeline {name}: late fusion launched {launches}")
        elif launches["bev_scatter_max"] == 0 or sum(launches.values()) != launches["bev_scatter_max"]:
            raise AssertionError(f"pipeline {name}: expected launches of bev_scatter_max only, "
                                 f"got {launches}")
        if kind == "train":
            profile = json.loads((run_dir / "profile" / "trace_summary.json").read_text())
            rec.update(steps=out["steps"], data_ms=out["data_ms_median"],
                       step_ms=out["step_ms_median"], losses=out["losses"],
                       device_idle_share=profile["device_idle_share"],
                       profile_window_ms=profile["window_ms"])
            if not out["steps"] or not np.isfinite(out["losses"]).all():
                raise AssertionError(f"pipeline {name}: losses {out['losses']}")
            detail = (f"{out['steps']} steps, median data {out['data_ms_median']:.6f} ms and step "
                      f"{out['step_ms_median']:.6f} ms a batch, losses "
                      + " ".join(f"{v:.6f}" for v in out["losses"])
                      + f"; traced steps: window {profile['window_ms']:.6f} ms, device idle share "
                      f"{profile['device_idle_share']:.6f}")
        elif kind == "gen":
            rec["clouds"] = out
            files = len(list((root / "exchange_database").glob("*.npz")))
            if not all(out.values()) or not files:
                raise AssertionError(f"pipeline {name}: wrote {out} clouds, {files} files")
            detail = f"clouds broadcast {out}; {files} files in the exchange database"
        else:
            # infer_time leaves out the first two batches: a set of fewer has none
            keys = ("mAP", "NDS", "recall/rcnn_0.3", "recall/rcnn_0.5", "recall/rcnn_0.7",
                    "infer_time_ms_per_batch")
            rec.update({k: float(out[k]) for k in keys if k in out})
            if not all(np.isfinite(rec[k]) for k in keys[:5]):
                raise AssertionError(f"pipeline {name}: results not finite {rec}")
            detail = ", ".join(f"{k} {rec[k]:.6f}" for k in keys if k in rec)
        record[name] = rec
        log("pipeline", f"{name}: {seconds:.3f} s; {detail}; kernel launches {launches}")
        if name in EXCHANGE_CHECKS:
            rec["exchange"] = EXCHANGE_CHECKS[name](name, stages)

    record["disco_overlay"] = {"tensors": check_overlay(root)}
    log("pipeline", f"train_disco_sync: its makers hold the {record['disco_overlay']['tensors']} VFE "
                    "and backbone tensors of the car, RSU and sync early checkpoints, bitwise")
    for stage, key in B1_CHECKS.items():
        feats, pids, h, w = seen[stage]
        first = "batch's" if stage.startswith("eval_") else "step's"
        record[key] = b1_on_inputs("pipeline", f"{stage}'s first {first}", feats, pids, h, w)
    total = sum(r["seconds"] for k, r in record.items() if "seconds" in r)
    log("pipeline", f"stages {len(record) - len(B1_CHECKS) - 1}, {total:.3f} s in all")
    return record


# ------------------------------------------------------------- 10. disco

# the synvf world, cut to a few scenes: the clouds of the DiscoNet rows
DISCO_SYN = ("{'NUM_SCENES': 6, 'KEYFRAMES_PER_SCENE': 3, 'NUM_CARS': 24, 'NUM_PEDS': 8, "
             "'WORLD': 'urban', 'NUM_PARKED': 16, 'VISIBLE_FACES': True}")
DISCO_STEPS = 6  # the loss curve: steps on one batch
DISCO_ABSENT = (1, 3)  # (sample, agent) taken out of the batch: an absent agent
MAKERS = ("bev_maker_rsu", "bev_maker_car", "bev_maker_early")


def disco_batch(cfg, b, seed):
    """``b`` collated training items of the DiscoNet dataset (merged clouds
    of six agents, ``MAX_POINTS_PER_SAMPLE`` 32768, augmented), with agent 3
    taken out of the second sample: its points masked, its pose the
    identity, ``agent_present`` False. Host tensors as the loader hands them
    to the model."""
    from pcp_tpu_torch.config import cfg_from_list
    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.train.train_utils import _to_device_batch

    cfg_from_list(["DATA_CONFIG.USE_SYNTHETIC_DATA", "True", "DATA_CONFIG.SYNTHETIC", DISCO_SYN,
                   "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", str(N), "DATA_CONFIG.MINI_TRAINVAL_STRIDE",
                   "1", "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1"], cfg)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=b, workers=0,
                                training=True)
    ds.rng = np.random.RandomState(seed)
    batch = ds.collate_batch([ds[i] for i in range(b)])
    i, a = DISCO_ABSENT
    gone = batch["points"][i, :, 5] == a
    batch["points_mask"][i, gone] = False
    batch["se3_from_ego_arr"][i, a] = np.eye(4)
    batch["agent_present"][i, a] = False
    return _to_device_batch(batch, "cpu")


def disco_stages(model, training):
    """The DiscoNet forward cut at module boundaries: the three makers, the
    ego's VFE, scatter and backbone, the mid fusion, the head (and in
    training its loss)."""
    head = model.dense_head
    stages = [(name, getattr(model, name)) for name in MAKERS]
    stages += [("vfe", model.vfe), ("map_to_bev", model.map_to_bev),
               ("backbone_2d", model.backbone_2d), ("v2x_mid_fusion", model.v2x_mid_fusion),
               ("dense_head", head)]
    if training:
        stages.append(("loss", lambda d: dict(d, loss=head.get_loss(d["head_preds"],
                                                                    d["head_targets"])[0]
                                             + d["distill_loss"])))
    return stages


def _disco_card_vs_cpu(model, sd, batch, pp):
    """The second sample (an agent absent) on the card against the CPU, same
    weights and points, both under deterministic algorithms: the ego's BEV
    (atol/rtol 1e-5), every agent's ``bev_img`` (a backbone's output:
    atol/rtol 1e-4), the head (printed), the surviving boxes under the
    margin rule."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    _, _, cpu_model = build(CFG_DISCO, device="cpu")
    cpu_model.load_state_dict(sd, strict=True)
    one = {k: v[1:2] for k, v in batch.items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.inference_mode():
        gpu = model(_on(one, "cuda"))
        t0 = time.perf_counter()
        cpu = cpu_model(one)
        cpu_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    errs = {"ego_bev": (gpu["spatial_features"].cpu() - cpu["spatial_features"]).abs().max().item()}
    torch.testing.assert_close(gpu["spatial_features"].cpu(), cpu["spatial_features"],
                               atol=1e-5, rtol=1e-5)
    for a, img in cpu["bev_img"].items():  # a backbone's output: cuDNN's sums against the CPU's
        errs[f"bev_img_{a}"] = (gpu["bev_img"][a].cpu() - img).abs().max().item()
        torch.testing.assert_close(gpu["bev_img"][a].cpu(), img, atol=1e-4, rtol=1e-4)
    head = {k: (gpu["head_preds"][0][k].cpu() - t).abs().max().item()
            for k, t in cpu["head_preds"][0].items()}
    heat = torch.sigmoid(cpu["head_preds"][0]["hm"][0].double()).numpy().reshape(-1)
    matched = match_surviving_boxes(
        {k: v[0].cpu().numpy() for k, v in gpu["final_box_dicts"].items()},
        {k: v[0].numpy() for k, v in cpu["final_box_dicts"].items()}, heat,
        top_k=int(pp.MAX_OBJ_PER_SAMPLE), score_thresh=float(pp.SCORE_THRESH),
        post_max=int(pp.NMS_CONFIG.NMS_POST_MAXSIZE))
    log("disco", f"b1 eval card vs CPU (sample {DISCO_ABSENT[0]}, agent {DISCO_ABSENT[1]} absent; "
                 f"{cpu_s:.1f} s on the CPU): max_abs_err {errs} (ego BEV atol/rtol 1e-5, bev_img "
                 f"1e-4); head "
                 f"max_abs_err {head} (printed); {matched} surviving boxes matched under the "
                 "margin rule")
    return {"max_abs_err": errs, "head_max_abs_err": head, "boxes_matched": matched, "cpu_s": cpu_s}


def phase_disco(seed, boxflow_bytes=None):
    """Phase 10: DiscoNet mid fusion at full width on the card. Returns
    (launches of each kernel in one eval forward, in one train step; the
    record)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg, info, model = build(CFG_DISCO, device="cuda")
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    t0 = time.perf_counter()
    host = disco_batch(cfg, b, seed + 10)
    data_s = time.perf_counter() - t0
    batch = _on(host, "cuda")
    pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    agents = [sorted(set(host["points"][i, host["points_mask"][i], 5].long().tolist()))
              for i in range(b)]
    log("disco", f"{sum(p.numel() for p in model.parameters())} parameters "
                 f"({sum(p.numel() for n, p in model.named_parameters() if n.startswith('bev_maker'))}"
                 f" in the frozen makers); b{b} x {N} merged clouds ({data_s:.1f} s to make): valid "
                 f"rows {host['points_mask'].sum(1).tolist()}, agents {agents}, gt boxes "
                 f"{(host['gt_boxes'][..., 7] > 0).sum(1).tolist()}, present "
                 f"{host['agent_present'].int().tolist()}")

    # eval: one forward with every count at 0, the makers' scatter inputs kept
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    seen, car_vfe = [], model.bev_maker_car.vfe
    scatter = car_vfe.scatter_max

    def spy(feats, pids, h, w):
        seen.append((feats.detach().clone(), pids.clone(), h, w))
        return scatter(feats, pids, h, w)

    car_vfe.scatter_max = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        bs.reset_launches()
        out = model(batch)
        torch.cuda.synchronize()
        eval_counts = dict(bs.launches)
    eval_peak = torch.cuda.max_memory_allocated()
    car_vfe.scatter_max = scatter
    if eval_counts != {k: 6 * int(k == "bev_scatter_max") for k in eval_counts}:
        raise AssertionError(f"DiscoNet eval forward: expected 6 launches of bev_scatter_max (ego, "
                             f"RSU, cars 2-5), got {eval_counts}")
    if sorted(out["bev_img"]) != [0, 2, 3, 4, 5] or "bev_img_early" in out:
        raise AssertionError(f"eval forward: bev_img of agents {sorted(out['bev_img'])}")
    fbd = out["final_box_dicts"]
    if not torch.isfinite(fbd["pred_boxes"]).all() or not torch.isfinite(out["spatial_features_2d"]).all():
        raise AssertionError("DiscoNet eval forward: values not finite")
    log("disco", f"eval forward b{b}: kernel launches {eval_counts}; valid boxes per cloud "
                 f"{fbd['pred_valid'].sum(1).tolist()}; fused BEV {tuple(out['spatial_features_2d'].shape)}")

    # B1 on a maker branch's inputs: the car maker's agent-3 branch, whose
    # second sample is all sentinels
    feats, pids, h, w = seen[1]
    hw = h * w
    occupied = (pids < hw).sum(1).tolist()
    if occupied[DISCO_ABSENT[0]] != 0 or not all(occupied[i] for i in range(b) if i != DISCO_ABSENT[0]):
        raise AssertionError(f"agent 3's branch: occupied rows per sample {occupied}")
    kernel = b1_on_inputs("disco", "the car maker's agent-3 branch (sample 1 all sentinels)",
                          feats, pids, h, w)
    kernel["occupied_rows"] = occupied
    empty = bs.bev_scatter_max_sorted_cuda(feats[1:2].contiguous(), pids[1:2].contiguous(), h, w)
    if empty.abs().max().item() != 0.0:
        raise AssertionError("an all-sentinel sample must scatter to a zero grid")
    del seen, feats, pids

    # timings of the eval forward and its stages
    with torch.inference_mode():
        eval_ms = cuda_ms(lambda: model(batch), warmup=2, iters=10)
        eval_stages = stage_ms(disco_stages(model, False), batch)
    makers_ms = sum(eval_stages[m] for m in MAKERS)
    log("disco", f"eval forward b{b} x {N}, full width, TF32 off: median {eval_ms:.6f} ms over 10 "
                 f"(CUDA events), {b / eval_ms * 1e3:.3f} clouds/s; peak memory allocated {eval_peak} "
                 "bytes; stages (median ms of 10): " + ", ".join(f"{k} {v:.6f}"
                                                                  for k, v in eval_stages.items())
                 + f"; the makers' share {makers_ms / sum(eval_stages.values()):.6f}")
    compressed = model.v2x_mid_fusion.compressor.conv1.out_channels * (h // 4) * (w // 4) * 4
    log("disco", f"one agent's compressed BEV a keyframe: {model.v2x_mid_fusion.compressor.conv1.out_channels}"
                 f" x {h // 4} x {w // 4} float32 = {compressed} bytes"
                 + ("" if boxflow_bytes is None else
                    f", against the boxflow's {boxflow_bytes} bytes (phase 6): "
                    f"{compressed / boxflow_bytes:.1f} times"))
    check = _disco_card_vs_cpu(model, sd, host, pp)

    # training: the loss curve on one batch, every count at 0 before it
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=DISCO_STEPS,
                                   total_epochs=1)
    state = create_train_state(model, optimizer, seed)
    frozen = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("bev_maker")}
    step = make_train_step(model, optimizer)
    bs.reset_launches()
    curve = [step(batch) for _ in range(DISCO_STEPS)]
    torch.cuda.synchronize()
    train_counts = dict(bs.launches)
    losses = [loss.item() for loss, _ in curve]
    distill = [tb["distill_loss"].item() for _, tb in curve]
    log("disco", "loss curve " + " ".join(f"{v:.6f}" for v in losses) + "; distill_loss "
                 + " ".join(f"{v:.6e}" for v in distill) + f"; launches {train_counts} in "
                 f"{DISCO_STEPS} steps, step count {state.step}")
    if train_counts != {k: 7 * DISCO_STEPS * int(k == "bev_scatter_max") for k in train_counts}:
        raise AssertionError(f"expected 7 launches of bev_scatter_max a DiscoNet train step (ego, RSU, "
                             f"cars 2-5, early), got {train_counts}")
    if not (np.isfinite(losses).all() and np.isfinite(distill).all() and losses[-1] < losses[0]):
        raise AssertionError(f"DiscoNet training: losses {losses}, distill {distill}")
    changed = [k for k, v in model.state_dict().items() if k in frozen and not torch.equal(v, frozen[k])]
    if changed or any(p.grad is not None for n, p in model.named_parameters() if n.startswith("bev_maker")):
        raise AssertionError(f"the frozen makers changed in training: {changed}")
    log("disco", f"the makers' {len(frozen)} parameters and buffers are bitwise unchanged after "
                 f"{DISCO_STEPS} steps, and none holds a gradient")

    step_ms, split, peak = time_train_steps(model, optimizer, batch)
    train_stages = stage_ms(disco_stages(model, True), batch)
    makers_train = sum(train_stages[m] for m in MAKERS)
    ego_fwd = split["forward_loss"] - makers_train
    log("disco", f"train step b{b} x {N}, full width, TF32 off: median {step_ms:.6f} ms over 10 after "
                 f"3 warm-ups (host clock, synchronized), {b / step_ms * 1e3:.3f} samples/s; split "
                 f"(median ms, CUDA events): makers' forward {makers_train:.6f} (from the stages), "
                 f"ego forward and loss {ego_fwd:.6f}, backward {split['backward']:.6f}, optimizer "
                 f"{split['optimizer']:.6f}; peak memory allocated {peak} bytes "
                 f"({peak / 2**30:.3f} GiB); training forward stages (median ms of 10): "
                 + ", ".join(f"{k} {v:.6f}" for k, v in train_stages.items()))
    record = {"config": str(CFG_DISCO.relative_to(REPO)), "batch": b, "points": N,
              "valid_rows": host["points_mask"].sum(1).tolist(), "agents": agents,
              "eval_launches": eval_counts, "train_launches_per_step":
                  {k: v // DISCO_STEPS for k, v in train_counts.items()},
              "eval_ms": eval_ms, "eval_clouds_per_s": b / eval_ms * 1e3, "eval_stages_ms": eval_stages,
              "eval_makers_share": makers_ms / sum(eval_stages.values()), "eval_peak_bytes": eval_peak,
              "step_ms": step_ms, "samples_per_s": b / step_ms * 1e3,
              "makers_forward_ms": makers_train, "ego_forward_loss_ms": ego_fwd,
              **{f"{k}_ms": v for k, v in split.items()}, "train_stages_ms": train_stages,
              "peak_bytes": peak, "losses": losses, "distill_losses": distill,
              "compressed_bev_bytes": compressed, "boxflow_bytes": boxflow_bytes,
              "card_vs_cpu": check, "bev_scatter_max_maker_branch": kernel}
    del model, optimizer, state, batch, out
    torch.cuda.empty_cache()
    return ({k: v for k, v in eval_counts.items()},
            {k: v // DISCO_STEPS for k, v in train_counts.items()}, record)


# ------------------------------------------------------------ a11. anchor car and SECOND

CFGS = REPO / "tools" / "cfgs" / "v2x_sim_models"
# (name, config, points a cloud, the kernel launches its forward and step
# must show: B1 once for the pillar VFE, nothing for the sparse voxel path,
# which of its b1 forward and b1 train step are held against the CPU). The
# SECOND RSU's MODEL is the SECOND car's (its config differs in the dataset
# and the learning rate), so it runs here only through its CLI stages,
# which train it and broadcast from it. The SECOND car's b1 step against
# the CPU (25 s of CPU and 40 s more at half the threads) is left out: its
# parts are each held in a step elsewhere, the SECOND backbones and
# CenterHead by the SECOND ego's, the corrector by phase 7's senders
A11_MODELS = (
    ("anchor_car", CFGS / "v2x_pointpillar_anchor_car.yaml", SENDER_N, 1, ("forward", "step")),
    ("second_car", CFGS / "v2x_second_car.yaml", SENDER_N, 0, ("forward",)),
    ("second_ego", CFGS / "v2x_second_ego.yaml", N, 0, ("forward", "step")))
A11_TRAIN_STEPS = 4  # the loss curve: steps on one batch, the last under the first
A11_CLI_EPOCHS = 1  # epochs of each CLI training stage (2 until phase kitti came)
# the share of the anchor car's anchors that the seeded weights score above
# SCORE_THRESH (``balance_anchor_bias``): 32768 anchors a cloud, so about
# 6500, more than NMS_PRE_MAXSIZE 4096
A11_ANCHOR_SHARE = 0.2
A11_BEV_TOL = (1e-4, 1e-4)  # card against CPU, the BEV before the 2D backbone (atol, rtol)
# card against CPU, one b1 step: a gradient group's largest error of a leaf
# over that leaf's largest |g| (else SPREAD_FACTOR x the CPU's own spread,
# as in phase 5). cuDNN's float32 convolutions of the SECOND 2D backbone
# (256 channels in, 128 x 128, about 350 ms a b4 forward) round coarser
# than the CPU's, beyond the CPU's own spread between thread counts; first
# readings on an H100 80GB HBM3 at 700 W: the ego's backbone_2d 7.9e-2
# (the CPU's spread 1.3e-2), backbone_3d 2.8e-2 (6.7e-3), the car's head
# 3.5e-4 (4.1e-5). A lost or doubled leaf reads 1
A11_GRAD_RTOL = 0.1


def a11_stages(model):
    """The eval forward cut at module boundaries: vfe, backbone_3d,
    map_to_bev, backbone_2d, corrector, the head's convs, then the decode
    and NMS (post-processing)."""
    from pcp_tpu_torch.models.detectors.pointpillar import generic_post_processing

    names = [n for n in ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "corrector")
             if hasattr(model, n)]
    stages = [(n, getattr(model, n)) for n in names]
    head = model.dense_head
    if hasattr(head, "heads_list"):  # CenterHead: the convs, then decode and NMS
        stages += [("dense_head", lambda d: dict(d, head_preds=[h(head.shared_conv(
                       d["spatial_features_2d"])) for h in head.heads_list])),
                   ("post_processing", lambda d: dict(d, final_box_dicts=head.generate_predicted_boxes(
                       d["head_preds"])))]
    else:  # the anchor head decodes its anchors; the detector's NMS follows
        stages += [("dense_head", head),
                   ("post_processing", lambda d: dict(d, final_box_dicts=generic_post_processing(
                       model.model_cfg, d)))]
    return stages


def a11_train_stages(model):
    """The training forward cut at module boundaries, then the loss."""
    names = [n for n in ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "corrector",
                         "dense_head") if hasattr(model, n)]
    head = model.dense_head

    def loss(d):
        total = head.get_loss(d["head_preds"], d["head_targets"])[0]
        return dict(d, loss=total + d["corrector_loss"] if "corrector_loss" in d else total)

    return [(n, getattr(model, n)) for n in names] + [("loss", loss)]


def _a11_card_vs_cpu(name, cfg_path, sd, model, host, cfg):
    """b1 eval on the card (deterministic) against the CPU for a model
    without a corrector: voxel and output ids equal (SECOND), the BEV before
    the 2D backbone within A11_BEV_TOL, the head's outputs within HEAD_ATOL,
    the surviving boxes under the margin rule."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    _, _, cpu_model = build(cfg_path, device="cpu")
    cpu_model.load_state_dict(sd, strict=True)
    one = {k: v[:1].clone() for k, v in host.items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.inference_mode():
        gpu = model(_on(one, "cuda"))
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = cpu_model(one)
    cpu_s = time.perf_counter() - t0
    err = {}
    if "voxel_ids" in cpu:
        for key, got, want in (("voxel_ids", gpu["voxel_ids"], cpu["voxel_ids"]),
                               ("encoded_ids", gpu["encoded_spconv_tensor"][0],
                                cpu["encoded_spconv_tensor"][0])):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"a11 {name}: {key} differ between card and CPU")
    got, want = gpu["spatial_features"].cpu(), cpu["spatial_features"]
    err["bev"] = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, atol=A11_BEV_TOL[0], rtol=A11_BEV_TOL[1])
    if "batch_cls_preds" in cpu:  # the anchor head: its decoded anchors, scored by class max
        pp = cfg.MODEL.POST_PROCESSING
        pairs = {k: (gpu[f"batch_{k}_preds"], cpu[f"batch_{k}_preds"]) for k in ("cls", "box")}
        logits = cpu["batch_cls_preds"][0].double().max(-1)[0]
        top_k = int(pp.NMS_CONFIG.NMS_PRE_MAXSIZE)
    else:
        pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
        pairs = {k: (gpu["head_preds"][0][k], v) for k, v in cpu["head_preds"][0].items()}
        logits = cpu["head_preds"][0]["hm"][0].double().reshape(-1)
        top_k = int(pp.MAX_OBJ_PER_SAMPLE)
    for key, (g, w) in pairs.items():
        err[f"head.{key}"] = (g.cpu() - w).abs().max().item()
        torch.testing.assert_close(g.cpu(), w, atol=HEAD_ATOL, rtol=A11_BEV_TOL[1])
    matched = match_surviving_boxes(
        {k: v[0].cpu().numpy() for k, v in gpu["final_box_dicts"].items()},
        {k: v[0].numpy() for k, v in cpu["final_box_dicts"].items()},
        torch.sigmoid(logits).numpy(), top_k=top_k, score_thresh=float(pp.SCORE_THRESH),
        post_max=int(pp.NMS_CONFIG.NMS_POST_MAXSIZE))
    log("a11", f"{name}: b1 card vs CPU ({cpu_s:.1f} s on the CPU), max_abs_err {err}; tolerances: "
               f"bev atol {A11_BEV_TOL[0]} rtol {A11_BEV_TOL[1]}, head atol {HEAD_ATOL} rtol "
               f"{A11_BEV_TOL[1]}"
               + ("; voxel and output ids equal" if "voxel_ids" in cpu else "")
               + f"; {matched} surviving boxes matched under the margin rule")
    return dict(err, boxes_matched=matched, cpu_s=cpu_s)


def balance_anchor_bias(model, sd, batch, thresh):
    """Shift the anchor head's cls bias, in ``sd`` and in ``model``, so that
    A11_ANCHOR_SHARE of the batch's anchors score above ``thresh``: seeded
    weights otherwise put every anchor on one side of SCORE_THRESH."""
    with torch.inference_mode():
        logits = model(batch)["batch_cls_preds"].max(-1)[0].double().reshape(-1)
    cut = torch.quantile(logits.cpu(), 1 - A11_ANCHOR_SHARE)
    shift = float(np.log(thresh / (1 - thresh))) - cut.item()
    sd["dense_head.conv_cls.bias"] = sd["dense_head.conv_cls.bias"] + shift
    model.load_state_dict(sd, strict=True)


def run_a11_model(name, cfg_path, n, b1_launches, against_cpu, seed):
    """One model of phase a11 at full width on the card. Returns (its record,
    launches of each kernel in one forward, in one train step)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import biases_before_bn, create_train_state, make_train_step

    cfg, info, model = build(cfg_path, device="cuda")
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    rng = np.random.default_rng(seed + 20)
    sender = hasattr(model, "corrector")
    if sender:
        host = sender_points(rng, b, n)
    else:
        pts = realistic_points(rng, b, n, info.num_point_features)
        host = {"points": torch.from_numpy(pts), "points_mask": torch.ones((b, n), dtype=torch.bool)}
    batch = _on(host, "cuda")
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    if sender:
        balance_seg_bias(model, sd, batch)
    if hasattr(model.dense_head, "conv_cls"):
        balance_anchor_bias(model, sd, batch, float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH))
    want = {k: b1_launches * int(k == "bev_scatter_max") for k in bs.launches}

    # the counted forward, deterministic, the scatter's inputs kept
    seen = []
    if hasattr(model.vfe, "scatter_max"):
        scatter = model.vfe.scatter_max
        model.vfe.scatter_max = lambda *args: seen.append(args) or scatter(*args)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.inference_mode():
        bs.reset_launches()
        out = model(batch)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
    torch.use_deterministic_algorithms(False)
    if seen:
        model.vfe.scatter_max = scatter
    fbd = out["final_box_dicts"]
    detail = ""
    if "voxel_ids" in out:
        dims = out["sparse_dims"]
        voxels = (out["voxel_ids"] < dims[0] * dims[1] * dims[2]).sum(1).tolist()
        sites = {lv: (ids < d[0] * d[1] * d[2]).sum(1).tolist()
                 for lv, (ids, _, d, _) in out["multi_scale_3d_features"].items()}
        detail = (f"; voxels kept per cloud {voxels} of a budget {out['voxel_ids'].shape[1]}, "
                  f"active sites per level {sites}, BEV {tuple(out['spatial_features'].shape)}")
    log("a11", f"{name}: one b{b} x {n} forward, full width, {info.num_point_features}-feature "
               f"points: kernel launches {counts}; valid boxes per cloud "
               f"{fbd['pred_valid'].sum(1).tolist()}" + detail)
    if counts != want:
        raise AssertionError(f"a11 {name}: expected launches {want}, got {counts}")
    if not torch.isfinite(fbd["pred_boxes"]).all() or not fbd["pred_valid"].any(1).all():
        raise AssertionError(f"a11 {name}: boxes not finite or a cloud without a box")
    record = {"config": str(Path(cfg_path).relative_to(REPO)), "batch": b, "points": n,
              "forward_launches": counts}
    if seen:
        (feats, pids, h, w), = seen
        record["bev_scatter_max"] = b1_on_inputs("a11", f"{name}: the forward's", feats, pids, h, w)
        del seen, feats, pids
    pp = cfg.MODEL.DENSE_HEAD.get("POST_PROCESSING") or cfg.MODEL.POST_PROCESSING
    if "forward" in against_cpu:
        record["card_vs_cpu"] = (
            _sender_card_vs_cpu(name, cfg_path, sd, model, host, pp,
                                int(pp.NMS_CONFIG.NMS_POST_MAXSIZE), phase="a11") if sender
            else _a11_card_vs_cpu(name, cfg_path, sd, model, host, cfg))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        record["forward_ms"] = cuda_ms(lambda: model(batch), warmup=2, iters=5)
        record["forward_peak_bytes"] = torch.cuda.max_memory_allocated()
        record["forward_stages_ms"] = stage_ms(a11_stages(model), batch, iters=3)
    log("a11", f"{name}: forward b{b} x {n}, seeded weights, TF32 off: median "
               f"{record['forward_ms']:.6f} ms over 5 after 2 warm-ups, "
               f"{b / record['forward_ms'] * 1e3:.3f} clouds/s; peak memory allocated "
               f"{record['forward_peak_bytes']} bytes; stages: "
               + ", ".join(f"{k} {v:.6f}" for k, v in record["forward_stages_ms"].items())
               + " (stages: median ms of 3)")

    # training: the loss curve on one batch, every launch counted
    if sender:
        host_train = sender_train_batch(np.random.default_rng(seed + 21), b, n, info)
    else:
        host_train = train_batch(np.random.default_rng(seed + 21), b, n, info)
    train = _on(host_train, "cuda")
    # the one-cycle schedule of phase 5's 50-step overfit: its first steps
    # run at the warm-up's low rates (over 4 steps the anchor car's loss rose
    # at the peak rate)
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    state = create_train_state(model, optimizer, seed)
    step = make_train_step(model, optimizer)
    bs.reset_launches()
    curve = [step(train) for _ in range(A11_TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_counts = dict(bs.launches)
    losses = [loss.item() for loss, _ in curve]
    tbs = [{k: v.item() for k, v in tb.items()} for _, tb in curve]
    log("a11", f"{name}: loss curve " + " ".join(f"{v:.6f}" for v in losses) + f"; tb first -> "
               "last: " + ", ".join(f"{k} {tbs[0][k]:.6f} -> {tbs[-1][k]:.6f}" for k in tbs[0])
               + f"; launches {train_counts} in {A11_TRAIN_STEPS} steps, step count {state.step}")
    bad = sorted({k for tb in tbs for k, v in tb.items() if not np.isfinite(v)})
    if bad or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"a11 {name}: losses {losses}, tb not finite {bad}")
    if train_counts != {k: A11_TRAIN_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"a11 {name}: expected {want} launches a step, got {train_counts}")
    step_ms, split, peak = time_train_steps(model, optimizer, train, iters=3, warmup=1)
    stages = stage_ms(a11_train_stages(model), train, iters=3)
    record.update(losses=losses, train_launches_per_step={k: v // A11_TRAIN_STEPS
                                                          for k, v in train_counts.items()},
                  step_ms=step_ms, samples_per_s=b / step_ms * 1e3,
                  **{f"{k}_ms": v for k, v in split.items()}, peak_bytes=peak,
                  train_stages_ms=stages)
    log("a11", f"{name}: train step b{b} x {n}, TF32 off: median {step_ms:.6f} ms over 3 after 1 "
               f"warm-up (host clock, synchronized), {b / step_ms * 1e3:.3f} samples/s; split "
               "(median ms, CUDA events): " + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
               + f"; peak memory allocated {peak} bytes ({peak / 2**30:.3f} GiB); training forward "
               "stages (median ms of 3): " + ", ".join(f"{k} {v:.6f}" for k, v in stages.items()))

    if "step" in against_cpu:  # one b1 step from the seeded weights, card against CPU
        one = {k: v[:1] for k, v in host_train.items()}
        gpu, cpu, cpu_half, cpu_s = card_and_cpu_steps(model, cfg_path, cfg, sd, one)
        limits, loose = hold_to_cpu_spread("a11", f"{name}: ", gpu, cpu, cpu_half,
                                           biases_before_bn(model), cpu_s, grad_rtol=A11_GRAD_RTOL)
        record["train_card_vs_cpu"] = {"limits": limits, "loosely_held": loose, "cpu_s": cpu_s}
    launches = (counts, record["train_launches_per_step"])
    del model, optimizer, state, batch, train, out
    torch.cuda.empty_cache()
    return record, launches


# the CLI stages of phase a11 on the SMOKE world, in the main process
A11_EXCHANGE = "exchange_database_second"


def _a11_stages(root):
    """(name, kind, CLI main, argv) of phase a11's CLI stages: the anchor car,
    the SECOND car and the SECOND RSU trained A11_CLI_EPOCHS epochs, both
    SECOND senders broadcast into ``exchange_database_second`` (their
    default database, under a data root in ``root``), the SECOND ego trained
    on it and evaluated."""
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli
    from pcp_tpu_torch.workspace import v2x_gen_exchange_database as genx

    data = ["USE_SYNTHETIC_DATA", "True", "MAX_POINTS_PER_SAMPLE", str(PIPELINE_NPTS),
            "SYNTHETIC", PIPELINE_SYN, "MINI_TRAINVAL_STRIDE", "1", "DATA_PATH", str(root / "data")]
    common = [f"DATA_CONFIG.{v}" if i % 2 == 0 else v for i, v in enumerate(data)]
    base = ["--batch_size", "4", "--device", "cuda", "--output_root", str(root), "--workers", "0"]

    def ckpt(cfg):
        return str(root / "cfgs" / "v2x_sim_models" / cfg / "smoke" / "ckpt"
                   / f"checkpoint_epoch_{A11_CLI_EPOCHS}.pth")

    def train(name, cfg, ratio):
        return (name, "train", train_cli.main,
                ["--cfg_file", PIPELINE_CFGS.format(cfg), *base, "--extra_tag", "smoke",
                 "--epochs", str(A11_CLI_EPOCHS), "--num_epochs_to_eval", "0", "--set", *common,
                 "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", str(ratio), "OPTIMIZATION.LR", "0.003"])

    def gen(agent):
        return (f"gen_exchange_{agent}", "gen", genx.main,
                ["--agent", agent, "--ckpt", ckpt(f"v2x_{agent}"), "--synthetic", "--device",
                 "cuda", "--workers", "0", "--set", *data])

    ego = "v2x_second_ego"
    return [train("train_anchor_car", "v2x_pointpillar_anchor_car", 4),
            train("train_second_car", "v2x_second_car", 4),
            train("train_second_rsu", "v2x_second_rsu", 1),
            gen("second_car"), gen("second_rsu"),
            train("train_second_ego", ego, 1),
            ("eval_second_ego", "eval", test_cli.main,
             ["--cfg_file", PIPELINE_CFGS.format(ego), *base, "--extra_tag", "smoke", "--ckpt",
              ckpt(ego), "--eval_tag", "smoke", "--set", *common,
              "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1"])]


def a11_cli(root):
    """Phase a11's CLI stages on the card: each stage's seconds and launches
    (B1 only for the anchor car, nothing for SECOND), the losses finite, the
    exchange written into ``exchange_database_second`` and read back as the
    SECOND ego's MoDAR rows, the evaluation's metrics finite. Returns the
    record."""
    import shutil

    from pcp_tpu_torch.ops import bev_scatter as bs

    shutil.rmtree(root, ignore_errors=True)
    record = {}
    for name, kind, main_fn, argv in _a11_stages(root):
        bs.reset_launches()
        t0 = time.perf_counter()
        out = main_fn(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(bs.launches)
        rec = {"seconds": seconds, "launches": launches}
        b1 = launches["bev_scatter_max"] if "anchor" in name else 0
        if launches != {k: b1 * int(k == "bev_scatter_max") for k in launches} or (
                "anchor" in name and not b1):
            raise AssertionError(f"a11 {name}: kernel launches {launches}")
        if kind == "train":
            rec.update(steps=out["steps"], step_ms=out["step_ms_median"], losses=out["losses"])
            if not out["steps"] or not np.isfinite(out["losses"]).all():
                raise AssertionError(f"a11 {name}: losses {out['losses']}")
            detail = (f"{out['steps']} steps, median step {out['step_ms_median']:.6f} ms, losses "
                      + " ".join(f"{v:.6f}" for v in out["losses"]))
        elif kind == "gen":
            files = len(list(root.glob(f"data/*/{A11_EXCHANGE}/*.npz")))
            rec.update(clouds=out, files=files)
            if not all(out.values()) or not files:
                raise AssertionError(f"a11 {name}: wrote {out} clouds, {files} files")
            detail = f"clouds broadcast {out}; {files} files in {A11_EXCHANGE}"
        else:
            keys = ("mAP", "NDS", "recall/rcnn_0.3", "recall/rcnn_0.5", "recall/rcnn_0.7")
            rec.update({k: float(out[k]) for k in keys})
            if not all(np.isfinite(rec[k]) for k in keys):
                raise AssertionError(f"a11 {name}: results not finite {rec}")
            cfg, items = eval_items(argv)
            if cfg.DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY != A11_EXCHANGE:
                raise AssertionError(f"a11 {name}: reads {cfg.DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY}")
            rows = sum(v[1] for item in items for v in item["metadata"]["exchange"].values())
            if not rows:
                raise AssertionError(f"a11 {name}: no MoDAR row read from {A11_EXCHANGE}")
            rec["modar_rows"] = rows
            detail = ", ".join(f"{k} {rec[k]:.6f}" for k in keys) + (
                f"; {rows} MoDAR rows read from {A11_EXCHANGE} over {len(items)} items")
        record[name] = rec
        log("a11", f"{name}: {seconds:.3f} s; {detail}; kernel launches {launches}")
    return record


def phase_a11(seed):
    """Phase a11: the anchor car and SECOND's car, RSU and ego at full width
    on the card, then their CLI stages. Returns (launches of each kernel in
    each model's forward and train step, the record)."""
    record, forward, step = {}, {}, {}
    for name, cfg_path, n, b1, against_cpu in A11_MODELS:
        record[name], (forward[name], step[name]) = run_a11_model(name, cfg_path, n, b1,
                                                                  against_cpu, seed)
    record["cli"] = a11_cli(REPO / "build" / "a11")
    return forward, step, record



# ------------------------------------------------------------ jr. the nuScenes JR family

JR_CFGS = REPO / "tools" / "cfgs" / "nuscenes_models"
JR_MODELS = ("pointpillar_jr_nomap", "pointpillar_jr_withmap", "pointpillar_jr_corr_withmap",
             "oracle_pointpillar_jr_withmap")
JR_TEACHER = "pointpillar_jr_corr_withmap_teacher"
JR_N = 262144  # points a cloud: a 10-sweep nuScenes cloud
JR_TRAIN_STEPS = 2  # steps on one batch, each loss finite
JR_HM_BIAS = -1.0  # the seeded heads' hm output bias: every head scores boxes above SCORE_THRESH
# card against CPU at b1. Every feature of these points spans [-48, 48], so
# the VFE's sums reach about 1e2; its BEV (atol, rtol) and every head branch
# (atol, rtol) keep a11's BEV tolerance: the VFE's BEV differed by up to
# 3.8e-5 and the branches by up to 2.2e-5 (readings on an H100 80GB HBM3 at
# 700 W). After the SCConv stack (21 float32 convs, TF32 off) the head's
# input differed by up to 1.01e-4 on values up to 34.7, 2.7e-6 to 3.6e-6 of
# its largest |value| in the four models, where the CPU at 8 and 4 threads
# differs by under 3.3e-6 absolute: the card's convolution algorithms round
# apart from the CPU's. So the head's input is held within JR_HEAD_INPUT_REL
# of its largest |value| (about 8x above the largest of those ratios).
JR_BEV_TOL = (1e-4, 1e-4)
JR_HEAD_TOL = (1e-4, 1e-4)
JR_HEAD_INPUT_REL = 3e-5
# the fake nuScenes database of the CLI stages: 2 scenes (train, val) of 3
# keyframes, each after 9 non-key sweeps, 26000 points a sweep
JR_DB = {"num_scenes": 2, "keyframes": 3, "sweeps": 10, "points": 26000, "objects": 30}


def jr_points(rng, b, n, num_features):
    """Points as ``tests/test_nuscenes_stack.py`` makes them, scaled to the
    configs' range: every feature uniform in [-48, 48] (12 of 12.8 there),
    intensity in [0, 1]."""
    pts = rng.uniform(-48.0, 48.0, (b, n, num_features)).astype(np.float32)
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    return pts


# (w, l, h) a class of CLASS_NAMES, for the training batch's gt boxes
JR_SIZES = ((1.9, 4.5, 1.6), (2.5, 7.0, 3.0), (2.8, 6.5, 3.2), (2.9, 11.0, 3.5), (2.6, 9.0, 3.8),
            (2.5, 0.5, 1.0), (0.8, 2.1, 1.5), (0.6, 1.7, 1.3), (0.7, 0.7, 1.8), (0.4, 0.4, 1.0))


def jr_train_batch(rng, b, n, num_features, boxes_per_cloud=40):
    """``jr_points`` and gt boxes [x y z dx dy dz yaw vx vy cls] of the ten
    classes, padded to 500 rows, as ``tests/test_nuscenes_stack.py`` lays
    them out (velocity columns before the class)."""
    pts = jr_points(rng, b, n, num_features)
    gt = np.zeros((b, 500, 10), np.float32)
    k = boxes_per_cloud
    cls = rng.integers(0, 10, (b, k))
    gt[:, :k, 0:2] = rng.uniform(-48, 48, (b, k, 2))
    gt[:, :k, 2] = rng.uniform(-2, 0, (b, k))
    gt[:, :k, 3:6] = np.array(JR_SIZES)[cls][..., [1, 0, 2]]
    gt[:, :k, 6] = rng.uniform(-np.pi, np.pi, (b, k))
    gt[:, :k, 7:9] = rng.normal(0, 2, (b, k, 2))
    gt[:, :k, 9] = cls + 1
    return {"points": torch.from_numpy(pts), "points_mask": torch.ones((b, n), dtype=torch.bool),
            "gt_boxes": torch.from_numpy(gt)}


def jr_seeded(model, seed):
    """``seeded_state_dict`` with every head's hm output bias at JR_HM_BIAS."""
    sd = seeded_state_dict(model, seed)
    for h, head in enumerate(model.dense_head.heads_list):
        key = f"dense_head.heads_list.{h}.hm.{len(head.hm) - 1}.bias"
        sd[key] = torch.full_like(sd[key], JR_HM_BIAS)
    model.load_state_dict(sd, strict=True)
    return sd


def hold_heads(name, gpu, cpu, pp, phase="jr"):
    """Every head's surviving boxes of one cloud under the margin rule, the
    heatmap of each head its decode scores. Returns the boxes matched."""
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    post = int(pp.NMS_CONFIG.NMS_POST_MAXSIZE)
    matched = 0
    for h, pred in enumerate(cpu["head_preds"]):
        heat = torch.sigmoid(pred["hm"][0].double()).numpy().reshape(-1)
        sl = slice(h * post, (h + 1) * post)
        matched += match_surviving_boxes(
            {k: v[0, sl].cpu().numpy() for k, v in gpu["final_box_dicts"].items()},
            {k: v[0, sl].numpy() for k, v in cpu["final_box_dicts"].items()}, heat,
            top_k=int(pp.MAX_OBJ_PER_SAMPLE), score_thresh=float(pp.SCORE_THRESH), post_max=post,
            min_matched=1)
    return matched


def _jr_card_vs_cpu(name, cfg_path, sd, model, host, pp):
    """b1 eval on the card (deterministic) against the CPU: the VFE's BEV
    (JR_BEV_TOL), the head's input BEV (JR_HEAD_INPUT_REL of its largest
    |value|) and every branch of every head (JR_HEAD_TOL), the surviving
    boxes of every head under the margin rule.
    With a corrector, its decisions as phase 6 holds them: points whose
    decision falls apart within DECISION_BAND of its boundary are dropped
    from the cloud and both forwards run again."""
    from pcp_tpu_torch.entry import build

    _, _, cpu_model = build(cfg_path, device="cpu")
    cpu_model.load_state_dict(sd, strict=True)
    one = {k: v[:1].clone() for k, v in host.items()}
    dropped = 0
    for _ in range(3):
        torch.use_deterministic_algorithms(True, warn_only=True)
        with torch.inference_mode():
            gpu_one = _on(one, "cuda")
            gpu = model(gpu_one)
            torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        t0 = time.perf_counter()
        with torch.inference_mode():
            cpu = cpu_model(one)
        cpu_s = time.perf_counter() - t0
        if not hasattr(model, "corrector"):
            break
        got, _ = corrector_decisions(model, gpu_one, gpu)
        want, margin = corrector_decisions(cpu_model, one, cpu)
        flips = (got != want).any(-1) & one["points_mask"]
        if not flips.any():
            break
        if not (margin[flips] < DECISION_BAND).any(-1).all():
            raise AssertionError(f"jr {name}: a corrector decision differs between card and CPU "
                                 f"away from its boundary: margins {margin[flips].tolist()}")
        dropped += int(flips.sum())
        one["points_mask"] = one["points_mask"] & ~flips
    else:
        raise AssertionError(f"jr {name}: corrector decisions still differ after three rounds")
    err = {}

    def hold(key, got, want, tol):
        err[key] = (got.cpu() - want).abs().max().item()
        torch.testing.assert_close(got.cpu(), want, atol=tol[0], rtol=tol[1],
                                   msg=lambda m: f"jr {name} b1 card vs CPU, {key}: {m}")

    scale = cpu["spatial_features_2d"].abs().max().item()
    hold("vfe_bev", gpu["spatial_features"], cpu["spatial_features"], JR_BEV_TOL)
    hold("head_input_bev", gpu["spatial_features_2d"], cpu["spatial_features_2d"],
         (JR_HEAD_INPUT_REL * scale, 0.0))
    for h, pred in enumerate(cpu["head_preds"]):
        for branch, t in pred.items():
            hold(f"head{h}.{branch}", gpu["head_preds"][h][branch], t, JR_HEAD_TOL)
    matched = hold_heads(name, gpu, cpu, pp)
    worst = max((k for k in err if k.startswith("head") and k != "head_input_bev"), key=err.get)
    log("jr", f"{name}: b1 card vs CPU ({cpu_s:.1f} s on the CPU): vfe_bev max_abs_err "
              f"{err['vfe_bev']} (atol {JR_BEV_TOL[0]}, rtol {JR_BEV_TOL[1]}), head_input_bev "
              f"{err['head_input_bev']} (atol {JR_HEAD_INPUT_REL} x its largest |value| "
              f"{scale}), the largest of the "
              f"{len(err) - 2} head branches {worst} {err[worst]} (atol {JR_HEAD_TOL[0]}, rtol "
              f"{JR_HEAD_TOL[1]})"
              + (f"; every corrector decision equal ({dropped} points within {DECISION_BAND} of "
                 "a boundary decided apart and dropped)" if hasattr(model, "corrector") else "")
              + f"; {matched} surviving boxes of the six heads matched under the margin rule")
    return {"max_abs_err": err, "head_input_scale": scale, "boxes_matched": matched,
            "points_dropped": dropped, "cpu_s": cpu_s}


def run_jr_model(name, seed, build_dir):
    """One JR model at full width on the card: the counted forward at b4 x
    JR_N, B1 on its inputs, b1 card against CPU, the forward's time, stages
    and peak memory, then JR_TRAIN_STEPS train steps (one B1 launch each),
    the step's time, split, stages and peak memory, the batch halved if a
    step does not fit. Saves the trained weights to ``build_dir/{name}.pth``.
    Returns (record, launches in one forward, in one train step)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg_path = JR_CFGS / f"{name}.yaml"
    cfg, info, model = build(cfg_path, device="cuda")
    b, nf = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), info.num_point_features
    rng = np.random.default_rng(seed + 30)
    host = {"points": torch.from_numpy(jr_points(rng, b, JR_N, nf)),
            "points_mask": torch.ones((b, JR_N), dtype=torch.bool)}
    batch = _on(host, "cuda")
    sd = jr_seeded(model, seed)
    if hasattr(model, "corrector"):
        balance_seg_bias(model, sd, batch)
    want = {k: int(k == "bev_scatter_max") for k in bs.launches}

    seen = []
    scatter = model.vfe.scatter_max
    model.vfe.scatter_max = lambda *args: seen.append(args) or scatter(*args)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.inference_mode():
        bs.reset_launches()
        out = model(batch)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
    torch.use_deterministic_algorithms(False)
    model.vfe.scatter_max = scatter
    fbd = out["final_box_dicts"]
    log("jr", f"{name}: one b{b} x {JR_N} forward, full width ({cfg.MODEL.BACKBONE_2D.NAME} "
              f"{tuple(out['spatial_features'].shape)} -> {tuple(out['spatial_features_2d'].shape)}), "
              f"{nf}-feature points of which the VFE reads "
              f"{cfg.MODEL.VFE.NUM_RAW_POINT_FEATURES}: kernel launches {counts}; boxes "
              f"{tuple(fbd['pred_boxes'].shape)}, valid per cloud {fbd['pred_valid'].sum(1).tolist()}")
    if counts != want:
        raise AssertionError(f"jr {name}: expected launches {want}, got {counts}")
    if not torch.isfinite(fbd["pred_boxes"]).all() or not fbd["pred_valid"].any(1).all() \
            or fbd["pred_boxes"].shape[-1] != 9:
        raise AssertionError(f"jr {name}: boxes not finite, not 9 wide or a cloud without one")
    record = {"config": str(cfg_path.relative_to(REPO)), "batch": b, "points": JR_N,
              "point_features": nf, "forward_launches": counts}
    (feats, pids, h, w), = seen
    record["bev_scatter_max"] = b1_on_inputs("jr", f"{name}: the forward's", feats, pids, h, w)
    del seen, feats, pids, out
    pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    record["card_vs_cpu"] = _jr_card_vs_cpu(name, cfg_path, sd, model, host, pp)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        record["forward_ms"] = cuda_ms(lambda: model(batch), warmup=2, iters=5)
        record["forward_peak_bytes"] = torch.cuda.max_memory_allocated()
        record["forward_stages_ms"] = stage_ms(a11_stages(model), batch, iters=3)
    log("jr", f"{name}: forward b{b} x {JR_N}, seeded weights, TF32 off: median "
              f"{record['forward_ms']:.6f} ms over 5 after 2 warm-ups, "
              f"{b / record['forward_ms'] * 1e3:.3f} clouds/s; peak memory allocated "
              f"{record['forward_peak_bytes']} bytes; stages: "
              + ", ".join(f"{k} {v:.6f}" for k, v in record["forward_stages_ms"].items())
              + " (stages: median ms of 3)")
    del batch

    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=TRAIN_STEPS,
                                   total_epochs=1)
    state = create_train_state(model, optimizer, seed)
    step = make_train_step(model, optimizer)
    tb_ = b
    while True:
        train = _on(jr_train_batch(np.random.default_rng(seed + 31), tb_, JR_N, nf), "cuda")
        try:
            bs.reset_launches()
            curve = [step(train) for _ in range(JR_TRAIN_STEPS)]
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if tb_ == 1:
                raise
            del train
            torch.cuda.empty_cache()
            log("jr", f"{name}: a b{tb_} train step does not fit in the card's memory; halving")
            tb_ //= 2
    train_counts = dict(bs.launches)
    losses = [loss.item() for loss, _ in curve]
    tbs = [{k: v.item() for k, v in t.items()} for _, t in curve]
    log("jr", f"{name}: b{tb_} x {JR_N} train steps from create_train_state: losses "
              + " ".join(f"{v:.6f}" for v in losses) + "; tb first -> last: "
              + ", ".join(f"{k} {tbs[0][k]:.6f} -> {tbs[-1][k]:.6f}" for k in tbs[0])
              + f"; launches {train_counts} in {JR_TRAIN_STEPS} steps, step count {state.step}")
    bad = sorted({k for t in tbs for k, v in t.items() if not np.isfinite(v)})
    if bad or not np.isfinite(losses).all():
        raise AssertionError(f"jr {name}: losses {losses}, tb not finite {bad}")
    if train_counts != {k: JR_TRAIN_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"jr {name}: expected {want} launches a step, got {train_counts}")
    step_ms, split, peak = time_train_steps(model, optimizer, train, iters=3, warmup=1)
    stages = stage_ms(a11_train_stages(model), train, iters=3)
    per_step = {k: v // JR_TRAIN_STEPS for k, v in train_counts.items()}
    record.update(train_batch=tb_, losses=losses, train_launches_per_step=per_step, step_ms=step_ms,
                  samples_per_s=tb_ / step_ms * 1e3, **{f"{k}_ms": v for k, v in split.items()},
                  peak_bytes=peak, train_stages_ms=stages)
    log("jr", f"{name}: train step b{tb_} x {JR_N}, TF32 off: median {step_ms:.6f} ms over 3 "
              f"after 1 warm-up (host clock, synchronized), {tb_ / step_ms * 1e3:.3f} samples/s; "
              "split (median ms, CUDA events): " + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
              + f"; peak memory allocated {peak} bytes ({peak / 2**30:.3f} GiB); training forward "
              "stages (median ms of 3): " + ", ".join(f"{k} {v:.6f}" for k, v in stages.items()))
    build_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state": model.state_dict(), "epoch": 1, "it": JR_TRAIN_STEPS},
               build_dir / f"{name}.pth")
    del model, optimizer, state, train, curve
    torch.cuda.empty_cache()
    return record, counts, per_step


def jr_teacher(seed, build_dir):
    """The teacher config: its teacher takes the oracle model's VFE, scatter
    and backbone from the oracle's checkpoint (``overlay_bev_maker_weights``,
    bitwise), an eval forward at b4 x JR_N launches B1 once (the teacher
    runs only in training), and a train step refuses with HunterJr's shape
    error, after its forward's two B1 launches (the teacher's VFE and the
    model's), where the JAX package's step fails (the corrector's BEV is 64
    channels wide, the teacher's 384)."""
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.checkpoint import load_params_from_file, overlay_bev_maker_weights
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, take_train_step

    cfg, info, model = build(JR_CFGS / f"{JR_TEACHER}.yaml", device="cuda")
    b, nf = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), info.num_point_features
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=1, total_epochs=1)
    create_train_state(model, optimizer, seed)
    ckpt = build_dir / "oracle_pointpillar_jr_withmap.pth"
    overlay_bev_maker_weights(model, "teacher", ckpt)
    oracle = load_params_from_file(ckpt)
    teacher = model.teacher.state_dict()
    for key, v in teacher.items():
        if not torch.equal(v.cpu(), oracle[key].cpu()):
            raise AssertionError(f"jr teacher: teacher.{key} is not the oracle's")
    train = _on(jr_train_batch(np.random.default_rng(seed + 32), b, JR_N, nf), "cuda")
    model.eval()
    with torch.inference_mode():
        bs.reset_launches()
        out = model({k: v for k, v in train.items() if k != "gt_boxes"})
        torch.cuda.synchronize()
        eval_counts = dict(bs.launches)
    if eval_counts != {k: int(k == "bev_scatter_max") for k in bs.launches} \
            or not torch.isfinite(out["final_box_dicts"]["pred_boxes"]).all():
        raise AssertionError(f"jr teacher: eval launches {eval_counts}")
    bs.reset_launches()
    try:
        take_train_step(model, optimizer, train)
    except ValueError as e:
        refused = str(e)
        if not refused.startswith("the corrector's BEV (") or "differ in shape" not in refused:
            raise
    else:
        raise AssertionError("jr teacher: the train step ran; the JAX package's fails there")
    step_counts = dict(bs.launches)
    if step_counts != {k: 2 * v for k, v in eval_counts.items()}:
        raise AssertionError(f"jr teacher: launches before the refusal {step_counts}")
    log("jr", f"{JR_TEACHER}: teacher overlaid from {ckpt.relative_to(REPO)} ({len(teacher)} "
              f"tensors, bitwise); eval forward b{b} x {JR_N} launches {eval_counts}; the train "
              f"step refuses with HunterJr's shape error where the JAX package's fails, after "
              f"launches {step_counts}: {refused}")
    del model, optimizer, train, out
    torch.cuda.empty_cache()
    return {"teacher_tensors": len(teacher), "eval_launches": eval_counts,
            "train_refused": refused, "train_launches_before_refusal": step_counts}


def jr_cli(root, build_dir):
    """The nuScenes data path through the port's CLIs in ``root``: the fake
    database (``tests/torch_fake_devkit.py``, JR_DB), ``create_nuscenes_infos``
    with no devkit, a map raster an info (the port's
    ``make_map_representation``); then each JR model evaluated from this
    phase's trained weights (one B1 launch a batch, metrics finite). No CLI
    stage trains: the dataset's gt has no velocity columns, and the JAX
    package's training step fails on it. Returns the record."""
    import pickle
    import shutil

    sys.path.insert(0, str(REPO / "tests"))
    from torch_fake_devkit import make_nusc_db, write_maps

    from pcp_tpu_torch.datasets.nuscenes.info_builder import create_nuscenes_infos
    from pcp_tpu_torch.datasets.nuscenes.map_utils import make_map_representation
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.tools import test as test_cli

    shutil.rmtree(root, ignore_errors=True)
    for mod in ("cv2", "matplotlib", "nuscenes"):
        if mod in sys.modules:
            raise AssertionError(f"jr: {mod} was imported")
    record = {}
    t0 = time.perf_counter()
    fake, version = make_nusc_db(root, **JR_DB)
    data = root / version
    record["db_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    infos = create_nuscenes_infos(version, data, data, max_sweeps=JR_DB["sweeps"], nusc=fake)
    record["infos_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for split, split_infos in zip(("train", "val"), infos):
        write_maps(data, split_infos, make_map_representation,
                   (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0))
        with open(data / f"nuscenes_infos_{JR_DB['sweeps']}sweeps_{split}.pkl", "wb") as f:
            pickle.dump(split_infos, f)
    record["maps_seconds"] = time.perf_counter() - t0
    sweeps = [len(i["sweeps"]) for s in infos for i in s]
    log("jr", f"fake nuScenes database {JR_DB} in {record['db_seconds']:.3f} s; "
              f"create_nuscenes_infos {record['infos_seconds']:.3f} s: {len(infos[0])} train and "
              f"{len(infos[1])} val infos, past sweeps {sweeps}, gt boxes "
              f"{[len(i['gt_boxes']) for s in infos for i in s]}; maps {record['maps_seconds']:.3f} s")
    data_sets = ["DATA_CONFIG.DATA_PATH", str(root), "DATA_CONFIG.VERSION", version,
                 "DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST", "['gt_sampling']",
                 "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", str(JR_N)]
    base = ["--device", "cuda", "--workers", "0", "--output_root", str(root / "output"),
            "--extra_tag", "smoke"]

    for name in JR_MODELS:
        bs.reset_launches()
        t0 = time.perf_counter()
        out = test_cli.main(["--cfg_file", str(JR_CFGS / f"{name}.yaml"), *base, "--batch_size",
                             "4", "--ckpt", str(build_dir / f"{name}.pth"), "--eval_tag", "smoke",
                             "--set", *data_sets])
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0, "launches": dict(bs.launches),
               **{k: float(out[k]) for k in ("mAP", "NDS")}}
        if rec["launches"] != {k: int(k == "bev_scatter_max") for k in bs.launches} or \
                not all(np.isfinite(rec[k]) for k in ("mAP", "NDS")):
            raise AssertionError(f"jr eval_{name}: {rec}")
        record[f"eval_{name}"] = rec
        log("jr", f"eval_{name}: {rec['seconds']:.3f} s, {len(infos[1])} val clouds of 10 "
                  f"sweeps, mAP {rec['mAP']:.6f} NDS {rec['NDS']:.6f} (this phase's two-step "
                  f"weights); kernel launches {rec['launches']}")
    for mod in ("cv2", "matplotlib", "nuscenes"):
        if mod in sys.modules:
            raise AssertionError(f"jr: {mod} was imported")
    return record


def a11_2_check(seed, root):
    """The real V2X-Sim info building where the card runs: the fake V2X-Sim
    database of ``tests/torch_fake_devkit.py`` through ``NuScenesV2XSource``
    with the database handed in, the split, RSU and car info pickles, the
    car's dataset read back from them and one car forward on the card at
    full width (one B1 launch). Returns the record."""
    import shutil

    sys.path.insert(0, str(REPO / "tests"))
    from torch_fake_devkit import make_v2x_db

    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.datasets.v2x_sim.source import NuScenesV2XSource
    from pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_car import V2XSimDataset_CAR
    from pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_rsu import V2XSimDataset_RSU
    from pcp_tpu_torch.entry import CFG_CAR, build
    from pcp_tpu_torch.ops import bev_scatter as bs

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    fake, version = make_v2x_db(root)
    src = NuScenesV2XSource(root / version, version, nusc=fake)
    cfg, _, model = build(CFG_CAR, device="cuda")
    dcfg = cfg.DATA_CONFIG
    dcfg.update({"DATA_PATH": str(root), "VERSION": version, "USE_SYNTHETIC_DATA": False,
                 "MINI_TRAINVAL_STRIDE": 1, "THRESHOLD_BOXES_BY_POINTS": 1})
    rsu_train, rsu_val = V2XSimDataset_RSU(dcfg, cfg.CLASS_NAMES, training=True,
                                           source=src).build_v2x_sim_info()
    car_train, car_val = V2XSimDataset_CAR(dcfg, cfg.CLASS_NAMES, training=True,
                                           source=src).build_v2x_sim_info()
    build_s = time.perf_counter() - t0
    ds, loader, _ = build_dataloader(dcfg, cfg.CLASS_NAMES, batch_size=2, training=False,
                                     workers=0, source=src)
    batch = next(iter(loader))
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    dev = {k: torch.as_tensor(batch[k]).cuda() for k in ("points", "points_mask")}
    with torch.inference_mode():
        bs.reset_launches()
        out = model(dev)
        torch.cuda.synchronize()
    counts = dict(bs.launches)
    fbd = out["final_box_dicts"]
    rec = {"build_seconds": build_s, "rsu_infos": [len(rsu_train), len(rsu_val)],
           "car_infos": {s: {k: len(v) for k, v in d.items()} for s, d in
                         (("train", car_train), ("val", car_val))},
           "car_items": len(ds), "points": list(batch["points"].shape), "launches": counts}
    log("a11_2", f"fake V2X-Sim database through NuScenesV2XSource: split, RSU infos "
                 f"{rec['rsu_infos']} (train, val), car infos {rec['car_infos']} in {build_s:.3f} s; "
                 f"the car's dataset read back from the pickles: {len(ds)} items, semantic "
                 f"channels left out; one b2 car forward on the card, points "
                 f"{rec['points']}: launches {counts}, valid boxes {fbd['pred_valid'].sum(1).tolist()}")
    if counts != {k: int(k == "bev_scatter_max") for k in bs.launches} or len(ds) != 6 \
            or rec["rsu_infos"] != [3, 3] or not torch.isfinite(fbd["pred_boxes"]).all():
        raise AssertionError(f"a11_2: {rec}")
    del model, out
    torch.cuda.empty_cache()
    return rec


def phase_jr(seed):
    """Phase jr: the four JR models at full width on the card, the teacher
    config, the CLI stages on a fake nuScenes database, and the a11_2 check.
    Returns (launches of each kernel in each model's forward and train step,
    the record)."""
    build_dir = REPO / "build" / "jr"
    record, forward, step = {}, {}, {}
    for name in JR_MODELS:
        record[name], forward[name], step[name] = run_jr_model(name, seed, build_dir)
    record["teacher"] = jr_teacher(seed, build_dir)
    record["cli"] = jr_cli(build_dir / "nuscenes", build_dir)
    record["a11_2"] = a11_2_check(seed, build_dir / "v2x_sim")
    return forward, step, record


# ------------------------------------------------------------ kitti. KITTI data and PointRCNN

CFG_KITTI_DATA = "tools/cfgs/dataset_configs/kitti_dataset.yaml"
# the fake KITTI tree of tests/torch_fake_kitti.py: four training frames
# (two train steps at the config's b2 through the CLI) and two validation
# frames, each of about 24000 returns of which some 17000 fall in the
# camera's field of view (sample_points keeps 16384)
KITTI_TRAIN_IDS = ("000000", "000001", "000002", "000003")
KITTI_VAL_IDS = ("000004", "000005")
KITTI_POINTS = 24000
KITTI_TRAIN_STEPS = 2  # steps on one batch, each loss finite
# the last step's ROIs are handed in: this many jittered copies of each gt
# box (centre 0.2 m, sizes 5%, heading 0.1 rad), so that foreground ROIs
# train the ROI head's reg and corner losses, which the seeded first stage's
# proposals never reach
KITTI_ROI_COPIES = 8
# card against CPU, b1 eval, (atol, rtol) of each tensor, held to at least
# SPREAD_FACTOR x the CPU's own spread between 8 and 4 threads; the ROI
# stage runs on the card's proposals on both sides
KITTI_TOL = {"point_features": (1e-4, 1e-4), "point_cls_preds": (1e-4, 1e-4),
             "batch_cls_preds": (1e-4, 1e-4), "batch_box_preds": (1e-4, 1e-4)}


class record_indices:
    """Within the block, every FPS and ball-query result of the port's
    PointNet++ ops and every NMS's kept indices, on the CPU, in call order."""

    def __enter__(self):
        from pcp_tpu_torch.models.detectors import pointpillar
        from pcp_tpu_torch.models.roi_heads import roi_head_template
        from pcp_tpu_torch.ops import pointnet2 as pn2

        self.seen = {"fps": [], "ball_query": [], "nms": []}
        self.saved = [(pn2, "farthest_point_sample"), (pn2, "ball_query"),
                      (roi_head_template, "class_agnostic_nms"), (pointpillar, "class_agnostic_nms")]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.saved]
        for mod, name, fn in self.saved:
            key = {"farthest_point_sample": "fps", "ball_query": "ball_query"}.get(name, "nms")

            def wrapped(*args, _fn=fn, _key=key, **kwargs):
                out = _fn(*args, **kwargs)
                self.seen[_key].append(out[0].cpu() if isinstance(out, tuple) else out.cpu())
                return out

            setattr(mod, name, wrapped)
        return self.seen

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def kitti_stages(model, cfg):
    from pcp_tpu_torch.models.detectors.pointpillar import generic_post_processing
    from pcp_tpu_torch.models.roi_heads.roi_head_template import proposal_layer

    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    return [("backbone_3d", model.backbone_3d), ("point_head", model.point_head),
            ("proposal_layer", lambda d: proposal_layer(d, nms_cfg)),
            ("roi_head", model.roi_head),
            ("post_processing", lambda d: dict(d, final_box_dicts=generic_post_processing(
                cfg.MODEL, d)))]


def _kitti_cpu(sd, cfg_path, host, threads):
    """A CPU copy of the model on ``host`` (the card's proposals handed in)
    at ``threads`` threads: its outputs and the indices it drew."""
    from pcp_tpu_torch.entry import build

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        _, _, cpu = build(cfg_path, device="cpu")
        cpu.load_state_dict(sd, strict=True)
        with torch.inference_mode(), record_indices() as seen:
            out = cpu(host)
    finally:
        torch.set_num_threads(before)
    return out, seen


def _kitti_card_vs_cpu(model, sd, cfg_path, batch, cfg):
    """b1 card against CPU: FPS and ball-query indices equal, the point
    features and scores within KITTI_TOL (or SPREAD_FACTOR x the CPU's
    spread), the ROI stage on the card's proposals within KITTI_TOL, the
    surviving boxes under the margin rule; the proposal and the final NMS
    exact on the card's own inputs."""
    from pcp_tpu_torch.ops.nms import class_agnostic_nms
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    b1 = {k: v[:1] for k, v in batch.items()}
    with torch.inference_mode(), record_indices() as gpu_seen:
        gpu = model(b1)
    pins = ("rois", "roi_scores", "roi_labels", "roi_valid")
    host = {k: v.cpu() for k, v in b1.items()}
    host.update({k: gpu[k].cpu() for k in pins}, has_class_labels=True)
    t0 = time.perf_counter()
    cpu, cpu_seen = _kitti_cpu(sd, cfg_path, host, 8)
    cpu_s = time.perf_counter() - t0
    cpu4, _ = _kitti_cpu(sd, cfg_path, host, 4)
    for kind in ("fps", "ball_query"):
        if len(gpu_seen[kind]) != len(cpu_seen[kind]) or not all(
                torch.equal(g, c) for g, c in zip(gpu_seen[kind], cpu_seen[kind])):
            raise AssertionError(f"kitti: {kind} indices differ between the card and the CPU")
    rec = {"cpu_seconds": cpu_s, "fps_calls": len(gpu_seen["fps"]),
           "ball_query_calls": len(gpu_seen["ball_query"])}
    for key, (atol, rtol) in KITTI_TOL.items():
        g, c, c4 = gpu[key].cpu(), cpu[key], cpu4[key]
        spread = (c - c4).abs().max().item()
        err = (g - c).abs().max().item()
        limit = max(atol + rtol * c.abs().max().item(), SPREAD_FACTOR * spread)
        rec[key] = {"max_abs_err": err, "cpu_spread": spread, "limit": limit,
                    "max_abs": c.abs().max().item()}
        if not err <= limit:
            raise AssertionError(f"kitti: {key} card vs CPU {err} over {limit} ({rec[key]})")
    pp = cfg.MODEL.POST_PROCESSING
    got = {k: v[0].cpu().numpy() for k, v in gpu["final_box_dicts"].items()}
    want = {k: v[0].numpy() for k, v in cpu["final_box_dicts"].items()}
    rec["boxes_matched"] = match_surviving_boxes(
        got, want, heat_scores=np.zeros(0), top_k=1, score_thresh=float(pp.SCORE_THRESH),
        post_max=int(pp.NMS_CONFIG.NMS_POST_MAXSIZE), margin=1e-4, box_atol=1e-3,
        box_rtol=1e-4, score_atol=1e-4, min_matched=1)
    # the NMS's kept indices on one set of inputs, on the card and on the
    # CPU: the card's proposals (the point head's boxes) and its final boxes
    with torch.inference_mode():
        ph = model.point_head(model.backbone_3d(b1))
    nms_in = ((ph["batch_box_preds"], torch.sigmoid(ph["batch_cls_preds"]).max(-1).values,
               ph["batch_pred_valid"], cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST, None),
              (gpu["batch_box_preds"], torch.sigmoid(gpu["batch_cls_preds"]).max(-1).values,
               gpu["batch_pred_valid"], pp.NMS_CONFIG, float(pp.SCORE_THRESH)))
    kept = []
    for boxes, sc, valid, nms_cfg, thresh in nms_in:
        on_card = class_agnostic_nms(boxes, sc, valid, nms_cfg, score_thresh=thresh)[0].cpu()
        on_cpu = class_agnostic_nms(boxes.cpu(), sc.cpu(), valid.cpu(), nms_cfg,
                                    score_thresh=thresh)[0]
        if not torch.equal(on_card, on_cpu):
            raise AssertionError("kitti: NMS kept indices differ between the card and the CPU")
        kept.append(int((on_card >= 0).sum()))
    rec["nms_kept"] = kept
    return rec


def jittered_gt_rois(gt_boxes, seed):
    """ROIs about the batch's gt boxes (B, G, 8): KITTI_ROI_COPIES jittered
    copies of each, zero rows for padding, with scores and 1-based labels.
    ``proposal_layer`` passes ROIs handed in with the batch on."""
    g = torch.Generator().manual_seed(seed)
    gt = gt_boxes.cpu().repeat_interleave(KITTI_ROI_COPIES, 1)
    real = gt[..., 7] > 0
    noise = torch.randn(gt[..., :7].shape, generator=g)
    rois = torch.cat([gt[..., 0:3] + 0.2 * noise[..., 0:3],
                      gt[..., 3:6] * torch.exp(0.05 * noise[..., 3:6]),
                      gt[..., 6:7] + 0.1 * noise[..., 6:7]], -1)
    rois = torch.where(real[..., None], rois, 0.0)
    scores = torch.where(real, torch.rand(real.shape, generator=g), 0.0)
    labels = torch.where(real, gt[..., 7].long(), 0)
    dev = gt_boxes.device
    return {"rois": rois.to(dev), "roi_scores": scores.to(dev), "roi_labels": labels.to(dev)}


def kitti_cli(root, data, seed):
    """The CLI stages on the fake tree: the train CLI for one epoch with
    gt_sampling, then the test CLI's KITTI AP table. Returns the record."""
    from pcp_tpu_torch.entry import CFG_POINTRCNN
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli

    common = ["--cfg_file", CFG_POINTRCNN, "--batch_size", "2", "--device", "cuda", "--workers",
              "0", "--output_root", str(root), "--extra_tag", "smoke"]
    sets = ["--set", "DATA_CONFIG.DATA_PATH", str(data)]
    ckpt = root / "cfgs" / "kitti_models" / "pointrcnn" / "smoke" / "ckpt" / "checkpoint_epoch_1.pth"
    record = {}
    for name, main_fn, argv in (
            ("train_pointrcnn", train_cli.main,
             common + ["--epochs", "1", "--seed", str(seed), "--num_epochs_to_eval", "0",
                       "--precise_bn", "0"] + sets),
            ("eval_pointrcnn", test_cli.main, common + ["--ckpt", str(ckpt)] + sets)):
        bs.reset_launches()
        t0 = time.perf_counter()
        out = main_fn(argv)
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0, "launches": dict(bs.launches)}
        if any(rec["launches"].values()):
            raise AssertionError(f"kitti {name}: kernel launches {rec['launches']}")
        if name.startswith("train"):
            rec.update(steps=out["steps"], step_ms=out["step_ms_median"], losses=out["losses"])
            if out["steps"] != len(KITTI_TRAIN_IDS) // 2 or not np.isfinite(out["losses"]).all():
                raise AssertionError(f"kitti {name}: {out['steps']} steps, losses {out['losses']}")
            detail = (f"{out['steps']} steps with gt_sampling, median step "
                      f"{out['step_ms_median']:.6f} ms, losses "
                      + " ".join(f"{v:.6f}" for v in out["losses"]))
        else:
            keys = [k for k in out if k.endswith("_R40")] + ["recall/rcnn_0.7"]
            rec.update({k: float(out[k]) for k in keys})
            if len(keys) != 37 or not all(np.isfinite(rec[k]) for k in keys):
                raise AssertionError(f"kitti {name}: results {rec}")
            detail = ", ".join(f"{k} {rec[k]:.6f}" for k in keys if "moderate" in k)
        record[name] = rec
        log("kitti", f"{name}: {rec['seconds']:.3f} s; {detail}; kernel launches {rec['launches']}")
    return record


def phase_kitti(seed):
    """Phase kitti: KITTI infos and the gt database on a fake tree through
    the port's builder, PointRCNN at full width on the card (eval forward,
    stages, train steps, b1 against the CPU), and the CLI stages. Returns
    (launches of each kernel in a forward and in a train step, the record)."""
    import shutil

    sys.path.insert(0, str(REPO / "tests"))
    from torch_fake_kitti import make_kitti_tree

    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.datasets.kitti import kitti_dataset
    from pcp_tpu_torch.entry import CFG_POINTRCNN, build
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state
    from pcp_tpu_torch.train.train_utils import _to_device_batch

    root = REPO / "build" / "kitti"
    shutil.rmtree(root, ignore_errors=True)
    data = make_kitti_tree(root / "data", KITTI_TRAIN_IDS, KITTI_VAL_IDS, KITTI_POINTS, seed)
    t0 = time.perf_counter()
    kitti_dataset.main(["create_kitti_infos", CFG_KITTI_DATA, "--data_path", str(data)])
    record = {"create_kitti_infos_seconds": time.perf_counter() - t0,
              "gt_database_objects": len(list((data / "gt_database").glob("*.bin")))}
    cfg, info, model = build(CFG_POINTRCNN, device="cuda",
                             set_cfgs=["DATA_CONFIG.DATA_PATH", str(data)])
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=b,
                                    training=False, workers=0)
    batch = _to_device_batch(next(iter(loader)), torch.device("cuda"))
    n = batch["points"].shape[1]
    zero = {k: 0 for k in bs.launches}
    with torch.inference_mode():
        bs.reset_launches()
        out = model(batch)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
    fbd = out["final_box_dicts"]
    log("kitti", f"KITTI infos and {record['gt_database_objects']} gt database objects in "
                 f"{record['create_kitti_infos_seconds']:.3f} s; PointRCNN, one b{b} x {n} "
                 f"forward at full width: kernel launches {counts}; proposals "
                 f"{tuple(out['rois'].shape)}, valid {out['roi_valid'].sum(1).tolist()}; boxes "
                 f"{tuple(fbd['pred_boxes'].shape)}, valid per cloud {fbd['pred_valid'].sum(1).tolist()}")
    want_n = next(int(p["NUM_POINTS"]["test"]) for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                  if p["NAME"] == "sample_points")
    if counts != zero or not torch.isfinite(fbd["pred_boxes"]).all() \
            or not fbd["pred_valid"].any(1).all() or n != want_n:
        raise AssertionError(f"kitti: launches {counts}, or boxes not finite or missing, or {n} points")
    record.update({"config": CFG_POINTRCNN, "batch": b, "points": n, "forward_launches": counts})

    rec = _kitti_card_vs_cpu(model, sd, CFG_POINTRCNN, batch, cfg)
    log("kitti", "b1 card against CPU: FPS ({fps_calls} calls) and ball-query ({ball_query_calls}) "
                 "indices equal; the proposal and the final NMS's kept indices ({nms_kept}) equal "
                 "on the card's inputs; ".format(**rec)
        + "; ".join(f"{k} {rec[k]['max_abs_err']:.3e} (CPU spread {rec[k]['cpu_spread']:.3e}, "
                    f"limit {rec[k]['limit']:.3e})" for k in KITTI_TOL)
        + f"; {rec['boxes_matched']} boxes matched; the CPU's forward {rec['cpu_seconds']:.3f} s")
    record["card_vs_cpu"] = rec

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(batch), warmup=0, iters=3)  # warm: the counted forward
        stages = stage_ms(kitti_stages(model, cfg), batch, iters=1)
    peak = torch.cuda.max_memory_allocated()
    record.update(forward_ms=fwd_ms, stages_ms=stages, forward_peak_bytes=peak)
    log("kitti", f"forward b{b} x {n}: {fwd_ms:.6f} ms; stages "
                 + ", ".join(f"{k} {v:.6f}" for k, v in stages.items())
                 + f" ms; peak memory {peak / 2**30:.3f} GiB")

    _, train_loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=b,
                                          training=True, workers=0, seed=seed)
    train_batch = _to_device_batch(next(iter(train_loader)), torch.device("cuda"))
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=KITTI_TRAIN_STEPS,
                                   total_epochs=1)
    create_train_state(model, optimizer, seed)
    model.load_state_dict(sd, strict=True)
    from pcp_tpu_torch.models.roi_heads import pointrcnn_head

    given = dict(train_batch, **jittered_gt_rois(train_batch["gt_boxes"], seed))
    drawn, assign = [], pointrcnn_head.assign_targets
    pointrcnn_head.assign_targets = lambda *a, **k: drawn.append(assign(*a, **k)) or drawn[-1]
    losses, step_ms, peaks, tbs = [], [], [], []
    bs.reset_launches()
    try:
        for i in range(KITTI_TRAIN_STEPS):  # make_train_step's step, its peaks read between
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            optimizer.zero_grad(set_to_none=True)
            out = model(given if i == KITTI_TRAIN_STEPS - 1 else train_batch)
            forward_peak = torch.cuda.max_memory_allocated()
            out["loss"].backward()
            optimizer.step()
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(out["loss"].item())
            peaks.append((forward_peak, torch.cuda.max_memory_allocated()))
            tbs.append({k: v.item() for k, v in out["tb_dict"].items()})
    finally:
        pointrcnn_head.assign_targets = assign
    step_counts = dict(bs.launches)
    gt = int((train_batch["gt_boxes"][..., 7] > 0).sum())
    reg_fg = [int(t["reg_valid_mask"].sum()) for t in drawn]
    reg_grad = max(p.grad.abs().max().item() for p in model.roi_head.reg_layers.parameters())
    record.update(train_losses=losses, train_step_ms=step_ms, train_peak_bytes=peaks,
                  train_gt_boxes=gt, train_tb=tbs, train_reg_foreground=reg_fg,
                  train_reg_grad_max=reg_grad)
    log("kitti", f"{KITTI_TRAIN_STEPS} train steps on one b{b} batch with gt_sampling ({gt} gt "
                 f"boxes), the last on {KITTI_ROI_COPIES} jittered copies of each gt box as its "
                 f"ROIs: losses {' '.join(f'{v:.6f}' for v in losses)}, step ms "
                 f"{' '.join(f'{v:.6f}' for v in step_ms)}, peak memory (forward+loss, step) "
                 + ", ".join(f"{f / 2**30:.3f} / {t / 2**30:.3f} GiB" for f, t in peaks)
                 + f"; kernel launches {step_counts}; foreground ROIs for the reg loss {reg_fg}, "
                 f"the reg tower's largest |g| {reg_grad:.6e} in the last step; terms of each step "
                 + " | ".join(", ".join(f"{k} {v:.6f}" for k, v in t.items()) for t in tbs))
    if step_counts != zero or not np.isfinite(losses).all():
        raise AssertionError(f"kitti: train launches {step_counts}, losses {losses}")
    last = tbs[-1]
    if not (reg_fg[-1] > 0 and last["rcnn_loss_reg"] > 0 and last["rcnn_loss_corner"] > 0
            and 0 < reg_grad < float("inf")):
        raise AssertionError(f"kitti: the step on given ROIs trained no reg tower: foreground "
                             f"{reg_fg}, terms {last}, reg |g| {reg_grad}")
    del model, out, optimizer
    torch.cuda.empty_cache()
    record["cli"] = kitti_cli(root, data, seed)
    return counts, step_counts, record


# ------------------------------------------------------------ pvrcnn. PV-RCNN on the custom dataset

# the fake custom tree of tests/torch_fake_kitti.py: four training frames (two
# train steps at the config's b2 through the CLI) and two validation frames,
# each of MAX_POINTS_PER_SAMPLE returns
PVRCNN_TRAIN_IDS = ("a0", "a1", "a2", "a3")
PVRCNN_VAL_IDS = ("b0", "b1")
PVRCNN_POINTS = 32768
PVRCNN_TRAIN_STEPS = 2  # steps on one batch, each loss finite
# MODEL.VFE.MAX_VOXELS in each mode: the dataset config's
# MAX_NUMBER_OF_VOXELS, which neither package's VFE reads by itself
PVRCNN_BUDGETS = {"test": 40000, "train": 16000}
# card against CPU, b1 eval, (atol, rtol) of each tensor, held to at least
# SPREAD_FACTOR x the CPU's own spread between 8 and 4 threads; the ROI
# stage runs on the card's proposals on both sides
PVRCNN_TOL = {"point_features": (1e-4, 1e-4), "point_cls_scores": (1e-4, 1e-4),
              "batch_cls_preds": (1e-4, 1e-4), "batch_box_preds": (1e-4, 1e-4)}


def pvrcnn_sets(data, mode):
    """The CLIs' --set pairs of PV-RCNN on the tree at ``data`` in ``mode``
    (test or train): the z range override and the mode's voxel budget."""
    from pcp_tpu_torch.entry import PVRCNN_Z_RANGE

    return PVRCNN_Z_RANGE + ["DATA_CONFIG.DATA_PATH", str(data), "MODEL.VFE.MAX_VOXELS",
                            str(PVRCNN_BUDGETS[mode])]


def pvrcnn_stages(model, cfg):
    from pcp_tpu_torch.models.detectors.pointpillar import generic_post_processing
    from pcp_tpu_torch.models.roi_heads.roi_head_template import proposal_layer

    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    return [(name, getattr(model, name)) for name in
            ("vfe", "backbone_3d", "map_to_bev", "pfe", "backbone_2d", "dense_head", "point_head")] + [
        ("proposal_layer", lambda d: proposal_layer(d, nms_cfg)), ("roi_head", model.roi_head),
        ("post_processing", lambda d: dict(d, final_box_dicts=generic_post_processing(cfg.MODEL, d)))]


def _pvrcnn_card_vs_cpu(model, sd, sets, batch, cfg):
    """b1 card against CPU: the FPS keypoints and every ball query's indices
    equal, the keypoint features and scores within PVRCNN_TOL (or
    SPREAD_FACTOR x the CPU's spread), the ROI stage on the card's proposals
    within PVRCNN_TOL, the surviving boxes under the margin rule; the
    proposal and the final NMS exact on the card's own inputs."""
    from pcp_tpu_torch.entry import CFG_PVRCNN, build
    from pcp_tpu_torch.ops.nms import class_agnostic_nms
    from pcp_tpu_torch.utils.box_match import match_surviving_boxes

    b1 = {k: v[:1] for k, v in batch.items()}
    with torch.inference_mode(), record_indices() as gpu_seen:
        gpu = model(b1)
    pins = ("rois", "roi_scores", "roi_labels", "roi_valid")
    host = {k: v.cpu() for k, v in b1.items()}
    host.update({k: gpu[k].cpu() for k in pins}, has_class_labels=True)

    def on_cpu(threads):
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            _, _, cpu = build(CFG_PVRCNN, device="cpu", set_cfgs=sets)
            cpu.load_state_dict(sd, strict=True)
            with torch.inference_mode(), record_indices() as seen:
                return cpu(host), seen
        finally:
            torch.set_num_threads(before)

    t0 = time.perf_counter()
    cpu, cpu_seen = on_cpu(8)
    cpu_s = time.perf_counter() - t0
    cpu4, _ = on_cpu(4)
    for kind in ("fps", "ball_query"):
        if len(gpu_seen[kind]) != len(cpu_seen[kind]) or not all(
                torch.equal(g, c) for g, c in zip(gpu_seen[kind], cpu_seen[kind])):
            raise AssertionError(f"pvrcnn: {kind} indices differ between the card and the CPU")
    rec = {"cpu_seconds": cpu_s, "fps_calls": len(gpu_seen["fps"]),
           "ball_query_calls": len(gpu_seen["ball_query"]),
           "keypoints_valid": int(gpu["point_coords_mask"].sum())}
    for key, (atol, rtol) in PVRCNN_TOL.items():
        g, c, c4 = gpu[key].cpu(), cpu[key], cpu4[key]
        spread = (c - c4).abs().max().item()
        err = (g - c).abs().max().item()
        limit = max(atol + rtol * c.abs().max().item(), SPREAD_FACTOR * spread)
        rec[key] = {"max_abs_err": err, "cpu_spread": spread, "limit": limit,
                    "max_abs": c.abs().max().item()}
        if not err <= limit:
            raise AssertionError(f"pvrcnn: {key} card vs CPU {err} over {limit} ({rec[key]})")
    pp = cfg.MODEL.POST_PROCESSING
    got = {k: v[0].cpu().numpy() for k, v in gpu["final_box_dicts"].items()}
    want = {k: v[0].numpy() for k, v in cpu["final_box_dicts"].items()}
    rec["boxes_matched"] = match_surviving_boxes(
        got, want, heat_scores=np.zeros(0), top_k=1, score_thresh=float(pp.SCORE_THRESH),
        post_max=int(pp.NMS_CONFIG.NMS_POST_MAXSIZE), margin=1e-4, box_atol=1e-3,
        box_rtol=1e-4, score_atol=1e-4, min_matched=1)
    # the NMS's kept indices on one set of inputs, on the card and on the
    # CPU: the anchor head's proposals and the refined boxes
    rpn = dict(b1)
    with torch.inference_mode():
        for name in model.module_names[:model.module_names.index("dense_head") + 1]:
            rpn = getattr(model, name)(rpn)
    nms_in = ((rpn["batch_box_preds"], torch.sigmoid(rpn["batch_cls_preds"]).max(-1).values, None,
               cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST, None),
              (gpu["batch_box_preds"], torch.sigmoid(gpu["batch_cls_preds"]).max(-1).values,
               gpu["batch_pred_valid"], pp.NMS_CONFIG, float(pp.SCORE_THRESH)))
    kept = []
    for boxes, sc, valid, nms_cfg, thresh in nms_in:
        if valid is None:
            valid = torch.ones_like(sc, dtype=torch.bool)
        on_card = class_agnostic_nms(boxes, sc, valid, nms_cfg, score_thresh=thresh)[0].cpu()
        on_cpu_ = class_agnostic_nms(boxes.cpu(), sc.cpu(), valid.cpu(), nms_cfg,
                                     score_thresh=thresh)[0]
        if not torch.equal(on_card, on_cpu_):
            raise AssertionError("pvrcnn: NMS kept indices differ between the card and the CPU")
        kept.append(int((on_card >= 0).sum()))
    rec["nms_kept"] = kept
    return rec


def pvrcnn_cli(root, data, seed):
    """The CLI stages on the fake tree: the train CLI for one epoch (two b2
    steps with the config's adam_onecycle), then the test CLI's KITTI AP
    table through MAP_CLASS_TO_KITTI. Returns the record."""
    from pcp_tpu_torch.entry import CFG_PVRCNN
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli

    common = ["--cfg_file", CFG_PVRCNN, "--batch_size", "2", "--device", "cuda", "--workers",
              "0", "--output_root", str(root), "--extra_tag", "smoke"]
    ckpt = root / "cfgs" / "custom_models" / "pv_rcnn" / "smoke" / "ckpt" / "checkpoint_epoch_1.pth"
    record = {}
    for name, main_fn, argv in (
            ("train_pvrcnn", train_cli.main,
             common + ["--epochs", "1", "--seed", str(seed), "--num_epochs_to_eval", "0",
                       "--precise_bn", "0", "--set"] + pvrcnn_sets(data, "train")),
            ("eval_pvrcnn", test_cli.main,
             common + ["--ckpt", str(ckpt), "--set"] + pvrcnn_sets(data, "test"))):
        bs.reset_launches()
        t0 = time.perf_counter()
        out = main_fn(argv)
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0, "launches": dict(bs.launches)}
        if any(rec["launches"].values()):
            raise AssertionError(f"pvrcnn {name}: kernel launches {rec['launches']}")
        if name.startswith("train"):
            rec.update(steps=out["steps"], step_ms=out["step_ms_median"], losses=out["losses"])
            if out["steps"] != len(PVRCNN_TRAIN_IDS) // 2 or not np.isfinite(out["losses"]).all():
                raise AssertionError(f"pvrcnn {name}: {out['steps']} steps, losses {out['losses']}")
            detail = (f"{out['steps']} steps, median step {out['step_ms_median']:.6f} ms, losses "
                      + " ".join(f"{v:.6f}" for v in out["losses"]))
        else:
            keys = [k for k in out if k.endswith("_R40")] + ["recall/rcnn_0.7"]
            rec.update({k: float(out[k]) for k in keys})
            if len(keys) != 37 or not all(np.isfinite(rec[k]) for k in keys):
                raise AssertionError(f"pvrcnn {name}: results {rec}")
            detail = ", ".join(f"{k} {rec[k]:.6f}" for k in keys if "moderate" in k)
        record[name] = rec
        log("pvrcnn", f"{name}: {rec['seconds']:.3f} s; {detail}; kernel launches {rec['launches']}")
    return record


def pvrcnn_plusplus(sets, batch, train_batch, seed):
    """PV-RCNN++ (``entry.PVRCNN_PLUSPLUS`` over the config) at b1 on the
    card with seeded weights: one eval forward (SPC keypoints about the
    proposals, boxes finite) and its time, then one train step with the
    config's optimizer on jittered gt boxes handed in as ROIs, sampled
    before the PFE (reg foreground, reg and corner losses and the reg
    tower's gradient nonzero and finite). Returns the record."""
    from pcp_tpu_torch.entry import CFG_PVRCNN, PVRCNN_PLUSPLUS, build
    from pcp_tpu_torch.models.roi_heads import pvrcnn_head
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state

    cfg, _, model = build(CFG_PVRCNN, device="cuda", set_cfgs=sets + PVRCNN_PLUSPLUS)
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    b1 = {k: v[:1] for k, v in batch.items()}
    zero = {k: 0 for k in bs.launches}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        bs.reset_launches()
        out = model(b1)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
        fwd_ms = cuda_ms(lambda: model(b1), warmup=0, iters=2)
    fbd = out["final_box_dicts"]
    rec = {"set_cfgs": PVRCNN_PLUSPLUS, "forward_launches": counts, "forward_ms": fwd_ms,
           "forward_peak_bytes": torch.cuda.max_memory_allocated(),
           "keypoints_valid": int(out["point_coords_mask"].sum()),
           "points_valid": int(b1["points_mask"].sum()),
           "boxes_valid": int(fbd["pred_valid"].sum())}
    if counts != zero or not torch.isfinite(fbd["pred_boxes"]).all() or not rec["boxes_valid"]:
        raise AssertionError(f"pvrcnn++: launches {counts}, or boxes not finite or missing")

    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=1,
                                   total_epochs=1)
    create_train_state(model, optimizer, seed)
    model.load_state_dict(sd, strict=True)
    model.vfe.model_cfg["MAX_VOXELS"] = PVRCNN_BUDGETS["train"]
    t1 = {k: v[:1] for k, v in train_batch.items()}
    given = dict(t1, **jittered_gt_rois(t1["gt_boxes"], seed))
    drawn, assign = [], pvrcnn_head.assign_targets
    pvrcnn_head.assign_targets = lambda *a, **k: drawn.append(assign(*a, **k)) or drawn[-1]
    torch.cuda.reset_peak_memory_stats()
    bs.reset_launches()
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        optimizer.zero_grad(set_to_none=True)
        out = model(given)
        out["loss"].backward()
        optimizer.step()
        end.record()
        end.synchronize()
    finally:
        pvrcnn_head.assign_targets = assign
    tb = {k: v.item() for k, v in out["tb_dict"].items()}
    reg_grad = max(p.grad.abs().max().item() for p in model.roi_head.reg_layers.parameters())
    rec.update(train_launches=dict(bs.launches), train_step_ms=start.elapsed_time(end),
               train_peak_bytes=torch.cuda.max_memory_allocated(), train_loss=out["loss"].item(),
               train_tb=tb, train_reg_foreground=int(drawn[0]["reg_valid_mask"].sum()),
               train_reg_grad_max=reg_grad,
               train_keypoints_valid=int(out["point_coords_mask"].sum()))
    log("pvrcnn", f"PV-RCNN++ b1 x {b1['points'].shape[1]}: forward {fwd_ms:.6f} ms, "
                  f"{rec['keypoints_valid']} of {model.pfe.num_keypoints} keypoints valid (SPC "
                  f"about the proposals), {rec['boxes_valid']} boxes, peak memory "
                  f"{rec['forward_peak_bytes'] / 2**30:.3f} GiB; a train step on {KITTI_ROI_COPIES} jittered copies of each gt box as its "
                  f"ROIs: {rec['train_step_ms']:.6f} ms, loss {rec['train_loss']:.6f}, peak memory "
                  f"{rec['train_peak_bytes'] / 2**30:.3f} GiB, {rec['train_keypoints_valid']} "
                  f"keypoints valid, foreground ROIs for the reg loss {rec['train_reg_foreground']}, "
                  f"the reg tower's largest |g| {reg_grad:.6e}; kernel launches {counts}, "
                  f"{rec['train_launches']}; terms " + ", ".join(f"{k} {v:.6f}" for k, v in tb.items()))
    if rec["train_launches"] != zero or not np.isfinite(rec["train_loss"]) or not (
            rec["train_reg_foreground"] > 0 and tb["rcnn_loss_reg"] > 0
            and tb["rcnn_loss_corner"] > 0 and 0 < reg_grad < float("inf")):
        raise AssertionError(f"pvrcnn++: the train step {rec}")
    return rec


def phase_pvrcnn(seed):
    """Phase pvrcnn: the custom dataset's infos on a fake tree, PV-RCNN
    (``custom_models/pv_rcnn.yaml`` with the z range override) at full
    width on the card (eval forward and its stages, train steps, b1 against
    the CPU), and the CLI stages. Returns (launches of each kernel in a
    forward and in a train step, the record)."""
    import shutil

    sys.path.insert(0, str(REPO / "tests"))
    from torch_fake_kitti import make_custom_tree

    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.datasets.custom.custom_dataset import create_custom_infos
    from pcp_tpu_torch.entry import CFG_PVRCNN, build
    from pcp_tpu_torch.models.roi_heads import pvrcnn_head
    from pcp_tpu_torch.ops import bev_scatter as bs
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state
    from pcp_tpu_torch.train.train_utils import _to_device_batch

    root = REPO / "build" / "pvrcnn"
    shutil.rmtree(root, ignore_errors=True)
    data = make_custom_tree(root / "data", PVRCNN_TRAIN_IDS, PVRCNN_VAL_IDS, PVRCNN_POINTS, seed)
    sets = pvrcnn_sets(data, "test")
    cfg, info, model = build(CFG_PVRCNN, device="cuda", set_cfgs=sets)
    t0 = time.perf_counter()
    create_custom_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, data, data)
    record = {"create_custom_infos_seconds": time.perf_counter() - t0, "grid": list(info.grid_size)}
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=b,
                                    training=False, workers=0)
    batch = _to_device_batch(next(iter(loader)), torch.device("cuda"))
    n = batch["points"].shape[1]
    zero = {k: 0 for k in bs.launches}
    with torch.inference_mode():
        bs.reset_launches()
        out = model(batch)
        torch.cuda.synchronize()
        counts = dict(bs.launches)
    fbd = out["final_box_dicts"]
    limit = int(np.prod(out["sparse_dims"]))
    voxels = (out["voxel_ids"] < limit).sum(1).tolist()
    log("pvrcnn", f"custom infos in {record['create_custom_infos_seconds']:.3f} s; PV-RCNN, one b{b} "
                  f"x {n} forward at full width on the {info.grid_size} grid: kernel launches "
                  f"{counts}; voxels {voxels}; keypoints {tuple(out['point_coords'].shape)}; "
                  f"proposals {tuple(out['rois'].shape)}, valid {out['roi_valid'].sum(1).tolist()}; "
                  f"boxes {tuple(fbd['pred_boxes'].shape)}, valid per cloud "
                  f"{fbd['pred_valid'].sum(1).tolist()}")
    if counts != zero or not torch.isfinite(fbd["pred_boxes"]).all() \
            or not fbd["pred_valid"].any(1).all() or n != PVRCNN_POINTS \
            or out["spatial_features"].shape[1] != 256:
        raise AssertionError(f"pvrcnn: launches {counts}, or boxes not finite or missing, or {n} "
                             "points, or the BEV's width")
    record.update({"config": CFG_PVRCNN, "set_cfgs": sets, "batch": b, "points": n,
                   "voxels": voxels, "forward_launches": counts})

    rec = _pvrcnn_card_vs_cpu(model, sd, sets, batch, cfg)
    log("pvrcnn", "b1 card against CPU: FPS ({fps_calls} calls, {keypoints_valid} valid keypoints) "
                  "and ball-query ({ball_query_calls}) indices equal; the proposal and the final NMS's "
                  "kept indices ({nms_kept}) equal on the card's inputs; ".format(**rec)
        + "; ".join(f"{k} {rec[k]['max_abs_err']:.3e} (CPU spread {rec[k]['cpu_spread']:.3e}, "
                    f"limit {rec[k]['limit']:.3e})" for k in PVRCNN_TOL)
        + f"; {rec['boxes_matched']} boxes matched; the CPU's forward {rec['cpu_seconds']:.3f} s")
    record["card_vs_cpu"] = rec

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(batch), warmup=0, iters=3)  # warm: the counted forward
        stages = stage_ms(pvrcnn_stages(model, cfg), batch, iters=1)
    peak = torch.cuda.max_memory_allocated()
    record.update(forward_ms=fwd_ms, stages_ms=stages, forward_peak_bytes=peak)
    log("pvrcnn", f"forward b{b} x {n}: {fwd_ms:.6f} ms; stages "
                  + ", ".join(f"{k} {v:.6f}" for k, v in stages.items())
                  + f" ms; peak memory {peak / 2**30:.3f} GiB")

    _, train_loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=b,
                                          training=True, workers=0, seed=seed)
    train_batch = _to_device_batch(next(iter(train_loader)), torch.device("cuda"))
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model,
                                   total_iters_each_epoch=PVRCNN_TRAIN_STEPS, total_epochs=1)
    create_train_state(model, optimizer, seed)
    model.load_state_dict(sd, strict=True)
    model.vfe.model_cfg["MAX_VOXELS"] = PVRCNN_BUDGETS["train"]
    given = dict(train_batch, **jittered_gt_rois(train_batch["gt_boxes"], seed))
    drawn, assign = [], pvrcnn_head.assign_targets
    pvrcnn_head.assign_targets = lambda *a, **k: drawn.append(assign(*a, **k)) or drawn[-1]
    losses, step_ms, peaks, tbs = [], [], [], []
    bs.reset_launches()
    try:
        for i in range(PVRCNN_TRAIN_STEPS):  # make_train_step's step, its peaks read between
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            optimizer.zero_grad(set_to_none=True)
            out = model(given if i == PVRCNN_TRAIN_STEPS - 1 else train_batch)
            forward_peak = torch.cuda.max_memory_allocated()
            out["loss"].backward()
            optimizer.step()
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(out["loss"].item())
            peaks.append((forward_peak, torch.cuda.max_memory_allocated()))
            tbs.append({k: v.item() for k, v in out["tb_dict"].items()})
    finally:
        pvrcnn_head.assign_targets = assign
    step_counts = dict(bs.launches)
    gt = int((train_batch["gt_boxes"][..., 7] > 0).sum())
    reg_fg = [int(t["reg_valid_mask"].sum()) for t in drawn]
    reg_grad = max(p.grad.abs().max().item() for p in model.roi_head.reg_layers.parameters())
    record.update(train_losses=losses, train_step_ms=step_ms, train_peak_bytes=peaks,
                  train_gt_boxes=gt, train_tb=tbs, train_reg_foreground=reg_fg,
                  train_reg_grad_max=reg_grad)
    log("pvrcnn", f"{PVRCNN_TRAIN_STEPS} train steps on one b{b} batch ({gt} gt boxes), a voxel "
                  f"budget of {PVRCNN_BUDGETS['train']}, the last on {KITTI_ROI_COPIES} jittered "
                  f"copies of each gt box as its ROIs: losses {' '.join(f'{v:.6f}' for v in losses)}, "
                  f"step ms {' '.join(f'{v:.6f}' for v in step_ms)}, peak memory (forward+loss, "
                  "step) " + ", ".join(f"{f / 2**30:.3f} / {t / 2**30:.3f} GiB" for f, t in peaks)
                  + f"; kernel launches {step_counts}; foreground ROIs for the reg loss {reg_fg}, "
                  f"the reg tower's largest |g| {reg_grad:.6e} in the last step; terms of each step "
                  + " | ".join(", ".join(f"{k} {v:.6f}" for k, v in t.items()) for t in tbs))
    if step_counts != zero or not np.isfinite(losses).all():
        raise AssertionError(f"pvrcnn: train launches {step_counts}, losses {losses}")
    last = tbs[-1]
    if not (reg_fg[-1] > 0 and last["rcnn_loss_reg"] > 0 and last["rcnn_loss_corner"] > 0
            and 0 < reg_grad < float("inf")):
        raise AssertionError(f"pvrcnn: the step on given ROIs trained no reg tower: foreground "
                             f"{reg_fg}, terms {last}, reg |g| {reg_grad}")
    del model, out, optimizer
    torch.cuda.empty_cache()
    record["plusplus"] = pvrcnn_plusplus(sets, batch, train_batch, seed)
    torch.cuda.empty_cache()
    record["cli"] = pvrcnn_cli(root, data, seed)
    return counts, step_counts, record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    # cuBLAS's deterministic mode (phase 5) needs this before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    seconds, last = {}, time.perf_counter()

    def lap(phase):
        nonlocal last
        now = time.perf_counter()
        seconds[phase], last = now - last, now
        log("main", f"phase {phase}: {seconds[phase]:.1f} s")

    card = phase_device()
    lap("device")
    phase_build()
    lap("build")
    records = phase_kernels(args.seed)
    lap("kernels")
    slice_launches, trained = phase_slice(args.seed)
    lap("slice")
    for kernel, count in slice_launches.items():
        records[kernel]["launches"] = count
    train_launches, train = phase_train(args.seed)
    lap("train")
    sender_launches, senders = phase_exchange(args.seed)
    lap("exchange")
    sender_train_launches, sender_train = phase_sender_train(args.seed)
    lap("sender_train")
    for kernel, record in records.items():
        record["launches_per_train_step"] = train_launches.get(kernel)
        record["launches_per_sender_forward"] = sender_launches[kernel]
        record["launches_per_sender_train_step"] = sender_train_launches[kernel]
    bench = phase_bench(card)
    lap("bench")
    serving_launches, serving = phase_serving()
    lap("serving")
    dp_launches, dp = phase_dp(args.seed)
    lap("dp")
    bf16 = bf16_train(args.seed)
    lap("bf16_train")
    for kernel, record in records.items():
        record["launches_per_serving_forward"] = {m: c[kernel] for m, c in serving_launches.items()}
        record["launches_per_dp_step_per_rank"] = dp_launches[kernel]
        record["launches_per_bf16_train_step"] = bf16["bf16"]["launches"][kernel]
    wire = senders["exchange"]["wire"].values()
    disco_eval, disco_train, disco = phase_disco(
        args.seed, statistics.mean(v["boxflow_bytes"] for v in wire))
    lap("disco")
    for kernel, record in records.items():
        record["launches_per_disco_eval_forward"] = disco_eval[kernel]
        record["launches_per_disco_train_step"] = disco_train[kernel]
    pipeline = phase_pipeline()
    lap("pipeline")
    for kernel, record in records.items():
        record["launches_in_pipeline"] = {name: rec["launches"][kernel]
                                          for name, rec in pipeline.items() if "launches" in rec}
    a11_forward, a11_step, a11 = phase_a11(args.seed)
    lap("a11")
    for kernel, record in records.items():
        record["launches_per_a11_forward"] = {m: c[kernel] for m, c in a11_forward.items()}
        record["launches_per_a11_train_step"] = {m: c[kernel] for m, c in a11_step.items()}
        record["launches_in_a11_cli"] = {name: rec["launches"][kernel]
                                         for name, rec in a11["cli"].items()}
    jr_forward, jr_step, jr = phase_jr(args.seed)
    lap("jr")
    for kernel, record in records.items():
        record["launches_per_jr_forward"] = {m: c[kernel] for m, c in jr_forward.items()}
        record["launches_per_jr_train_step"] = {m: c[kernel] for m, c in jr_step.items()}
        record["launches_in_jr_cli"] = {name: rec["launches"][kernel]
                                        for name, rec in jr["cli"].items()
                                        if name.startswith("eval_")}
    kitti_forward, kitti_step, kitti = phase_kitti(args.seed)
    lap("kitti")
    for kernel, record in records.items():
        record["launches_per_kitti_forward"] = kitti_forward[kernel]
        record["launches_per_kitti_train_step"] = kitti_step[kernel]
        record["launches_in_kitti_cli"] = {name: rec["launches"][kernel]
                                           for name, rec in kitti["cli"].items()}
    pvrcnn_forward, pvrcnn_step, pvrcnn = phase_pvrcnn(args.seed)
    lap("pvrcnn")
    for kernel, record in records.items():
        record["launches_per_pvrcnn_forward"] = pvrcnn_forward[kernel]
        record["launches_per_pvrcnn_train_step"] = pvrcnn_step[kernel]
        record["launches_in_pvrcnn_cli"] = {name: rec["launches"][kernel]
                                            for name, rec in pvrcnn["cli"].items()}
        record["launches_per_pvrcnn_plusplus_forward"] = pvrcnn["plusplus"]["forward_launches"][kernel]
        record["launches_per_pvrcnn_plusplus_train_step"] = pvrcnn["plusplus"]["train_launches"][kernel]
    # bev_scatter_runs keeps "launches": null: no setting of either package reaches it
    print(json.dumps({k: v for k, v in bench.items() if k != "profile"}))
    print(json.dumps({"kernels": list(records.values()), "train": train, "senders": senders,
                      "sender_train": sender_train, "trained_ego": trained,
                      "bench_profile": bench["profile"], "serving": serving, "dp": dp,
                      "bf16_train": bf16,
                      "disco": disco, "pipeline": pipeline, "a11": a11, "jr": jr,
                      "kitti": kitti, "pvrcnn": pvrcnn, "phase_seconds": seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
