"""Entry point of the port: counterpart of ``__graft_entry__._build``.

    cfg, info, model = build("tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_ego.yaml")
    with torch.inference_mode():
        boxes = model({"points": points, "points_mask": mask})["final_box_dicts"]

``points`` is (B, N, C) float32 and ``points_mask`` (B, N) bool, on the
model's device. The senders (``CFG_CAR``, ``CFG_RSU``: CenterPoint with the
HunterJr corrector, 7-feature points) also return ``points_cls_prob`` and
``points_flow3d``, which ``train/eval_utils.py::make_exchange_writer``
broadcasts through ``exchange/database.py``. DiscoNet (``CFG_DISCO``: mid
fusion with frozen per-agent BEV makers) takes 6-feature merged clouds
whose last column is the agent, with ``se3_from_ego_arr`` (B, 6, 4, 4) and
``agent_present`` (B, 6). The anchor-head car (``CFG_ANCHOR_CAR``: PointPillar
with AnchorHeadSingle) takes 7-feature points; SECOND (``CFG_SECOND_CAR``,
``CFG_SECOND_RSU``: the sparse voxel backbone with HunterJr, 7-feature
points; ``CFG_SECOND_EGO``: 13-feature points with MoDAR rows) returns what
the pillar models of the same role return. PointRCNN (``CFG_POINTRCNN``)
takes KITTI's 4-feature points (``MAX_POINTS_PER_SAMPLE`` 16384, the
``sample_points`` count) and returns the refined boxes with the ROI stage's
class labels. PV-RCNN (``CFG_PVRCNN``, the custom dataset's 4-feature
points, ``MAX_POINTS_PER_SAMPLE`` 32768) needs ``PVRCNN_Z_RANGE`` among
its ``set_cfgs``: the shipped z range of [-3, 1] m at 0.2 m leaves its
sparse backbone's output with no z slice, in both packages. The model is
in eval mode with
initial weights; load trained ones with ``model.load_state_dict`` (see
``utils/jax_weights.py``).

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: the data-parallel gate of the ego's
training over n ranks.
"""
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from .config import ROOT_DIR, CfgDict, cfg_from_list, cfg_from_yaml_file
from .models import DatasetInfo, build_network

CFG_EGO = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_ego.yaml"
CFG_CAR = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml"
CFG_RSU = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_rsu.yaml"
CFG_DISCO = "tools/cfgs/v2x_sim_models/v2x_pointpillar_disco.yaml"
# the anchor-head PointPillar car, and SECOND's car, RSU and ego
CFG_ANCHOR_CAR = "tools/cfgs/v2x_sim_models/v2x_pointpillar_anchor_car.yaml"
CFG_SECOND_CAR = "tools/cfgs/v2x_sim_models/v2x_second_car.yaml"
CFG_SECOND_RSU = "tools/cfgs/v2x_sim_models/v2x_second_rsu.yaml"
CFG_SECOND_EGO = "tools/cfgs/v2x_sim_models/v2x_second_ego.yaml"
# PointRCNN on KITTI
CFG_POINTRCNN = "tools/cfgs/kitti_models/pointrcnn.yaml"
# PV-RCNN on the custom dataset, and the z range it runs at: 40 slices of the
# shipped 0.2 m, the count VoxelBackBone8x's strides are built for (KITTI's
# [-3, 1] m at 0.1 m); every model width as published
CFG_PVRCNN = "tools/cfgs/custom_models/pv_rcnn.yaml"
PVRCNN_Z_RANGE = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-70.4, -40, -3, 70.4, 40, 5]"]
# PV-RCNN++ as --set pairs over CFG_PVRCNN: keypoints by SPC sampling about
# the proposals, VectorPool for the raw points and the ROI grid, at the
# settings the JAX package's PV-RCNN++ test holds
# (tests/test_pvrcnn_plusplus.py::_ppcfg); no shipped config uses it
PVRCNN_PLUSPLUS = [
    "MODEL.NAME", "PVRCNNPlusPlus",
    "MODEL.PFE.SAMPLE_METHOD", "SPC",
    "MODEL.PFE.SPC_SAMPLING", repr({"NUM_SECTORS": 6, "SAMPLE_RADIUS_WITH_ROI": 1.6}),
    "MODEL.PFE.SA_LAYER.raw_points", repr({
        "NAME": "VectorPoolAggregationModuleMSG", "NUM_REDUCED_CHANNELS": 1,
        "NUM_CHANNELS_OF_LOCAL_AGGREGATION": 8, "LOCAL_AGGREGATION_TYPE": "local_interpolation",
        "MSG_POST_MLPS": [16],
        "GROUP_CFG_0": {"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.4,
                        "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16, 16]},
        "GROUP_CFG_1": {"NUM_LOCAL_VOXEL": [3, 3, 3], "MAX_NEIGHBOR_DISTANCE": 1.2,
                        "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16, 16]}}),
    "MODEL.ROI_HEAD.ROI_GRID_POOL", repr({
        "NAME": "VectorPoolAggregationModuleMSG", "GRID_SIZE": 3, "NUM_REDUCED_CHANNELS": 16,
        "NUM_CHANNELS_OF_LOCAL_AGGREGATION": 8, "LOCAL_AGGREGATION_TYPE": "voxel_avg_pool",
        "MSG_POST_MLPS": [32],
        "GROUP_CFG_0": {"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.8,
                        "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [32]}}),
]


def build(cfg_path=CFG_EGO, device="cuda", pre_reduce=None, set_cfgs=None):
    """Returns (cfg, info, model) for the YAML config at ``cfg_path``, with the
    model on ``device`` (default "cuda": raises where there is no GPU). A
    relative path that does not exist is taken from the repository root.
    ``pre_reduce`` (True, "fused" or "onehot"), if given, replaces the
    config's ``MODEL.VFE.PRE_REDUCE`` and so selects the VFE's scatter kernel.
    ``set_cfgs`` are the CLIs' ``--set`` pairs (``["MODEL.BF16", "True"]``),
    applied first."""
    path = Path(cfg_path)
    if not path.is_absolute() and not path.exists():
        path = ROOT_DIR / path
    cfg = cfg_from_yaml_file(path, CfgDict())
    if set_cfgs:
        cfg_from_list(list(set_cfgs), cfg)
    if pre_reduce is not None:
        cfg.MODEL["VFE"]["PRE_REDUCE"] = pre_reduce
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset_info=info,
                          device=device)
    return cfg, info, model


# the gate's tiny urban world: 4+ full batches at one sample a rank (3 train
# steps on distinct loader batches and a fresh eval batch); 512 points a
# sample keep it cheap while the grid stays the real 512x512
GATE_DATA = {"USE_SYNTHETIC_DATA": True,
             "SYNTHETIC": {"NUM_SCENES": 6, "KEYFRAMES_PER_SCENE": 10, "NUM_CARS": 8,
                           "NUM_PEDS": 2, "WORLD": "urban", "NUM_PARKED": 4},
             "MAX_POINTS_PER_SAMPLE": 512, "EXCHANGE_MODAR": True,
             "DATASET_DOWNSAMPLING_RATIO": 1, "MINI_TRAINVAL_STRIDE": 1}
GATE_SEED = 42
MODAR_SCORE = 9  # the MoDAR row's sender score in the 13-feature layout


def dryrun_multichip(n, backend="nccl", device="cuda"):
    """The data-parallel gate of the JAX package (``__graft_entry__.py:62-243``)
    on the port: n ranks, spawned here and meeting through a ``file://``
    store in a temporary directory, train the ego (``CFG_EGO``) at its full
    512x512 grid, one sample a rank. Each rank checks that its share of the
    loader's batch equals the one-process batch's rows; the boxflow exchange
    database staged from the synthetic world reaches the batch as MoDAR rows
    on at least half of the ranks; three steps on distinct loader batches
    give finite losses that fall; the eval of a fresh batch merges to n
    samples in the global order. The default is NCCL with a card a rank,
    and raises where there are fewer than n cards; gloo takes CUDA tensors
    (ranks may then share a card) or, with ``device="cpu"``, runs on the
    CPU. Returns the gate's summary; a failing rank raises here."""
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) over NCCL needs {n} CUDA devices, "
                           f"{torch.cuda.device_count()} found")
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_dryrun_rank, args=(n, backend, device, tmp, threads),
                                    nprocs=n, join=True)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]
    summary = dict(ranks[0])
    summary["modar_rows_per_rank"] = [r["modar_rows"] for r in ranks]
    if sum(c > 0 for c in summary["modar_rows_per_rank"]) < n / 2:
        raise AssertionError(f"MoDAR rows missing on most ranks: {summary['modar_rows_per_rank']}")
    if any(r["losses"] != summary["losses"] for r in ranks):
        raise AssertionError("the ranks report different global losses")
    print(f"dryrun_multichip({n}): ok, {backend} on {device}, grid {summary['grid']}, loader "
          f"{summary['samples']} samples / {summary['batches']} batches, every rank's rows == "
          f"the host batch's, MoDAR rows per rank {summary['modar_rows_per_rank']} (staged "
          f"boxflow database: {summary['staged']} files), losses {summary['losses']} over 3 "
          f"distinct batches, merged eval {summary['merged_eval']} samples", flush=True)
    return summary


def _dryrun_rank(rank, n, backend, device, tmp, threads):
    """One rank of :func:`dryrun_multichip`; writes its findings to
    ``{tmp}/rank{rank}.json``."""
    from .datasets import build_dataloader
    from .datasets.loader import DataLoader
    from .parallel import barrier, merge_results_dist, process_group, replicate_state, shard_batch
    from .train.optimization import build_optimizer
    from .train.train_state import create_train_state, make_eval_step, make_train_step
    from .train.train_utils import _to_device_batch
    from .utils.common_utils import create_logger

    torch.set_num_threads(threads)
    device = torch.device("cuda", rank) if backend == "nccl" else torch.device(device)
    with process_group(rank, n, f"file://{tmp}/rendezvous", backend, device):
        cfg, info, model = build(CFG_EGO, device=device)
        cfg.DATA_CONFIG.update(GATE_DATA)
        cfg.DATA_CONFIG["EXCHANGE_DATABASE_DIRECTORY"] = str(Path(tmp) / "exchange_database_gate")
        dataset, loader, _ = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=n, workers=0,
            seed=GATE_SEED, training=True, logger=create_logger(rank=rank))
        staged = _stage_boxflow(dataset) if rank == 0 else 0
        barrier()
        if len(loader) < 4:
            raise AssertionError(f"the gate's world is too small: {len(loader)} batches")
        host = DataLoader(dataset, n, shuffle=True, seed=GATE_SEED, drop_last=True,
                          num_workers=0, rank=0, world_size=1)
        batches, host_batches = iter(loader), iter(host)

        # this rank's rows are its share of the one-process batch
        batch0 = next(batches)
        want = shard_batch(next(host_batches), rank, n)
        for key in ("points", "points_mask", "gt_boxes"):
            if not np.array_equal(np.asarray(batch0[key]), np.asarray(want[key])):
                raise AssertionError(f"rank {rank}: {key} != the host batch's rows")
        points = np.asarray(batch0["points"])
        modar_rows = int((points[..., MODAR_SCORE] > 0).sum())

        optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=10,
                                       total_epochs=1)
        state = replicate_state(create_train_state(model, optimizer, seed=0))
        step = make_train_step(model, optimizer)
        losses = []
        for batch in (batch0, next(batches), next(batches)):
            loss, _ = step(_to_device_batch(batch, device))
            losses.append(float(loss))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"rank {rank}: losses over 3 steps {losses}")

        eval_batch = next(batches)
        final = make_eval_step(state.model)(_to_device_batch(eval_batch, device))
        boxes, valid = final["pred_boxes"].cpu().numpy(), final["pred_valid"].cpu().numpy()
        annos = [{"boxes_lidar": boxes[i][valid[i]], "frame_id": meta["lidar_token"]}
                 for i, meta in enumerate(eval_batch["metadata"])]
        merged = merge_results_dist(annos, total_size=n, chunk=len(annos))
        next(host_batches), next(host_batches)  # the host's batches 1 and 2: the steps'
        order = [m["lidar_token"] for m in next(host_batches)["metadata"]]
        if [a["frame_id"] for a in merged] != order:
            raise AssertionError(f"rank {rank}: merged eval out of the global order")
        result = {"grid": [int(g) for g in info.grid_size[:2]], "samples": len(dataset),
                  "batches": len(loader), "staged": staged, "modar_rows": modar_rows,
                  "losses": losses, "merged_eval": len(merged)}
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(result))


def _stage_boxflow(dataset):
    """The gate's exchange database: every sending agent's oracle boxflow
    rows at every keyframe, the wire format the ego's dataset reads
    (``__graft_entry__.py:165-183``). Returns the number of files."""
    shutil.rmtree(dataset.exchange_database[0].directory, ignore_errors=True)
    staged = 0
    for info in dataset.infos:
        sample = dataset.source.sample_record(info["token"])
        for lidar_name, lidar_token in sample["data"].items():
            if not lidar_name.startswith("LIDAR_TOP_id_"):
                continue
            lid = int(lidar_name.split("_")[-1])
            if lid == 1 or lid not in dataset._exchange_agent_ids():  # 1: the ego
                continue
            boxflow = dataset._oracle_boxflow(lidar_token)
            if boxflow.shape[0]:
                dataset.exchange_database[lid].save(sample["token"], lid, "boxflow", boxflow)
                staged += 1
    if not staged:
        raise AssertionError("the gate's exchange database staged no boxflow file")
    return staged
