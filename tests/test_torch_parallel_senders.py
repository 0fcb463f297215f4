"""Data-parallel training of the senders and DiscoNet: two gloo ranks on the
CPU against one process over the global batch.

The JAX package shards any model's batch over its mesh, so XLA computes
every batch-wide reduction of the sender corrector and of DiscoNet over the
global batch. The port's ranks must do the same (``parallel/collective.py``'s
rule). Rank r takes rows ``[r * b, (r + 1) * b)`` of each global input; the
ranks' code lives in tests/torch_dp_ranks.py, which imports no JAX; the
one-process references call the same functions. Everything here runs in
float64, where only the order of a few sums differs between the ranks and
one process, so each quantity is held to 1e-10 (relative for the loss, its
terms and each global value; over its leaf's largest |g| for each gradient
entry; absolute for running statistics and parameters; seen: the primitives
at most 9.5e-16, the car's and DiscoNet's gradients 3.9e-13 and 8.8e-14,
everything else at most 6.4e-14),
the leaves whose gradient is 0 in exact arithmetic (the conv biases in
front of a BN, a sender's last shape-encoder BN bias) to 1e-10 of the
model's largest |g|, and their parameters after the first Adam step, whose
sign rounding picks, to two learning rates:

* each global primitive on two shares equals the one-process function on
  the concatenated rows, value and every row's gradient: the Lovász-softmax
  term (errors ranked over the global rows, the present classes decided
  globally), CE+Lovász (its class weights and normaliser global), the hard
  miner with ties at the top-k cut across the rank boundary, with and
  without positives, the masked mean with no row on one rank, and
  DiscoNet's distillation mean;
* the small car (``CAR_CFG``: HunterJr with hidden [8]) and the small
  DiscoNet (the full config at narrow widths on a tiny synthetic world,
  one agent absent from one sample) in one train step: loss, every tb term,
  running statistics, gradients and parameters after the Adam step. The
  car's first cloud has no foreground, so rank 0's corrector sees none:
  ``any_fg``, the hard miners' counts and the masked means must be global;
* the car's and DiscoNet's BN recalibration (``train/bn_recal.py``) over
  two global batches under two ranks equals one process's, and both ranks
  end equal;
* the small ego's BF16 step under two ranks against one process's BF16
  step: loss and terms rtol 1e-4, statistics atol 1e-5, each gradient
  leaf within 0.05 of its largest |g| (seen: terms 2.3e-7, statistics
  6.0e-8, gradients 8.8e-3): each
  rank rounds its BN sums before the all-reduce adds them, and a bfloat16
  rounding that flips then grows through the layers.
"""
import copy
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pcp_tpu_torch.config import CfgDict, cfg_from_list, cfg_from_yaml_file
from pcp_tpu_torch.datasets import build_dataloader
from pcp_tpu_torch.models import DatasetInfo
from test_hunter_jr import make_sweep_batch
from torch_dp_ranks import (WORLD, build, model_step, recalibrated, run_primitive, senders_rank,
                            spawn_ranks)
from torch_port_helpers import (CAR_CFG, CAR_FEATURES, MODEL_CFG, OPTIM, exact_zero_leaves, info_kwargs,
                                make_train_batch, torch_batch)

SEED = 11
F64_TOL = 1e-10
BF16_LOSS_RTOL, BF16_STATS_ATOL, BF16_GRAD_SHARE = 1e-4, 1e-5, 5e-2

# the DiscoNet config at narrow widths on a tiny synthetic world
DISCO_CFG = "tools/cfgs/v2x_sim_models/v2x_pointpillar_disco.yaml"
WORLD_SET = ["DATA_CONFIG.USE_SYNTHETIC_DATA", "True",
             "DATA_CONFIG.SYNTHETIC", "{'NUM_SCENES': 3, 'KEYFRAMES_PER_SCENE': 3, 'NUM_CARS': 8, "
                                      "'NUM_PEDS': 2, 'WORLD': 'urban', 'NUM_PARKED': 4, "
                                      "'VISIBLE_FACES': True}",
             "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "4096", "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1",
             "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1",
             "DATA_CONFIG.DATA_PROCESSOR",
             "[{'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {'train': True, 'test': True}}, "
             "{'NAME': 'transform_points_to_voxels_placeholder', 'VOXEL_SIZE': [0.8, 0.8, 8.0]}]",
             "MODEL.V2X_MID_FUSION.COMPRESSED_CHANNELS", "16",
             "MODEL.DENSE_HEAD.SHARED_CONV_CHANNEL", "16"]
for _prefix in ("MODEL", "MODEL.BEV_MAKER_RSU", "MODEL.BEV_MAKER_CAR", "MODEL.BEV_MAKER_EARLY"):
    WORLD_SET += [f"{_prefix}.VFE.NUM_FILTERS", "[16, 16]", f"{_prefix}.MAP_TO_BEV.NUM_BEV_FEATURES",
                  "16", f"{_prefix}.BACKBONE_2D.LAYER_NUMS", "[1, 1, 1]",
                  f"{_prefix}.BACKBONE_2D.NUM_FILTERS", "[16, 32, 32]",
                  f"{_prefix}.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16, 16, 16]"]


def sweep_batch(rng):
    """The car's training batch of ``tests/test_hunter_jr.py::make_sweep_batch``
    (two clouds of 2048 sweep points, ``instances_tf`` with moving
    instances, gt boxes) as tensors, the first cloud's points all background
    on the last sweep."""
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_sweep_batch(rng).items()
             if k != "batch_size"}
    sweeps = batch["instances_tf"].shape[2]
    batch["points"][0, :, 4:7] = torch.tensor([0.0, sweeps - 1.0, -1.0])
    return batch


def _disco_case():
    """The small DiscoNet's model config and geometry, and two collated
    training items of the tiny world, agent 3 taken out of the second."""
    cfg = cfg_from_yaml_file(DISCO_CFG, CfgDict())
    cfg_from_list(list(WORLD_SET), cfg)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, ["car"], batch_size=2, training=True, workers=0)
    ds.rng = np.random.RandomState(3)
    batch = ds.collate_batch([ds[i] for i in range(2)])
    gone = batch["points"][1, :, 5] == 3
    assert gone.any()
    batch["points_mask"][1, gone] = False
    batch["se3_from_ego_arr"][1, 3] = np.eye(4)
    batch["agent_present"][1, 3] = False
    keys = ("points", "points_mask", "gt_boxes", "se3_from_ego_arr", "agent_present")
    info = dataclasses.asdict(DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, ["car"]))
    return copy.deepcopy(dict(cfg.MODEL)), info, {k: torch.from_numpy(batch[k]) for k in keys}


def _primitive_cases(rng):
    """Each primitive's global inputs (float64), rows split evenly over the
    ranks, and its keyword arguments."""
    n = 64
    labels = torch.from_numpy(rng.integers(0, 3, n))
    labels[: n // 2] = torch.where(labels[: n // 2] == 2, 0, labels[: n // 2])  # class 2: rank 1 only
    valid = torch.from_numpy(rng.uniform(size=n) > 0.15)
    logits = torch.from_numpy(rng.normal(0, 1.5, (n, 3)))
    # few distinct losses, so that equal values straddle the top-k cut and
    # the rank boundary; the negatives' top k reach into rank 1's rows
    loss = torch.from_numpy(rng.choice([0.25, 0.5, 1.0, 2.0], n))
    positive = torch.from_numpy(rng.uniform(size=n) > 0.7)
    err = torch.from_numpy(rng.uniform(0, 3, n))
    mask = torch.from_numpy(rng.uniform(size=n) > 0.5)
    mask[: n // 2] = False  # rank 0 holds no row of the mean
    fusion = {"NAME": "DISCO", "COMPRESSED_CHANNELS": 4}
    bev = torch.from_numpy(rng.normal(0, 1, (2, 6, 8, 8)))
    early = torch.from_numpy(rng.normal(0, 1, (2, 6, 8, 8)))
    return {"lovasz": ({"logits": logits, "labels": labels, "valid": valid}, {}),
            "ce_lovasz": ({"logits": logits, "labels": labels, "valid": valid}, {}),
            "hard_mining": ({"loss": loss, "positive": positive, "valid": valid}, {}),
            "hard_mining_no_positive": ({"loss": loss, "positive": positive, "valid": valid}, {}),
            "masked_mean": ({"err": err, "mask": mask}, {}),
            "distill": ({"bev": bev, "early": early},
                        {"cfg": fusion, "info": info_kwargs(), "seed": SEED})}


@pytest.fixture(scope="module")
def runs():
    """Every case in one process, then the same on two spawned ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    rng = np.random.default_rng(SEED)
    disco_cfg, disco_info, disco_batch = _disco_case()
    car_info = info_kwargs(CAR_FEATURES)
    ego_bf16 = dict(copy.deepcopy(MODEL_CFG), BF16=True)
    cases = {
        "primitives": _primitive_cases(rng),
        "steps": {"car": (CAR_CFG, car_info, sweep_batch(rng), torch.float64),
                  "disco": (disco_cfg, disco_info, disco_batch, torch.float64),
                  "ego_bf16": (ego_bf16, info_kwargs(),
                               torch_batch(*make_train_batch(np.random.default_rng(SEED))),
                               torch.float32)},
        "recal": {"car": (CAR_CFG, car_info, [sweep_batch(rng), sweep_batch(rng)]),
                  "disco": (disco_cfg, disco_info, [disco_batch, disco_batch])},
    }
    one = {"primitives": {name: run_primitive(name, x, **kw)
                          for name, (x, kw) in cases["primitives"].items()}}
    for name, (cfg, info, batch, dtype) in cases["steps"].items():
        one[name] = model_step(cfg, info, OPTIM, SEED, batch, dtype)
    one["recal"] = {name: recalibrated(cfg, info, SEED, batches, torch.float64)
                    for name, (cfg, info, batches) in cases["recal"].items()}
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(senders_rank, (tmp, cases, OPTIM, SEED))
        ranks = [torch.load(Path(tmp) / f"senders{r}.pt", weights_only=False) for r in range(WORLD)]
    torch.set_num_threads(threads)
    return one, ranks, {"car": build(CAR_CFG, car_info), "disco": build(disco_cfg, disco_info)}


@pytest.mark.parametrize("name", ["lovasz", "ce_lovasz", "hard_mining", "hard_mining_no_positive",
                                  "masked_mean", "distill"])
def test_global_primitive_equals_one_process(runs, name):
    one, ranks, _ = runs
    want = one["primitives"][name]
    for r in ranks:
        assert r["primitives"][name]["value"] == pytest.approx(want["value"], rel=F64_TOL)
    for key, grad in want["grads"].items():
        got = torch.cat([r["primitives"][name]["grads"][key] for r in ranks])
        assert grad.abs().max() > 0, key
        torch.testing.assert_close(got, grad, atol=F64_TOL * grad.abs().max().item(), rtol=0,
                                   msg=f"{name} {key}")


def _hold_step(want, ranks, model, tol=F64_TOL, grad_share=F64_TOL, stats_atol=F64_TOL):
    zero = exact_zero_leaves(model)
    top = max(g.abs().max().item() for g in want["grads"].values())
    for r in ranks:
        assert r["loss"] == pytest.approx(want["loss"], rel=tol)
        assert r["tb"].keys() == want["tb"].keys()
        for k, v in want["tb"].items():
            assert r["tb"][k] == pytest.approx(v, rel=tol, abs=tol), k
        assert r["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            scale = top if k in zero else g.abs().max().item()
            assert (r["grads"][k] - g).abs().max().item() <= grad_share * max(scale, 1e-30), k
        for k, v in want["state"].items():
            if "running_" in k:
                torch.testing.assert_close(r["state"][k], v, atol=stats_atol, rtol=0, msg=k)
    for k in want["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k


@pytest.mark.parametrize("name", ["car", "disco"])
def test_float64_step_equals_one_process(runs, name):
    """Loss, terms, statistics and gradients; then the parameters after the
    Adam step."""
    one, ranks, models = runs
    want = one[name]
    got = [r[name] for r in ranks]
    _hold_step(want, got, models[name])
    assert any(k.startswith("corrector." if name == "car" else "v2x_mid_fusion.") for k in want["grads"])
    if name == "car":
        assert want["tb"]["l_dtl_locals_feat"] > 0 and want["tb"]["l_locals_transl"] > 0
    else:
        assert want["tb"]["distill_loss"] > 0
    zero = exact_zero_leaves(models[name])
    for k, _ in models[name].named_parameters():
        atol = 2 * want["lr"] if k in zero else F64_TOL
        torch.testing.assert_close(got[0]["state"][k], want["state"][k], atol=atol, rtol=0, msg=k)


@pytest.mark.parametrize("name", ["car", "disco"])
def test_bn_recalibration_under_ranks(runs, name):
    """The averaged statistics under two ranks equal one process's (DiscoNet's
    compressor and weightor reached six times a forward, weighted by
    1 - (1 - momentum)^6), and the ranks end bitwise equal, so rank 0's
    checkpoint is every rank's."""
    one, ranks, _ = runs
    want = one["recal"][name]
    part = "corrector." if name == "car" else "v2x_mid_fusion.compressor."
    assert any(k.startswith(part) for k in want)
    for k, v in want.items():
        torch.testing.assert_close(ranks[0]["recal"][name][k], v, atol=F64_TOL, rtol=0, msg=k)
        assert torch.equal(ranks[0]["recal"][name][k], ranks[1]["recal"][name][k]), k


def test_bf16_step_under_ranks(runs):
    one, ranks, _ = runs
    ego = build(dict(copy.deepcopy(MODEL_CFG), BF16=True), info_kwargs())
    _hold_step(one["ego_bf16"], [r["ego_bf16"] for r in ranks], ego, tol=BF16_LOSS_RTOL,
               grad_share=BF16_GRAD_SHARE, stats_atol=BF16_STATS_ATOL)
