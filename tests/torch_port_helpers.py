"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

The ego config's structure at reduced size: 13-feature points of which the
VFE reads 11, a 128x128 grid, three backbone levels with a strided-conv and a
transposed-conv deblock, feature stride 4, the ego head and post-processing.
Both packages are built from it; JAX is initialised from a seed, its BN
running statistics are randomised with numpy, and the port receives the same
variables through ``state_dict_from_jax_variables``. Training tests take a
batch of two clouds with gt boxes (``make_train_batch``) and the ego
config's adam_onecycle settings (``OPTIM``). The senders' structure
(``CAR_CFG``: 7-feature points of which the VFE reads 5, and a HunterJr
corrector with hidden [8]) shares the grid, backbone and head.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.models import build_network as build_torch
from pcp_tpu_torch.train.train_state import biases_before_bn
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables

GRID = 128
PC_RANGE = (-12.8, -12.8, -8.0, 12.8, 12.8, 0.0)
VOXEL = (0.2, 0.2, 8.0)
NUM_FEATURES, NUM_RAW = 13, 11

MODEL_CFG = {
    "NAME": "CenterPoint",
    "VFE": {"NAME": "DynPillarVFE", "NUM_RAW_POINT_FEATURES": NUM_RAW, "WITH_DISTANCE": False,
            "USE_ABSLOTE_XYZ": True, "USE_NORM": True, "NUM_FILTERS": [16, 16]},
    "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 16},
    "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1, 1],
                    "LAYER_STRIDES": [2, 2, 2], "NUM_FILTERS": [16, 32, 32],
                    "UPSAMPLE_STRIDES": [0.5, 1, 2], "NUM_UPSAMPLE_FILTERS": [16, 16, 16]},
    "DENSE_HEAD": {
        "NAME": "CenterHead", "CLASS_AGNOSTIC": False, "CLASS_NAMES_EACH_HEAD": [["car"]],
        "SHARED_CONV_CHANNEL": 16, "USE_BIAS_BEFORE_NORM": True, "NUM_HM_CONV": 2,
        "SEPARATE_HEAD_CFG": {
            "HEAD_ORDER": ["center", "center_z", "dim", "rot"],
            "HEAD_DICT": {"center": {"out_channels": 2, "num_conv": 2},
                          "center_z": {"out_channels": 1, "num_conv": 2},
                          "dim": {"out_channels": 3, "num_conv": 2},
                          "rot": {"out_channels": 2, "num_conv": 2}}},
        "TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 4, "NUM_MAX_OBJS": 500,
                                   "GAUSSIAN_OVERLAP": 0.1, "MIN_RADIUS": 2},
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 0.25,
                                         "code_weights": [1.0] * 8}},
        "POST_PROCESSING": {
            "SCORE_THRESH": 0.1, "POST_CENTER_LIMIT_RANGE": [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
            "MAX_OBJ_PER_SAMPLE": 500,
            "NMS_CONFIG": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.2, "NMS_PRE_MAXSIZE": 1000,
                           "NMS_POST_MAXSIZE": 83}},
    },
}


CAR_CFG = copy.deepcopy(MODEL_CFG)
CAR_CFG["VFE"]["NUM_RAW_POINT_FEATURES"] = 5
CAR_CFG["CORRECTOR"] = {"NAME": "HunterJr", "NUM_SWEEPS": 11, "BEV_IMAGE_STRIDE": 4,
                        "CONV_INPUT_CHANNELS": 64, "POINT_HEAD_HIDDEN_CHANNELS": [8],
                        "OBJ_HEAD_HIDDEN_CHANNELS": [8], "THRESHOLD_POINT_CLS_PROB": 0.3}
CAR_FEATURES = 7


def info_kwargs(num_features=NUM_FEATURES):
    return dict(class_names=("car",), num_point_features=num_features,
                point_cloud_range=PC_RANGE, voxel_size=VOXEL, grid_size=(GRID, GRID, 1))


def clustered_points(rng, b, n, spread=1.5, n_clusters=24, num_features=NUM_FEATURES):
    """(B, N, num_features) float32 points around random cluster centres, all
    in range, with every feature column filled."""
    centers = rng.uniform(-10, 10, size=(b, n_clusters, 2))
    ci = rng.integers(0, n_clusters, size=n)
    pts = rng.uniform(0, 1, size=(b, n, num_features)).astype(np.float32)
    pts[..., 0:2] = np.clip(centers[:, ci, :] + rng.normal(0, spread, (b, n, 2)), -12.7, 12.69)
    pts[..., 2] = rng.uniform(-3, -0.5, (b, n))
    return pts


def randomize_batch_stats(tree, rng):
    """Non-trivial BN running statistics (mean N(0, 0.5), var U(0.5, 2))."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = randomize_batch_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
    return out


def build_pair(seed=0, model_cfg=None, batch_points=None, num_features=NUM_FEATURES):
    """JAX model, its variables (numpy; an eval-mode init) and the port's
    CPU model holding the same weights."""
    model_cfg = copy.deepcopy(model_cfg or MODEL_CFG)
    rng = np.random.default_rng(seed)
    info = info_kwargs(num_features)
    jmodel = build_jax(CfgDict(model_cfg), num_class=1, dataset_info=JaxInfo(**info))
    pts = (batch_points if batch_points is not None
           else clustered_points(rng, 1, 256, num_features=num_features))
    # jitted: one compile of the model in place of an op-by-op compile of each op
    init = jax.jit(lambda key, p, m: jmodel.init(
        key, {"points": p, "points_mask": m, "batch_size": p.shape[0]}, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(pts), jnp.ones(pts.shape[:2], bool))
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"], rng)}
    tmodel = build_torch(TorchCfgDict(model_cfg), num_class=1,
                         dataset_info=TorchInfo(**info), device="cpu")
    load_eval_variables(tmodel, variables, model_cfg)
    return jmodel, variables, tmodel


def load_eval_variables(tmodel, variables, model_cfg):
    """Load JAX variables from an eval-mode init into the port's model. Such
    variables have no HunterJr object head (only training calls it), so the
    port's object head keeps its own weights; every other key must match."""
    result = tmodel.load_state_dict(state_dict_from_jax_variables(variables, model_cfg),
                                    strict=False)
    assert not result.unexpected_keys, result.unexpected_keys
    assert all(k.startswith("corrector.object_head.") for k in result.missing_keys), result.missing_keys


B, N = 2, 2000
OPTIM = {"OPTIMIZER": "adam_onecycle", "LR": 0.00051, "WEIGHT_DECAY": 0.01, "MOMS": [0.95, 0.85],
         "PCT_START": 0.4, "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 10}


def make_train_batch(rng):
    """(points, mask, gt_boxes) numpy: two clouds of N points, padding rows in
    the second, and car boxes, one on a cell corner of the stride-4 map and
    one past the grid, with padding rows."""
    pts = clustered_points(rng, B, N)
    mask = np.ones((B, N), bool)
    mask[1, -200:] = False
    gt = np.zeros((B, 12, 8), np.float32)
    for b, k in ((0, 8), (1, 5)):
        gt[b, :k, 0:2] = rng.uniform(-11, 11, (k, 2))
        gt[b, :k, 2] = -1.0
        gt[b, :k, 3:6] = [4.2, 1.8, 1.6]
        gt[b, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        gt[b, :k, 7] = 1
    gt[0, 0, 0:2] = [-12.8 + 0.8 * 5, -12.8 + 0.8 * 9]  # on a cell corner
    gt[1, 0, 0] = 13.5  # past the grid: clipped to the last column
    return pts, mask, gt


def jax_batch(pts, mask, gt):
    return {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
            "gt_boxes": jnp.asarray(gt), "batch_size": pts.shape[0]}


def torch_batch(pts, mask, gt):
    return {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask),
            "gt_boxes": torch.from_numpy(gt)}


def exact_zero_leaves(model):
    """Names of the leaves whose gradient is 0 in exact arithmetic: the conv
    biases that a BN follows (``train_state.biases_before_bn``; DiscoNet's
    pixel weightor has two outside an ``nn.Sequential``) and a sender's last BN
    bias of the object head's shape encoder (every local pools a positive
    value in every channel, so that bias moves them all alike, and the next
    masked BN takes it out). Rounding alone decides their gradient's sign,
    so checks hold them apart."""
    names = biases_before_bn(model)
    if hasattr(model, "v2x_mid_fusion"):
        names |= {f"v2x_mid_fusion.pixel_weightor.conv1_{i}.bias" for i in (1, 2)}
    if hasattr(model, "corrector"):
        enc = model.corrector.object_head.points_shape_encoder
        names.add(f"corrector.object_head.points_shape_encoder.{len(enc) - 2}.bias")
    return names
