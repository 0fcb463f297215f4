"""DiscoNet mid fusion in the port against the JAX package's, on the CPU.

Small widths throughout: a 0.8 m voxel (a 128x128 grid, a 32x32 BEV after
the backbone's stride 4), one layer a backbone level, 16-channel VFEs and
upsamples (equal across the makers and the ego, since the compressor is
shared), 16 compressed channels. Inputs are made from numpy seeds or read
from the DiscoNet dataset on a tiny synthetic world; the port takes the JAX
package's variables through ``utils/jax_weights.py``.

* ``transform_bev_img`` on SE(2) transforms (the identity, a 90 degree
  turn, integer and fractional pixel shifts, random poses): exact, except a
  pixel whose source coordinate lies within ``WARP_MARGIN`` px of a rounding
  boundary (x.5), where float32 rounding of either side may pick either
  neighbour (the margin rule of the warp);
* ``V2XMidFusionDisco`` on random BEVs and poses, one agent absent: the
  fused BEV at atol/rtol 1e-5 in eval and in training, ``distill_loss`` at
  rtol 1e-5, the running statistics after one training forward (six updates
  of the compressor's and the weightor's BNs) within 1e-6;
* ``BEVMaker``: each agent's ``bev_img`` at 1e-5, an absent agent (all
  sentinels) included, ``bev_img_early`` only in training, and frozen
  (eval mode in a training detector, no gradient);
* the DiscoNet dataset item for item, exactly (train and test, with and
  without ``EXCHANGE_PREVIOUS``), and the collate;
* the whole small DiscoNet ``CenterPoint``: eval boxes under the margin rule
  of ``test_full_model_parity.py`` (atol 5e-3 / rtol 2e-3, scores 1e-4); one
  training step against the JAX package's jitted ``make_train_step``
  mid-schedule (seeded moments, as ``test_torch_c1.py``): the loss and every
  tb term at rtol 1e-4, every running statistic within 1e-6, every
  trainable leaf within 1e-6 where the port's optimizer takes the JAX
  step's gradient and, after the port's own step, outside the VFE within
  ``STEP_SHARE`` of the leaf's move; the port's gradient against a float64
  run of itself and against the JAX package's (the jitted one outside the
  VFE, the eager one in the VFE); the makers' parameters and statistics
  bitwise unchanged on both sides;
* ``recalibrate_batch_stats`` against the JAX package's on the small model:
  every BN updated six times a forward within 1e-6 plus ``SIX_RTOL``
  relative, the others within
  ``RECAL_RTOL`` / ``RECAL_ATOL`` (there the batch's statistics are the whole result, not a
  tenth of it: flax takes the batch variance as E[x^2] - E[x]^2 where the
  port takes two passes, and the JAX package reads each BN's rate off a
  second pass, so its result carries the float32 rounding of ``r`` over
  ``1 - r``; seen 3.2e-5 relative, 6.3e-7 absolute on a mean near 0), the makers' untouched;
* ``overlay_bev_maker_weights`` from port checkpoints, and one epoch of the
  reduced DiscoNet through ``tools/train.py --device cpu``: finite losses,
  the makers in the saved checkpoint equal to the overlaid tensors;
* ``OracleCorrector`` against the JAX module and ``correction_numpy``, and
  ``Teacher`` against the JAX module with seeded weights.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.datasets import build_dataloader as jax_build_dataloader
from pcp_tpu.models import build_network as jax_build_network
from pcp_tpu.models.bev_layers.bev_maker import BEVMaker as JaxBEVMaker
from pcp_tpu.models.bev_layers.oracle_corrector import OracleCorrector as JaxOracle
from pcp_tpu.models.bev_layers.teacher import Teacher as JaxTeacher
from pcp_tpu.models.bev_layers.v2x_fusion_disco import V2XMidFusionDisco as JaxFusion
from pcp_tpu.models.bev_layers.v2x_fusion_disco import transform_bev_img as jax_warp
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.models.vfe import build_vfe as jax_build_vfe
from pcp_tpu.train import build_optimizer as jax_build_optimizer
from pcp_tpu.train.bn_recal import recalibrate_batch_stats as jax_recalibrate
from pcp_tpu.train.optimization import one_cycle_fns as jax_one_cycle_fns
from pcp_tpu.train.train_state import TrainState as JaxTrainState
from pcp_tpu.train.train_state import make_train_step as jax_make_train_step
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.datasets import build_dataloader
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.models.bev_layers.bev_maker import BEVMaker
from pcp_tpu_torch.models.bev_layers.oracle_corrector import OracleCorrector
from pcp_tpu_torch.models.bev_layers.teacher import Teacher
from pcp_tpu_torch.models.bev_layers.v2x_fusion_disco import (V2XMidFusionDisco,
                                                             transform_bev_img,
                                                             warp_source_coords)
from pcp_tpu_torch.tools import train as train_cli
from pcp_tpu_torch.train.bn_recal import recalibrate_batch_stats
from pcp_tpu_torch.train.checkpoint import load_params_from_file, overlay_bev_maker_weights
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.train.train_state import init_weights
from pcp_tpu_torch.train.train_utils import _to_device_batch
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from test_torch_datasets import _two_threads, assert_same  # noqa: F401
from test_torch_eval import _kept
from test_torch_fusion_baselines import _model_cfgs, _world
from torch_c1_probe import with_fields
from torch_port_helpers import randomize_batch_stats

CFGS = "tools/cfgs/v2x_sim_models"
DISCO_CFG = f"{CFGS}/v2x_pointpillar_disco.yaml"
PROCESSOR = ("[{'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {'train': True, 'test': True}}, "
             "{'NAME': 'transform_points_to_voxels_placeholder', 'VOXEL_SIZE': [0.8, 0.8, 8.0]}]")
SINGLE = {"VFE.NUM_FILTERS": "[16, 16]", "MAP_TO_BEV.NUM_BEV_FEATURES": "16",
          "BACKBONE_2D.LAYER_NUMS": "[1, 1, 1]", "BACKBONE_2D.NUM_FILTERS": "[16, 32, 32]",
          "BACKBONE_2D.NUM_UPSAMPLE_FILTERS": "[16, 16, 16]"}
MAKERS = ("BEV_MAKER_RSU", "BEV_MAKER_CAR", "BEV_MAKER_EARLY")
DISCO_REDUCED = ["DATA_CONFIG.DATA_PROCESSOR", PROCESSOR,
                 "MODEL.V2X_MID_FUSION.COMPRESSED_CHANNELS", "16",
                 "MODEL.DENSE_HEAD.SHARED_CONV_CHANNEL", "16"]
for _prefix in ("MODEL",) + tuple(f"MODEL.{k}" for k in MAKERS):
    for _key, _value in SINGLE.items():
        DISCO_REDUCED += [f"{_prefix}.{_key}", _value]
WARP_MARGIN = 1e-4  # px from a rounding boundary
RECAL_RTOL, RECAL_ATOL = 1e-4, 2e-6
SIX_RTOL = 4e-6  # flax's E[x^2] - E[x]^2 batch variance: seen 1.8e-6 relative
ITERS, EPOCHS, STEP = 37, 30, 17 * 37 + 6  # mid-schedule: epoch 17, batch 6
GRAD_RTOL64, GRAD_RTOL_JAX = 2e-2, 2e-2
# the ego VFE against the eager JAX gradient: seen 9.3e-4 with the file's
# tests run alone, 7.6e-3 in the file's order, where the port's own float32
# gradient lies 0.8% from its float64 one (GRAD_RTOL64's reading)
GRAD_RTOL_EAGER = 2e-2
# the port's own step against the JAX step, of each leaf's move: seen 5.5e-3
# with the file's tests run alone, 8.7e-3 in the file's order
STEP_SHARE = 2e-2
PC_MIN, PIX, GRID = -51.2, 3.2, 32  # the small model's BEV after the backbone


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    every worker's torch would otherwise take all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _se2(angle, tx, ty):
    tf = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    tf[:2, :2] = [[c, -s], [s, c]]
    tf[:2, 3] = [tx, ty]
    return tf


def _random_pose(rng):
    return _se2(rng.uniform(-np.pi, np.pi), *rng.uniform(-30, 30, 2))


def _np(t):
    return t.detach().numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(_np(t), 1, -1)


def _info():
    return dict(class_names=("car",), num_point_features=6,
                point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                voxel_size=(0.8, 0.8, 8.0), grid_size=(128, 128, 1))


# ---------------------------------------------------------------- the warp

WARPS = {"identity": _se2(0.0, 0.0, 0.0), "rot90": _se2(np.pi / 2, 0.0, 0.0),
         "integer_shift": _se2(0.0, 2 * PIX, -5 * PIX),
         "fractional_shift": _se2(0.0, 0.37 * PIX, 1.23 * PIX),
         "rot90_shift": _se2(-np.pi / 2, 3 * PIX, 0.25 * PIX),
         # every source coordinate on a boundary: both sides round the same
         # exact x.5 half to even
         "half_pixel": _se2(0.0, 0.5 * PIX, -2.5 * PIX),
         "rot90_half_pixel": _se2(np.pi / 2, 0.5 * PIX, 1.5 * PIX),
         "random_0": _random_pose(np.random.default_rng(0)),
         "random_1": _random_pose(np.random.default_rng(1))}


def _off_boundary(tf):
    """(H, W) bool: the pixels whose source coordinates (the port's, before
    rounding) lie at least WARP_MARGIN px from a rounding boundary."""
    px, py = warp_source_coords(torch.from_numpy(tf)[None], GRID, GRID, PC_MIN, PIX)
    frac = lambda v: (v[0] - torch.floor(v[0]) - 0.5).abs()  # noqa: E731
    return (frac(px) >= WARP_MARGIN) & (frac(py) >= WARP_MARGIN)


@pytest.mark.parametrize("name", list(WARPS))
def test_warp_matches_jax(name):
    tf = WARPS[name]
    img = np.random.default_rng(5).normal(0, 1, (GRID, GRID, 6)).astype(np.float32)
    want = np.asarray(jax_warp(jnp.asarray(tf), jnp.asarray(img), PC_MIN, PIX))
    got = _nhwc(transform_bev_img(torch.from_numpy(tf)[None], _nchw(img[None]), PC_MIN, PIX))[0]
    if "half_pixel" in name:
        np.testing.assert_array_equal(got, want)
        assert not _off_boundary(tf).any()
        return
    keep = _off_boundary(tf).numpy()
    np.testing.assert_array_equal(got[keep], want[keep])
    assert keep.mean() > 0.95, keep.mean()
    if name in ("identity", "integer_shift", "rot90"):
        assert keep.all()  # whole pixels: nothing near a boundary
        assert (got != 0).any(-1).mean() > 0.5  # and most of the image lands
    if name == "identity":
        np.testing.assert_array_equal(got, img)


# ------------------------------------------------------------- the fusion

FUSION_CFG = {"NAME": "DISCO", "COMPRESSED_CHANNELS": 8}
C_BEV = 12


def _fusion_inputs(rng, b=2):
    """NHWC BEVs for the ego and agents 0, 2-5, their poses (agent <- ego)
    and presence (agent 3 absent in the second sample), the early BEV."""
    bev = lambda: rng.normal(0.5, 1.0, (b, GRID, GRID, C_BEV)).astype(np.float32)  # noqa: E731
    se3 = np.tile(np.eye(4, dtype=np.float32), (b, 6, 1, 1))
    for i in range(b):
        for a in (0, 2, 3, 4, 5):
            se3[i, a] = np.linalg.inv(_random_pose(rng)).astype(np.float32)
    present = np.ones((b, 6), bool)
    present[1, 3] = False
    se3[1, 3] = np.eye(4)
    return {"spatial_features_2d": bev(), "bev_img": {a: bev() for a in (0, 2, 3, 4, 5)},
            "se3_from_ego_arr": se3, "agent_present": present, "bev_img_early": bev()}


def _torch_fusion_batch(nb):
    return {"spatial_features_2d": _nchw(nb["spatial_features_2d"]),
            "bev_img": {a: _nchw(v) for a, v in nb["bev_img"].items()},
            "se3_from_ego_arr": torch.from_numpy(nb["se3_from_ego_arr"]),
            "agent_present": torch.from_numpy(nb["agent_present"]),
            "bev_img_early": _nchw(nb["bev_img_early"])}


def _same_sampling(se3, present):
    """The fusion warps each present agent with its inverse pose, which
    ``torch.linalg.inv`` and ``jnp.linalg.inv`` round differently (by about
    2e-6): a pixel whose source coordinate lies that close to a rounding
    boundary could be sampled from another neighbour (the warp test's margin
    rule). The fused BEVs are held to 1e-5 only where both packages' warps
    sample the same source pixel everywhere; a warped coordinate image shows
    which pixel each side samples."""
    yy, xx = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
    code = np.stack([xx, yy, np.ones_like(xx)], -1).astype(np.float32)
    jinv = np.asarray(jnp.linalg.inv(jnp.asarray(se3)))
    tinv = torch.linalg.inv(torch.from_numpy(se3))
    warp = jax.jit(lambda tf, img: jax_warp(tf, img, PC_MIN, PIX))
    for i in range(se3.shape[0]):
        for a in (0, 2, 3, 4, 5):
            if present[i, a]:
                want = np.asarray(warp(jnp.asarray(jinv[i, a]), jnp.asarray(code)))
                got = _nhwc(transform_bev_img(tinv[i, a][None], _nchw(code[None]), PC_MIN, PIX))[0]
                np.testing.assert_array_equal(got, want, err_msg=f"sample {i} agent {a}")


@pytest.fixture(scope="module")
def fusion_pair():
    rng = np.random.default_rng(11)
    nb = _fusion_inputs(rng)
    jmod = JaxFusion(model_cfg=FUSION_CFG, info=JaxInfo(**_info()), num_bev_features=C_BEV)
    jb = jax.tree_util.tree_map(jnp.asarray, nb)
    init = jax.jit(lambda k: jmod.init(k, jb, train=False))(jax.random.PRNGKey(2))
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"], rng)}
    tmod = V2XMidFusionDisco(FUSION_CFG, DatasetInfo(**_info()), C_BEV)
    sd = state_dict_from_jax_variables(
        {"params": {"v2x_mid_fusion": variables["params"]},
         "batch_stats": {"v2x_mid_fusion": variables["batch_stats"]}}, {"V2X_MID_FUSION": FUSION_CFG})
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    return nb, jb, jmod, variables, tmod


def test_fusion_eval_matches_jax(fusion_pair):
    nb, jb, jmod, variables, tmod = fusion_pair
    _same_sampling(nb["se3_from_ego_arr"], nb["agent_present"])
    want = jmod.apply(variables, jb, train=False)
    with torch.no_grad():
        got = tmod.eval()(_torch_fusion_batch(nb))
    np.testing.assert_allclose(_nhwc(got["spatial_features_2d"]),
                               np.asarray(want["spatial_features_2d"]), atol=1e-5, rtol=1e-5)
    assert "distill_loss" not in got and "distill_loss" not in want


def test_fusion_training_matches_jax(fusion_pair):
    nb, jb, jmod, variables, tmod = fusion_pair
    want, upd = jmod.apply(variables, jb, train=True, mutable=["batch_stats"])
    tmod = copy.deepcopy(tmod).train()
    got = tmod(_torch_fusion_batch(nb))
    np.testing.assert_allclose(_nhwc(got["spatial_features_2d"]),
                               np.asarray(want["spatial_features_2d"]), atol=1e-5, rtol=1e-5)
    assert got["distill_loss"].item() == pytest.approx(float(want["distill_loss"]), rel=1e-5)
    after = state_dict_from_jax_variables(
        {"params": {"v2x_mid_fusion": variables["params"]},
         "batch_stats": {"v2x_mid_fusion": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}},
        {"V2X_MID_FUSION": FUSION_CFG})
    tracked = {n: int(m.num_batches_tracked) for n, m in tmod.named_modules() if hasattr(m, "running_var")}
    assert tracked == {"compressor.bn0": 6, "decompressor.bn0": 1, "pixel_weightor.bn1_1": 6,
                       "pixel_weightor.bn1_2": 6}
    for name, value in tmod.state_dict().items():
        if "running" in name:
            err = (value - after[f"v2x_mid_fusion.{name}"]).abs().max().item()
            assert err <= 1e-6, (name, err)
    # the loss reaches the compressor through the warp's gather
    got["distill_loss"].backward()
    assert tmod.compressor.conv0.weight.grad.abs().max() > 0


# --------------------------------------------------------------- the makers

def _maker_cfg():
    return {"VFE": {"NAME": "DynPillarVFE", "NUM_RAW_POINT_FEATURES": 5, "WITH_DISTANCE": False,
                    "USE_ABSLOTE_XYZ": True, "USE_NORM": True, "NUM_FILTERS": [16, 16]},
            "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 16},
            "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1, 1],
                            "LAYER_STRIDES": [2, 2, 2], "NUM_FILTERS": [16, 32, 32],
                            "UPSAMPLE_STRIDES": [0.5, 1, 2], "NUM_UPSAMPLE_FILTERS": [16, 16, 16]}}


def _maker_batch(rng, b=2, n=3000):
    """Merged clouds (B, N, 6) in the ego frame, the last column the agent;
    agent 4 absent in the first sample (no points, identity pose), padding
    rows at the end of the second."""
    pts = np.zeros((b, n, 6), np.float32)
    pts[..., 0:2] = rng.uniform(-50, 50, (b, n, 2))
    pts[..., 2] = rng.uniform(-3, 0, (b, n))
    pts[..., 3:5] = rng.uniform(0, 1, (b, n, 2))
    pts[..., 5] = rng.choice([0, 1, 2, 3, 4, 5], (b, n))
    mask = np.ones((b, n), bool)
    mask[1, -300:] = False
    se3 = np.tile(np.eye(4, dtype=np.float32), (b, 6, 1, 1))
    for i in range(b):
        for a in (0, 2, 3, 4, 5):
            se3[i, a] = _se2(rng.uniform(-np.pi, np.pi), *rng.uniform(-20, 20, 2))
    pts[0, pts[0, :, 5] == 4, 5] = 1.0
    se3[0, 4] = np.eye(4)
    return {"points": pts, "points_mask": mask, "se3_from_ego_arr": se3}


def test_early_maker_matches_jax():
    """The early maker alone, on clouds with padding rows: ``bev_img_early``
    only while the detector trains."""
    role = "bev_maker_early"
    rng = np.random.default_rng(3)
    nb = _maker_batch(rng)
    jb = dict(jax.tree_util.tree_map(jnp.asarray, nb), batch_size=2)
    jmod = JaxBEVMaker(model_cfg=_maker_cfg(), info=JaxInfo(**_info()), role=role)
    init = jax.jit(lambda k: jmod.init(k, jb, train=True))(jax.random.PRNGKey(4))
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"], rng)}
    tmod = BEVMaker(_maker_cfg(), DatasetInfo(**_info()), role)
    sd = state_dict_from_jax_variables(
        {"params": {role: variables["params"]}, "batch_stats": {role: variables["batch_stats"]}},
        {role.upper(): _maker_cfg()})
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tmod.train(False)
    assert "bev_img_early" not in tmod(tb) and "bev_img" not in tmod(tb)
    want = jax.jit(lambda v: jmod.apply(v, jb, train=True))(variables)
    tmod.train()
    assert not any(m.training for m in tmod.modules())  # frozen: eval in a training detector
    got = tmod(tb)["bev_img_early"]
    assert not got.requires_grad and not any(p.requires_grad for p in tmod.parameters())
    np.testing.assert_allclose(_nhwc(got), np.asarray(want["bev_img_early"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("role", ["bev_maker_rsu", "bev_maker_car"])
def test_maker_matches_jax(role, disco_eval):
    """Each agent's ``bev_img`` from the small DiscoNet's eval forward on a
    collated batch, where agent 3 is absent from the second sample (its
    branch there is all sentinels)."""
    want, got = disco_eval["jax"]["bev_img"], disco_eval["port"]["bev_img"]
    agents = [0] if role == "bev_maker_rsu" else [2, 3, 4, 5]
    assert sorted(got) == sorted(int(a) for a in want) == [0, 2, 3, 4, 5]
    for a in agents:
        assert not got[a].requires_grad
        np.testing.assert_allclose(_nhwc(got[a]), np.asarray(want[a]), atol=1e-5, rtol=1e-5,
                                   err_msg=f"agent {a}")


# -------------------------------------------------------------- the dataset

def _disco_cfgs(max_points=4096, extra=()):
    return _model_cfgs(DISCO_CFG, _world(max_points) + DISCO_REDUCED + list(extra))


@pytest.mark.parametrize("previous", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_disco_items_equal_jax(training, previous):
    jcfg, tcfg = _disco_cfgs(extra=["DATA_CONFIG.EXCHANGE_PREVIOUS", str(previous)])
    jds, _, _ = jax_build_dataloader(jcfg.DATA_CONFIG, ["car"], batch_size=2, training=training,
                                     workers=0)
    tds, _, _ = build_dataloader(tcfg.DATA_CONFIG, ["car"], batch_size=2, training=training,
                                 workers=0)
    np.random.seed(7)
    tds.rng = np.random.RandomState(7)
    assert len(jds) == len(tds) > 0
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    for a, b in zip(jitems, titems):
        assert_same(a, b)
    for t in titems:
        assert t["points"].shape[1] == 6 and t["agent_present"].all()
        agents = set(np.unique(t["points"][:, 5]).astype(int))
        assert {1} < agents <= set(range(6)), agents
        assert t["se3_from_ego_arr"].shape == (6, 4, 4)
    assert_same(jds.collate_batch(jitems[:3]), tds.collate_batch(titems[:3]))


# ------------------------------------------------------- the whole network

def _disco_batch():
    """Two collated training items of the tiny world, agent 3 taken out of
    the second (its points masked, its pose the identity, absent)."""
    _, tcfg = _disco_cfgs()
    tds, _, _ = build_dataloader(tcfg.DATA_CONFIG, ["car"], batch_size=2, training=True, workers=0)
    tds.rng = np.random.RandomState(3)
    batch = tds.collate_batch([tds[i] for i in range(2)])
    gone = batch["points"][1, :, 5] == 3
    batch["points_mask"][1, gone] = False
    batch["se3_from_ego_arr"][1, 3] = np.eye(4)
    batch["agent_present"][1, 3] = False
    assert gone.sum() > 0 and batch["points_mask"].sum() > 4000
    return batch


@pytest.fixture(scope="module")
def disco_pair():
    jcfg, tcfg = _disco_cfgs()
    batch = _disco_batch()
    jinfo = JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    jmodel = jax_build_network(jcfg.MODEL, num_class=1, dataset_info=jinfo)
    keys = ("points", "points_mask", "gt_boxes", "se3_from_ego_arr", "agent_present")
    jbatch = dict({k: jnp.asarray(batch[k]) for k in keys}, batch_size=2)
    init = jax.jit(lambda k: jmodel.init(k, jbatch, train=True))(jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"], rng)}
    tmodel = build_network(tcfg.MODEL, 1, DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"]),
                           device="cpu")
    tmodel.load_state_dict(state_dict_from_jax_variables(variables, tcfg.MODEL), strict=True)
    return jcfg, tcfg, batch, jmodel, jbatch, variables, tmodel


def test_full_width_config_builds():
    cfg = cfg_from_yaml_file(DISCO_CFG, CfgDict())
    model = build_network(cfg.MODEL, 1, DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, ["car"]),
                          device="cpu")
    assert model.module_names == ["bev_maker_rsu", "bev_maker_car", "bev_maker_early", "vfe",
                                  "map_to_bev", "backbone_2d", "v2x_mid_fusion", "dense_head"]
    assert model.backbone_2d.num_bev_features == 384
    assert model.v2x_mid_fusion.compressor.conv0.weight.shape == (128, 384, 3, 3)
    assert model.bev_maker_car.backbone_2d.blocks[2][1].weight.shape[0] == 128
    assert model.bev_maker_rsu.backbone_2d.blocks[2][1].weight.shape[0] == 256
    model.train()
    assert not model.bev_maker_car.training and model.v2x_mid_fusion.training


@pytest.fixture(scope="module")
def disco_eval(disco_pair):
    """Both eval forwards of the small DiscoNet, the heatmap's output bias
    raised by 1.5 so that boxes pass the score threshold."""
    _, tcfg, batch, jmodel, jbatch, variables, tmodel = disco_pair
    variables = copy.deepcopy(variables)
    hm_out = variables["params"]["dense_head"]["head_0"]["hm_out"]
    hm_out["bias"] = hm_out["bias"] + np.float32(1.5)
    tmodel = copy.deepcopy(tmodel)
    tmodel.load_state_dict(state_dict_from_jax_variables(variables, tcfg.MODEL), strict=True)
    want = jax.jit(lambda v: {k: jmodel.apply(v, jbatch, train=False)[k]
                              for k in ("final_box_dicts", "bev_img")})(variables)
    with torch.no_grad():
        got = tmodel.eval()(_to_device_batch(batch, "cpu"))
    return {"jax": want, "port": got, "cfg": tcfg}


def test_small_disconet_eval_matches_jax(disco_eval):
    tcfg = disco_eval["cfg"]
    want = disco_eval["jax"]["final_box_dicts"]
    got = disco_eval["port"]["final_box_dicts"]
    thresh = tcfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH
    compared = 0
    for i in range(2):
        jv, tv = np.asarray(want["pred_valid"][i]), got["pred_valid"][i].numpy()
        wo, ws = _kept({"boxes_lidar": np.asarray(want["pred_boxes"][i])[jv],
                        "score": np.asarray(want["pred_scores"][i])[jv]}, thresh)
        go, gs = _kept({"boxes_lidar": got["pred_boxes"][i].numpy()[tv],
                        "score": got["pred_scores"][i].numpy()[tv]}, thresh)
        assert len(wo) == len(go), (ws, gs)
        if not len(wo):
            continue
        match = np.argmin(np.linalg.norm(go[:, None, :3] - wo[None, :, :3], axis=-1), axis=1)
        assert len(set(match.tolist())) == len(match), "matching not 1-1"
        np.testing.assert_allclose(go, wo[match], atol=5e-3, rtol=2e-3)
        np.testing.assert_allclose(gs, ws[match], atol=1e-4, rtol=1e-4)
        compared += len(wo)
    assert compared >= 3, "vacuous comparison"


def _seeded_moments(params, rng):
    mu = jax.tree_util.tree_map(lambda p: rng.normal(0, 1e-2, np.shape(p)).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda m: (m * m + rng.uniform(1e-4, 1e-3, m.shape)).astype(np.float32), mu)
    return mu, nu


@pytest.fixture(scope="module")
def both_steps(disco_pair):
    jcfg, tcfg, batch, jmodel, jbatch, variables, tmodel = disco_pair
    tmodel = copy.deepcopy(tmodel)
    params = variables["params"]
    mu, nu = _seeded_moments(params, np.random.default_rng(17))
    tx, _ = jax_build_optimizer(jcfg.OPTIMIZATION, ITERS, EPOCHS)
    opt_state = with_fields(tx.init(params), count=np.int32(STEP), mu=mu, nu=nu)
    jstate = JaxTrainState(params=params, batch_stats=variables["batch_stats"], opt_state=opt_state,
                           step=STEP, rng=jax.random.PRNGKey(0))
    new_state, jloss, jtb = jax_make_train_step(jmodel, tx, donate=False)(jstate, jbatch)
    jafter = {"params": jax.tree_util.tree_map(np.asarray, new_state.params),
              "batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)}
    # the clipped gradient the JAX step applied, read back from its first
    # moment: mu' = b1 mu + (1 - b1) g, b1 scheduled
    opt = jcfg.OPTIMIZATION
    _, mom_fn = jax_one_cycle_fns(ITERS * EPOCHS, float(opt.LR), [float(m) for m in opt.MOMS],
                                  float(opt.DIV_FACTOR), float(opt.PCT_START))
    b1 = float(np.float32(mom_fn(STEP)))
    new_mu = _moment(new_state.opt_state, "mu")
    jgrad = jax.tree_util.tree_map(
        lambda m1, m0: (np.asarray(m1, np.float64) - b1 * np.asarray(m0, np.float64)) / (1.0 - b1), new_mu, mu)

    def port_optimizer(model):
        optimizer, _ = build_optimizer(tcfg.OPTIMIZATION, model, ITERS, EPOCHS)
        optimizer.param_groups[0]["count"] = STEP
        tmu, tnu = tensors_from_jax_params(mu, tcfg.MODEL), tensors_from_jax_params(nu, tcfg.MODEL)
        for name, param in model.named_parameters():
            if param.requires_grad:
                optimizer.state[param] = {"mu": tmu[name].clone(), "nu": tnu[name].clone()}
        return optimizer

    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    # the port's optimizer fed the JAX step's gradient
    fed = copy.deepcopy(tmodel)
    optimizer = port_optimizer(fed)
    tgrad = tensors_from_jax_params(jgrad, tcfg.MODEL)
    for name, param in fed.named_parameters():
        if param.requires_grad:
            param.grad = tgrad[name].float()
    optimizer.step()
    # the port's own step, and its gradient against a float64 run of it
    optimizer = port_optimizer(tmodel)
    tmodel.train()
    out = tmodel(_to_device_batch(batch, "cpu"))
    out["loss"].backward()
    grads = {n: p.grad.clone() for n, p in tmodel.named_parameters() if p.grad is not None}
    optimizer.step()  # clips the gradients in place, as the JAX step clips its own
    clipped = {n: p.grad.clone() for n, p in tmodel.named_parameters() if p.grad is not None}
    model64 = copy.deepcopy(tmodel).double()
    model64.load_state_dict({k: v.double() if v.is_floating_point() else v
                             for k, v in before.items()})
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in _to_device_batch(batch, "cpu").items()}
    model64(b64)["loss"].backward()
    grads64 = {n: p.grad for n, p in model64.named_parameters() if p.grad is not None}
    return {"jax": (float(jloss), {k: float(v) for k, v in jtb.items()}, jafter),
            "port": (out["loss"].item(), {k: v.item() for k, v in out["tb_dict"].items()},
                     tmodel.state_dict()),
            "fed": fed.state_dict(), "grads": (grads, grads64, clipped, tgrad),
            "variables": variables, "before": before, "cfg": tcfg.MODEL}


@pytest.fixture(scope="module")
def eager_vfe_grad(disco_pair):
    """The JAX package's gradient of the training loss in the ego VFE's
    parameters, taken eagerly (its jitted one disagrees with the eager one
    and with central differences, ROADMAP C): the makers and the network
    after the VFE run jitted, the latter giving the cotangent on the VFE's
    output; the VFE itself is differentiated without ``jax.jit``. Returns
    (the gradient as port tensors, the loss the jitted tail read)."""
    jcfg, tcfg, _, jmodel, jbatch, variables, _ = disco_pair
    names = [m.name for m in jmodel.bind(variables).module_list]
    at = names.index("vfe")

    def run(d, lo, hi):
        bound = jmodel.bind(variables, mutable=["batch_stats"])
        d = dict(d, batch_size=2)
        for module in bound.module_list[lo:hi]:
            d = module(d, train=True)
        return bound, {k: v for k, v in d.items() if k != "batch_size"}

    @jax.jit
    def head_of(d):
        d = run(d, 0, at)[1]
        return d, run(d, at, at + 1)[1]

    before_vfe, vfe = head_of({k: v for k, v in jbatch.items() if k != "batch_size"})

    def tail(pf):
        bound, d = run(dict(vfe, pillar_features=pf), at + 1, len(names))
        head_loss = bound.module_list[-1].get_loss(d["head_preds"], d["head_targets"])[0]
        return head_loss + d["distill_loss"]

    pf = vfe["pillar_features"]
    loss, cotangent = jax.jit(jax.value_and_grad(tail))(pf)
    jvfe = jax_build_vfe(jcfg.MODEL.VFE, JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES))

    def vfe_out(params):
        out, _ = jvfe.apply({"params": params, "batch_stats": variables["batch_stats"]["vfe"]},
                            dict(before_vfe, batch_size=2), train=True, mutable=["batch_stats"])
        return jnp.sum(out["pillar_features"] * cotangent)

    grad = jax.tree_util.tree_map(np.asarray, jax.grad(vfe_out)(variables["params"]["vfe"]))  # eager
    tensors = tensors_from_jax_params(dict(variables["params"], vfe=grad), tcfg.MODEL)
    return {k: v for k, v in tensors.items() if k.startswith("vfe.")}, float(loss)


def _moment(opt_state, field):
    if hasattr(opt_state, "_fields"):
        if field in opt_state._fields:
            return getattr(opt_state, field)
        found = [_moment(x, field) for x in opt_state]
    elif isinstance(opt_state, tuple):
        found = [_moment(x, field) for x in opt_state]
    else:
        return None
    found = [f for f in found if f is not None]
    return found[0] if found else None


def test_small_disconet_step_loss_terms_match_jitted_jax(both_steps):
    jloss, jtb, _ = both_steps["jax"]
    tloss, ttb, _ = both_steps["port"]
    assert set(ttb) == set(jtb) and "distill_loss" in ttb and ttb["distill_loss"] > 0
    assert tloss == pytest.approx(jloss, rel=1e-4)
    for key, value in jtb.items():
        assert ttb[key] == pytest.approx(value, rel=1e-4, abs=1e-7), key


def test_small_disconet_step_parameters_match_jitted_jax(both_steps):
    """After one step: the running statistics within 1e-6 of the JAX step's;
    every trainable leaf within 1e-6 where the port's optimizer applies the
    JAX step's gradient; every trainable leaf outside the VFE after the
    port's own step within STEP_SHARE of that leaf's largest move of the JAX
    step's (the two gradients differ by the JAX package's float32 rounding,
    which Adam carries into the leaf); the makers bitwise unchanged on both
    sides. The gradients themselves: the port's float32 one within
    GRAD_RTOL64 of each leaf's largest |g| of a float64 run of the port, and
    within GRAD_RTOL_JAX of the JAX package's jitted one, whose float32
    rounding is the coarser (seen up to 1.0% of a leaf's largest |g| against
    the float64 run outside the VFE, the port's 0.06%; in the VFE the port's
    reaches 0.8%). The ego VFE's jitted JAX gradient disagrees with the eager
    one and with central differences (ROADMAP C): the VFE's leaves are held
    to the eager gradient in the next test, and not to the JAX step."""
    _, _, jafter = both_steps["jax"]
    _, _, got = both_steps["port"]
    want = state_dict_from_jax_variables(jafter, both_steps["cfg"])
    fed, before = both_steps["fed"], both_steps["before"]
    stats = trainable = 0
    for name, value in got.items():
        if not value.is_floating_point():
            continue
        if "running" in name:
            err = (value - want[name]).abs().max().item()
            assert err <= 1e-6, (name, err)
            stats += 1
        elif not name.startswith("bev_maker"):
            err = (fed[name] - want[name]).abs().max().item()
            assert err <= 1e-6, (name, err)
            assert (value - before[name]).abs().max().item() > 2e-5, name  # the step moved it
            if not name.startswith("vfe."):
                err = (value - want[name]).abs().max().item()
                assert err <= STEP_SHARE * (want[name] - before[name]).abs().max().item(), (name, err)
            trainable += 1
    assert stats > 20 and trainable > 60
    grads, grads64, clipped, jgrads = both_steps["grads"]
    for name, g in grads.items():
        scale = grads64[name].abs().max().item()
        if scale < 1e-4:  # a conv bias before a BN: 0 in exact arithmetic
            continue
        assert (g.double() - grads64[name]).abs().max().item() <= GRAD_RTOL64 * scale, name
        if not name.startswith("vfe."):
            scale = jgrads[name].abs().max().item()
            err = (clipped[name].double() - jgrads[name]).abs().max().item()
            assert err <= GRAD_RTOL_JAX * scale, (name, err / scale)
    makers = [k for k in got if k.startswith("bev_maker")]
    assert len(makers) > 60 and not any(k.startswith("bev_maker") for k in grads)
    for name in makers:
        assert torch.equal(got[name], before[name]), name
    for coll in ("params", "batch_stats"):
        for role in ("bev_maker_rsu", "bev_maker_car", "bev_maker_early"):
            for x, y in zip(jax.tree_util.tree_leaves(jafter[coll][role]),
                            jax.tree_util.tree_leaves(both_steps["variables"][coll][role])):
                assert np.array_equal(x, y), (coll, role)


def test_small_disconet_vfe_gradient_matches_eager_jax(both_steps, eager_vfe_grad):
    """The port's float32 gradient in the ego VFE's parameters (taken before
    the clip) within GRAD_RTOL_EAGER of each leaf's largest |g| of the JAX
    package's eager gradient of the same loss; the jitted JAX tail that gave
    the cotangent read the JAX step's loss."""
    grads = both_steps["grads"][0]
    want, loss = eager_vfe_grad
    assert loss == pytest.approx(both_steps["jax"][0], rel=1e-5)
    assert len(want) >= 6 and set(want) <= set(grads)
    for name, g in want.items():
        scale = g.abs().max().item()
        assert scale > 1e-2, name
        err = (grads[name].double() - g.double()).abs().max().item()
        assert err <= GRAD_RTOL_EAGER * scale, (name, err / scale)


class _HeldMakers:
    """The JAX model with its makers' statistics held at their trained
    values whatever statistics it is handed. The JAX package's
    ``recalibrate_batch_stats`` runs its passes from an all-zeros and an
    all-ones statistics tree, the frozen makers' statistics too, which their
    eval-mode forward reads: their BEVs, and so the statistics of every BN
    downstream of them (the compressor's agent calls, the weightor, the
    decompressor, the head), come from makers that normalise by zero
    statistics (ROADMAP C). The port's makers read their own statistics;
    held here, the JAX package's algebra is compared on the same inputs."""

    def __init__(self, model, stats):
        self.model, self.stats = model, stats

    def apply(self, variables, *args, **kwargs):
        stats = dict(variables["batch_stats"])
        stats.update({role: self.stats[role] for role in stats if role.startswith("bev_maker")})
        return self.model.apply({"params": variables["params"], "batch_stats": stats}, *args, **kwargs)


def test_recalibration_matches_jax(disco_pair):
    jcfg, tcfg, batch, jmodel, jbatch, variables, tmodel = disco_pair
    tmodel = copy.deepcopy(tmodel)
    _, tcfg_ = _disco_cfgs()
    tds, _, _ = build_dataloader(tcfg_.DATA_CONFIG, ["car"], batch_size=2, training=True, workers=0)
    tds.rng = np.random.RandomState(9)
    assert len(tds) >= 4
    batches = [tds.collate_batch([tds[i], tds[i + 1]]) for i in (0, 2)]
    keys = ("points", "points_mask", "gt_boxes", "se3_from_ego_arr", "agent_present")
    want = jax_recalibrate(_HeldMakers(jmodel, variables["batch_stats"]), variables["params"],
                           variables["batch_stats"], batches,
                           lambda b: dict({k: jnp.asarray(b[k]) for k in keys}, batch_size=2))
    want = state_dict_from_jax_variables(
        {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(np.asarray, want)},
        tcfg.MODEL)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    count = recalibrate_batch_stats(tmodel, batches, lambda b: _to_device_batch(b, "cpu"))
    assert count == 2 and not tmodel.training
    six = ("v2x_mid_fusion.compressor.bn0", "v2x_mid_fusion.pixel_weightor.bn1_1",
           "v2x_mid_fusion.pixel_weightor.bn1_2")
    checked = 0
    for name, value in tmodel.state_dict().items():
        if "running" not in name:
            continue
        if name.startswith("bev_maker"):
            assert torch.equal(value, before[name]), name
            np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
            continue
        if name.rsplit(".", 1)[0] in six:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=SIX_RTOL, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=RECAL_RTOL,
                                       atol=RECAL_ATOL, err_msg=name)
        assert not torch.equal(value, before[name]), name
        checked += 1
    assert checked > 40
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items() if "tracked" in k)


# ------------------------------------------------ the overlay and the CLI

def _single_agent_ckpts(root, tcfg):
    """Port checkpoints of three single-agent detectors at the makers'
    widths, seeded weights and random statistics."""
    from pcp_tpu_torch.train.checkpoint import save_checkpoint
    from pcp_tpu_torch.train.train_state import TrainState

    paths = {}
    info = DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"])
    for seed, key in enumerate(MAKERS, start=1):
        mcfg = CfgDict({k: copy.deepcopy(tcfg.MODEL[k]) for k in ("VFE", "MAP_TO_BEV", "BACKBONE_2D",
                                                                  "DENSE_HEAD")})
        mcfg.update(NAME="CenterPoint", VFE=copy.deepcopy(tcfg.MODEL[key]["VFE"]),
                    BACKBONE_2D=copy.deepcopy(tcfg.MODEL[key]["BACKBONE_2D"]))
        model = build_network(mcfg, 1, info, device="cpu")
        init_weights(model, seed)
        gen = torch.Generator().manual_seed(seed)
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        opt.param_groups[0]["count"] = 0
        paths[key] = save_checkpoint(TrainState(model, opt), root / key.lower(), 1, 0)
    return paths


def test_overlay_then_train_cli(tmp_path):
    sets = _world(2048) + DISCO_REDUCED + ["DATA_CONFIG.SYNTHETIC",
                                           "{'NUM_SCENES': 3, 'KEYFRAMES_PER_SCENE': 2, "
                                           "'NUM_CARS': 6, 'NUM_PEDS': 0, 'WORLD': 'urban'}"]
    _, tcfg = _model_cfgs(DISCO_CFG, sets)
    paths = _single_agent_ckpts(tmp_path, tcfg)

    model = build_network(tcfg.MODEL, 1, DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"]),
                          device="cpu")
    for key, path in paths.items():
        agent = load_params_from_file(path)
        maker_sd = overlay_bev_maker_weights(model, key.lower(), path)
        assert set(maker_sd) == {k for k in agent if k.split(".")[0] in ("vfe", "backbone_2d")}
        for name, value in maker_sd.items():
            assert torch.equal(value, agent[name]), name
    assert not any(p.requires_grad for n, p in model.named_parameters() if "bev_maker" in n)

    argv = ["--cfg_file", DISCO_CFG, "--batch_size", "2", "--workers", "0", "--device", "cpu",
            "--extra_tag", "disco", "--output_root", str(tmp_path), "--num_epochs_to_eval", "0",
            "--precise_bn", "2", "--seed", "1", "--epochs", "1", "--set", *sets]
    for key, path in paths.items():
        argv += [f"MODEL.{key}.CKPT", str(path)]
    out = train_cli.main(argv)
    assert out["steps"] > 0 and np.isfinite(out["losses"]).all()
    assert out["launches"]["bev_scatter_max"] == 0  # the plain version on the CPU
    saved = load_params_from_file(
        tmp_path / "cfgs/v2x_sim_models/v2x_pointpillar_disco/disco/ckpt/checkpoint_epoch_1.pth")
    for key, path in paths.items():
        agent = load_params_from_file(path)
        for name, value in agent.items():
            if name.split(".")[0] in ("vfe", "backbone_2d"):
                assert torch.equal(saved[f"{key.lower()}.{name}"], value), (key, name)


def test_missing_maker_ckpt_keeps_the_seeded_maker(tmp_path):
    """The YAML's own CKPT paths do not exist here: the CLI warns and keeps
    the maker's seeded weights, as the JAX CLI does."""
    from pcp_tpu_torch.utils.common_utils import create_logger

    _, tcfg = _disco_cfgs()
    model = build_network(tcfg.MODEL, 1, DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"]),
                          device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not train_cli.resolve_maker_ckpt(tcfg.MODEL.BEV_MAKER_CAR.CKPT).exists()
    root = train_cli.ROOT_DIR
    assert train_cli.resolve_maker_ckpt("../tools/cfgs") == root / "tools/cfgs"
    assert train_cli.resolve_maker_ckpt("./../tools/cfgs") == root / "tools/cfgs"
    assert train_cli.resolve_maker_ckpt(tmp_path / "a.pth") == tmp_path / "a.pth"
    train_cli.overlay_makers(model, tcfg.MODEL, create_logger(tmp_path / "log.txt"))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert "maker stays random" in (tmp_path / "log.txt").read_text()


# --------------------------------------------- the oracle and the teacher

def _sweep_batch():
    from pcp_tpu.datasets.v2x_sim.source import SyntheticV2XSource
    from pcp_tpu.datasets.v2x_sim.v2x_sim_utils import get_pseudo_sweeps_of_1lidar

    src = SyntheticV2XSource(num_scenes=1, keyframes_per_scene=4, num_cars=8, num_peds=2)
    stuff = get_pseudo_sweeps_of_1lidar(src, src.lidar_token(src.scenes[0], 3, 1), 10, ("car",),
                                        threshold_boxes_by_points=5)
    pts, tf = stuff["points"], stuff["instances_tf"]
    assert tf.shape[0] > 0 and (pts[:, -1] >= 0).sum() > 100
    n_cap, ni_cap = 4096, 32
    batch_pts = np.zeros((2, n_cap, 7), np.float32)
    batch_pts[0, :len(pts)] = pts[:n_cap]
    batch_pts[1, :len(pts)] = pts[:n_cap]
    batch_pts[1, :, 0] += 3.0
    batch_pts[1, ::7, -1] = 40.0  # an instance past the padded Ni: not foreground
    mask = np.zeros((2, n_cap), bool)
    mask[:, :len(pts)] = True
    tf_pad = np.tile(np.eye(4, dtype=np.float32)[None, None, None], (2, ni_cap, 11, 1, 1))
    tf_pad[:, :tf.shape[0]] = tf
    return pts, tf, {"points": batch_pts, "points_mask": mask, "instances_tf": tf_pad}


def test_oracle_corrector_matches_jax():
    from pcp_tpu.datasets.v2x_sim.v2x_sim_utils import correction_numpy

    pts, tf, nb = _sweep_batch()
    want = JaxOracle(model_cfg=JaxCfg({}), info=JaxInfo(**dict(_info(), num_point_features=7))).apply(
        {}, dict(jax.tree_util.tree_map(jnp.asarray, nb), batch_size=2))
    got = OracleCorrector(CfgDict({}))({k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(_np(got["points"]), np.asarray(want["points"]), atol=1e-5, rtol=0)
    fg = pts[:, -1] >= 0
    ref = pts[:, :3].copy()
    ref[fg] = correction_numpy(pts[fg], tf)
    n = min(len(pts), nb["points"].shape[1])
    np.testing.assert_allclose(_np(got["points"])[0, :n, :3], ref[:n], rtol=1e-4, atol=1e-4)
    moved = np.abs(_np(got["points"]) - nb["points"]).max(-1) > 0
    assert moved[0].sum() > 100 and not moved[~nb["points_mask"]].any()
    assert not moved[1, ::7].any()  # instance 40 >= Ni: kept


def test_teacher_matches_jax():
    _, _, nb = _sweep_batch()
    cfg = dict(_maker_cfg(), CORRECTOR={})
    info = dict(_info(), num_point_features=7)
    jmod = JaxTeacher(model_cfg=cfg, info=JaxInfo(**info))
    jb = dict(jax.tree_util.tree_map(jnp.asarray, nb), batch_size=2)
    init = jax.jit(lambda k: jmod.init(k, jb, train=True))(jax.random.PRNGKey(6))
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"], np.random.default_rng(6))}
    want = jax.jit(lambda v: jmod.apply(v, jb, train=True))(variables)
    tmod = Teacher(cfg, DatasetInfo(**info))
    sd = state_dict_from_jax_variables(
        {"params": {"teacher": variables["params"]}, "batch_stats": {"teacher": variables["batch_stats"]}},
        {"TEACHER": cfg})
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tmod.train(False)
    assert "teacher_spatial_features_2d" not in tmod(tb)
    tmod.train()
    got = tmod(tb)["teacher_spatial_features_2d"]
    assert not got.requires_grad and not tmod.training
    np.testing.assert_allclose(_nhwc(got), np.asarray(want["teacher_spatial_features_2d"]),
                               atol=1e-5, rtol=1e-5)


def test_results_table_has_the_disco_rows():
    """``collect_results`` lists DiscoNet's four cells under the JAX
    package's train and eval tags, each of which the JAX package's
    ``results/synvf`` holds, so the table shows its mAP in brackets."""
    from pcp_tpu_torch.workspace import collect_results

    cells = [(cfg, spec) for _, cfg, cols in collect_results.rows("synvf") for spec in cols.values()
             if cfg == "v2x_pointpillar_disco"]
    assert sorted(e for _, (_, e) in cells) == ["disco_async", "disco_sync", "disco_xasync",
                                                "disco_xsync"]
    for cfg, spec in cells:
        assert collect_results.jax_map("synvf", cfg, *spec) is not None, spec


def test_results_table_marks_carried_cells(tmp_path):
    """A cell the run under the output root produced is read from there;
    every other cell is carried over from the export, marked with ``*`` in
    the table and named, with its eval log, below it and in its record."""
    import shutil

    from pcp_tpu_torch.workspace import collect_results

    cell = ("v2x_pointpillar_disco", "synvf_dsync", "disco_sync")
    src = collect_results.cell_dir("synvf", *cell)
    dst = collect_results.eval_dir(tmp_path, *cell)
    dst.mkdir(parents=True)
    shutil.copy2(src / "metrics.json", dst / "metrics.json")
    (dst / "log_eval_run.txt").write_text("")
    lines, out = collect_results.table(tmp_path, "synvf")
    disco = out["mid fusion (DiscoNet, matched train)"]
    assert disco["sync"]["source"] == {"from": "run", "eval_log": "log_eval_run.txt"}
    assert disco["async"]["source"]["from"] == "export"
    car = out["per-agent car detector (own-view GT: not comparable to the rows above)"]["sync"]
    assert car["source"]["dir"] == "results/synvf_torch/v2x_pointpillar_basic_car__synvf__car"
    row = next(l for l in lines if l.startswith("| mid fusion (DiscoNet, matched train)"))
    sync, async_ = row.split("|")[2:4]
    assert "*" not in sync and "*" in async_
    assert any(car["source"]["eval_log"] in l and l.startswith("- per-agent") for l in lines)
