"""SECOND (``v2x_second_{car,rsu,ego}.yaml``): the whole detector against the
JAX package, the weight bridge, and the CLIs.

The configs' structure at a small xy grid with z kept at 40 slices:
12.8 m x 12.8 m at 0.1 x 0.1 x 0.2 m voxels (128 x 128 x 40, 41 slices with
pcdet's extra one), ``MAX_VOXELS`` 600 under the occupied voxels, so that
the VFE and the strided convs of conv2 and conv3 overflow their budgets;
the sparse backbone at its full widths, the 2D backbone one layer a level
at widths 16 and 32, the head's shared conv 16, the car's HunterJr at
hidden width 8 on the 16 x 16 BEV of stride 8. Weights: the port's
``init_weights`` with random BN affine parameters and statistics, the hm
output bias at -1 so that scores straddle SCORE_THRESH; the JAX package
gets them through its own converter (``convert_centerpoint_state_dict``)
plus the sparse backbone's kernels reshaped back to (K * Cin, Cout). The
JAX model is applied eagerly, once per model in a module-scoped fixture
(its jitted SECOND forward takes about a minute to compile on the CPU).
Tolerances:

* the bridge: JAX variables -> ``state_dict_from_jax_variables`` gives the
  port's state dict back bit for bit;
* eval: the VFE's voxel ids and every level's sparse ids equal; the BEV of
  ``HeightCompression`` atol 1e-5; the surviving boxes under the margin rule
  (``utils/box_match.py``);
* training (the batch without ``instances_tf``, so the car's corrector runs
  and blends in training mode without its own loss branch, whose parity
  ``tests/test_torch_sender_train.py`` holds; the JAX side's eager run of
  that branch would double this file's time): the loss and every tb term
  rtol 1e-4; every gradient leaf
  within 1e-2 of its largest |g| (seen 4.9e-3, the ego's first sparse BN
  bias: its gradient sums the rounding of every voxel through the 21 sparse
  convs; the car's corrector amplifies the BEVs' rounding as in
  ``tests/test_torch_sender_train.py``), or, where the port's float32
  gradient lies further than that from its own float64 gradient (same
  voxels), within 3 times that distance: the ego's last sparse BN bias,
  whose gradient is a small remainder of the 2D backbone's BN-cancelled
  sums, reads 3.2e-2 from JAX and 3.2e-2 from float64 on the CPU while
  JAX's float32 lies within 1e-4 of the port's float64; leaves whose
  gradient is 0 in exact arithmetic within 1e-6 of the model's largest
  |g|; the running statistics atol 1e-5.
* The CLIs at that size on the synthetic world (0.2 m voxels over 25.6 m):
  the SECOND car and RSU trained one epoch, both broadcast into
  ``exchange_database_second`` (their default database), the SECOND ego
  trained on its MoDAR rows and evaluated.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfgDict
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.utils.torch_converter import convert_centerpoint_state_dict
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.ops import bev_scatter
from pcp_tpu_torch.tools import test as test_cli
from pcp_tpu_torch.tools import train as train_cli
from pcp_tpu_torch.train.train_state import init_weights
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from pcp_tpu_torch.workspace import v2x_gen_exchange_database as genx
from torch_port_helpers import exact_zero_leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


CFGS = "tools/cfgs/v2x_sim_models"
PC_RANGE = (-6.4, -6.4, -8.0, 6.4, 6.4, 0.0)
B, N = 2, 1024
LIMIT = 41 * 128 * 128


def small_cfg(name):
    mc = copy.deepcopy(dict(cfg_from_yaml_file(f"{CFGS}/{name}.yaml", CfgDict()).MODEL))
    mc["VFE"] = dict(mc["VFE"], MAX_VOXELS=600)
    mc["BACKBONE_2D"] = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1], "LAYER_STRIDES": [1, 2],
                         "NUM_FILTERS": [16, 32], "UPSAMPLE_STRIDES": [1, 2],
                         "NUM_UPSAMPLE_FILTERS": [16, 16]}
    mc["DENSE_HEAD"] = dict(mc["DENSE_HEAD"], SHARED_CONV_CHANNEL=16)
    if "CORRECTOR" in mc:
        mc["CORRECTOR"] = dict(mc["CORRECTOR"], POINT_HEAD_HIDDEN_CHANNELS=[8],
                               OBJ_HEAD_HIDDEN_CHANNELS=[8])
    return mc


def info_kwargs(num_features):
    return dict(class_names=("car",), num_point_features=num_features, point_cloud_range=PC_RANGE,
                voxel_size=(0.1, 0.1, 0.2), grid_size=(128, 128, 40))


def jax_backbone_3d(sd):
    """The port's ``backbone_3d`` tensors as JAX's variables: kernels
    (Cout, kz, ky, kx, Cin) -> (K * Cin, Cout), BNs as flax's."""
    params, stats = {}, {}

    def kernel(key):
        w = sd[f"backbone_3d.{key}.weight"].numpy()
        return w.transpose(1, 2, 3, 4, 0).reshape(-1, w.shape[0])

    def bn(key):
        p = {"scale": sd[f"backbone_3d.{key}.weight"].numpy(),
             "bias": sd[f"backbone_3d.{key}.bias"].numpy()}
        s = {"mean": sd[f"backbone_3d.{key}.running_mean"].numpy(),
             "var": sd[f"backbone_3d.{key}.running_var"].numpy()}
        return p, s

    def single(jax_name, key):
        p, s = bn(f"{key}.1")
        params[jax_name] = {"kernel": kernel(f"{key}.0"), "norm": p}
        stats[jax_name] = {"norm": s}

    def block(jax_name, key):
        params[jax_name], stats[jax_name] = {}, {}
        for i in (1, 2):
            p, s = bn(f"{key}.bn{i}")
            params[jax_name][f"conv{i}"] = {"kernel": kernel(f"{key}.conv{i}"), "norm": p}
            stats[jax_name][f"conv{i}"] = {"norm": s}

    single("conv_input", "conv_input")
    for i in range(2):
        block(f"conv1_{i}", f"conv1.{i}")
    for name in ("conv2", "conv3", "conv4"):
        single(f"{name}_down", f"{name}.0")
        for i in range(2):
            block(f"{name}_{i}", f"{name}.{i + 1}")
    single("conv_out", "conv_out")
    return params, stats


def seeded_pair(name, num_features, seed):
    """(model config, JAX model, JAX variables, the port's CPU model)."""
    mc = small_cfg(name)
    rng = np.random.default_rng(seed)
    tmodel = build_network(CfgDict(mc), 1, DatasetInfo(**info_kwargs(num_features)), device="cpu")
    init_weights(tmodel, seed)
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
        tmodel.dense_head.heads_list[0].hm[-1].bias.fill_(-1.0)
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    # the mean VFE has no parameters; the converter knows the pillar VFE only
    variables = convert_centerpoint_state_dict(
        {k: v.numpy() for k, v in sd.items() if not k.startswith("backbone_3d.")},
        dict(mc, VFE={"NUM_FILTERS": []}))
    variables["params"]["backbone_3d"], variables["batch_stats"]["backbone_3d"] = jax_backbone_3d(sd)
    jmodel = build_jax(JaxCfgDict(mc), num_class=1, dataset_info=JaxInfo(**info_kwargs(num_features)))
    return mc, jmodel, variables, tmodel


def make_batch(rng, num_features):
    """Points over the grid at every height, a padding tail; sender columns
    (intensity, time, sweep, instance) for the car; car gt boxes, padding
    rows among them, and ``instances_tf`` with moving instances."""
    s, ni = 11, 8
    pts = rng.uniform(0, 1, (B, N, num_features)).astype(np.float32)
    pts[..., 0:2] = rng.uniform(-6.3, 6.3, (B, N, 2))
    pts[..., 2] = rng.uniform(-7.9, -0.1, (B, N))
    inst = rng.integers(-1, ni // 2, (B, N))
    sweep = np.where(inst >= 0, rng.integers(0, s, (B, N)), s - 1)
    if num_features == 7:
        pts[..., 4], pts[..., 5], pts[..., 6] = 1.0 - sweep / (s - 1), sweep, inst
    mask = np.ones((B, N), bool)
    mask[:, -100:] = False
    tf = np.tile(np.eye(4, dtype=np.float32)[None, None, None], (B, ni, s, 1, 1))
    for i in range(0, ni // 2, 2):
        tf[:, i, :, 0, 3] = 0.2 * (s - 1 - np.arange(s))
    gt = np.zeros((B, 12, 8), np.float32)
    gt[:, :ni // 2, 0:2] = rng.uniform(-5, 5, (B, ni // 2, 2))
    gt[:, :ni // 2, 2] = -1.0
    gt[:, :ni // 2, 3:6] = [4.2, 1.8, 1.6]
    gt[:, :ni // 2, 6] = rng.uniform(-np.pi, np.pi, (B, ni // 2))
    gt[:, :ni // 2, 7] = 1
    batch = {"points": pts, "points_mask": mask, "gt_boxes": gt}
    if num_features == 7:
        batch["instances_tf"] = tf
    return batch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_both(name, num_features, seed):
    """Eval and one training forward and backward in both packages."""
    mc, jmodel, variables, tmodel = seeded_pair(name, num_features, seed)
    rng = np.random.default_rng(seed + 1)
    # no instances_tf: the car's corrector trains without its own loss
    # branch, whose parity tests/test_torch_sender_train.py holds
    batch = {k: v for k, v in make_batch(rng, num_features).items() if k != "instances_tf"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def loss_fn(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                dict(jb, batch_size=B), train=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], upd["batch_stats"])

    (jloss, (jtb, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    jeval = jmodel.apply(variables, {"points": jb["points"], "points_mask": jb["points_mask"],
                                     "batch_size": B}, train=False)
    with torch.no_grad():
        teval = tmodel({"points": tb["points"], "points_mask": tb["points_mask"]})
    model = copy.deepcopy(tmodel).train()
    out = model(tb)
    out["loss"].backward()
    # the port's own step in float64: how far float32 rounding alone moves
    # each leaf's gradient
    model64 = copy.deepcopy(tmodel).double().train()
    out64 = model64({k: v.double() if v.is_floating_point() else v for k, v in tb.items()})
    out64["loss"].backward()
    assert torch.equal(out64["voxel_ids"], out["voxel_ids"])  # the same voxels in both
    return {"cfg": mc, "variables": variables, "sd": tmodel.state_dict(), "model": model,
            "jeval": jeval, "teval": teval,
            "jax": {"loss": float(jloss), "tb": {k: float(v) for k, v in jtb.items()},
                    "grads": tensors_from_jax_params(_np(jgrads), mc),
                    "state": state_dict_from_jax_variables(
                        {"params": variables["params"], "batch_stats": _np(jstats)}, mc)},
            "torch": {"loss": out["loss"].item(),
                      "tb": {k: v.item() for k, v in out["tb_dict"].items()},
                      "grads": _grads(model), "grads64": _grads(model64),
                      "state": model.state_dict()}}


def _grads(model):
    """Each parameter's gradient, zeros where it got none (JAX's gradient
    of an unused leaf)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in model.named_parameters()}


MODELS = {"car": ("v2x_second_car", 7, 3), "ego": ("v2x_second_ego", 13, 4)}
# the module groups of each model, one gradient and one statistics test each
GROUPS = {"car": ("backbone_3d", "backbone_2d", "corrector", "dense_head"),
          "ego": ("backbone_3d", "backbone_2d", "dense_head")}
MODEL_GROUPS = [(m, g) for m in sorted(MODELS) for g in GROUPS[m]]


@pytest.fixture(scope="module")
def runs():
    """``runs(which)``: :func:`run_both`'s result for the model ``which``,
    made once in the module whichever test asks first."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = dict(run_both(*MODELS[which]), which=which)
        return cache[which]

    return get


@pytest.fixture(params=sorted(MODELS))
def second(request, runs):
    return runs(request.param)


def test_weight_bridge_round_trip(second):
    got = state_dict_from_jax_variables(second["variables"], second["cfg"])
    sd = second["sd"]
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_eval_voxel_and_site_ids_match_jax(second):
    """The VFE's voxel ids and every level's active sites equal JAX's; the
    VFE's budget and at least one strided level's overflow."""
    j, t = second["jeval"], second["teval"]
    np.testing.assert_array_equal(t["voxel_ids"].numpy(), np.asarray(j["voxel_ids"]))
    assert ((np.asarray(j["voxel_ids"]) < LIMIT).sum(1) == 600).all()
    for level, (ids, _, dims, _) in j["multi_scale_3d_features"].items():
        np.testing.assert_array_equal(t["multi_scale_3d_features"][level][0].numpy(),
                                      np.asarray(ids), err_msg=level)
    full = [lv for lv, (ids, _, dims, _) in j["multi_scale_3d_features"].items()
            if lv != "x_conv1" and ((np.asarray(ids) < np.prod(dims)).sum(1) == 600).all()]
    assert full, "no strided level filled its budget"
    np.testing.assert_array_equal(t["encoded_spconv_tensor"][0].numpy(),
                                  np.asarray(j["encoded_spconv_tensor"][0]))


def test_eval_bev_matches_jax(second):
    j, t = second["jeval"], second["teval"]
    np.testing.assert_allclose(t["spatial_features"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(j["spatial_features"]), atol=1e-5, rtol=0)


def test_eval_boxes_match_jax(second):
    j, t = second["jeval"], second["teval"]
    pp = second["cfg"]["DENSE_HEAD"]["POST_PROCESSING"]
    for i in range(B):
        heat = 1.0 / (1.0 + np.exp(-np.asarray(j["head_preds"][0]["hm"][i]).astype(np.float64)))
        matched = match_surviving_boxes(
            {k: v[i].numpy() for k, v in t["final_box_dicts"].items()},
            {k: np.asarray(v[i]) for k, v in j["final_box_dicts"].items()}, heat.reshape(-1),
            top_k=pp["MAX_OBJ_PER_SAMPLE"], score_thresh=pp["SCORE_THRESH"],
            post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"])
        assert matched >= 3


def test_train_loss_and_tb_match_jax(second):
    j, t = second["jax"], second["torch"]
    assert set(t["tb"]) == set(j["tb"]) and "rpn_loss" in t["tb"]
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
    for key, value in j["tb"].items():
        assert t["tb"][key] == pytest.approx(value, rel=1e-4, abs=1e-7), key


@pytest.mark.parametrize("which,group", MODEL_GROUPS)
def test_train_gradients_match_jax(runs, which, group):
    second = runs(which)
    want, got = second["jax"]["grads"], second["torch"]["grads"]
    assert set(got) == set(want)
    names = [n for n in got if n.startswith(group + ".")]
    assert names
    top = max(v.abs().max().item() for v in want.values())
    zero = exact_zero_leaves(second["model"])
    for name in names:
        g, w = got[name], want[name]
        if name in zero:
            assert g.abs().max().item() <= 1e-6 * top and w.abs().max().item() <= 1e-6 * top, name
            continue
        scale = w.abs().max().item()
        if scale == 0:  # a leaf this step does not reach (the car's object head)
            assert not g.any(), name
            continue
        rounding = (g.double() - second["torch"]["grads64"][name]).abs().max().item() / scale
        err = (g - w).abs().max().item() / scale
        assert err <= max(1e-2, 3 * rounding), (name, err, rounding)


@pytest.mark.parametrize("which,group", MODEL_GROUPS)
def test_running_statistics_match_jax(runs, which, group):
    second = runs(which)
    names = [n for n in second["torch"]["state"] if n.startswith(group + ".") and ".running_" in n]
    assert names
    for name in names:
        torch.testing.assert_close(second["torch"]["state"][name], second["jax"]["state"][name],
                                   atol=1e-5, rtol=0, msg=name)


# ------------------------------------------------------------------ the CLIs

SYN = ("{'NUM_SCENES': 2, 'KEYFRAMES_PER_SCENE': 2, 'NUM_CARS': 6, 'NUM_PEDS': 0, "
       "'WORLD': 'urban'}")
PROCESSOR = ("[{'NAME': 'mask_points_and_boxes_outside_range', 'REMOVE_OUTSIDE_BOXES': False}, "
             "{'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {'train': True, 'test': False}}, "
             "{'NAME': 'transform_points_to_voxels_placeholder', 'VOXEL_SIZE': [0.2, 0.2, 0.2]}]")
# DATA_CONFIG pairs: the tiny world at 0.2 m voxels over 25.6 m (128 x 128 x
# 40), its data root under the test's directory
WORLD = ["USE_SYNTHETIC_DATA", "True", "SYNTHETIC", SYN, "MAX_POINTS_PER_SAMPLE", "2048",
         "MINI_TRAINVAL_STRIDE", "1", "DATASET_DOWNSAMPLING_RATIO", "1",
         "POINT_CLOUD_RANGE", "[-12.8, -12.8, -8.0, 12.8, 12.8, 0.0]", "DATA_PROCESSOR", PROCESSOR]


def test_cli_senders_exchange_and_ego(tmp_path):
    """The full-width SECOND car and RSU trained one epoch through the train
    CLI; each checkpoint, its hm bias raised by 3 so that boxes pass the
    score threshold, broadcast by the generator into its default database
    ``exchange_database_second`` under the data root; the SECOND ego's items
    carry MoDAR rows from there; the ego trained one epoch and evaluated
    through the test CLI. Finite losses and metrics; no kernel launched on
    the CPU."""
    from pcp_tpu_torch.datasets import build_dataloader

    root = tmp_path / "data"
    world = WORLD + ["DATA_PATH", str(root)]
    data_sets = [f"DATA_CONFIG.{v}" if i % 2 == 0 else v for i, v in enumerate(world)]
    base = ["--batch_size", "2", "--workers", "0", "--device", "cpu", "--output_root",
            str(tmp_path), "--extra_tag", "cli"]
    once = ["--epochs", "1", "--num_epochs_to_eval", "0", "--precise_bn", "0"]
    run = tmp_path / "cfgs/v2x_sim_models"
    for agent in ("car", "rsu"):
        cfg = f"v2x_second_{agent}"
        out = train_cli.main(["--cfg_file", f"{CFGS}/{cfg}.yaml", *base, *once, "--seed", "1",
                              "--set", *data_sets])
        assert out["steps"] > 0 and np.isfinite(out["losses"]).all()
        assert not any(out["launches"].values())
        ckpt = run / cfg / "cli/ckpt/checkpoint_epoch_1.pth"
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        state["model_state"]["dense_head.heads_list.0.hm.1.bias"] += 3.0
        torch.save({"model_state": state["model_state"]}, tmp_path / f"{agent}.pth")
        written = genx.main(["--agent", f"second_{agent}", "--ckpt", str(tmp_path / f"{agent}.pth"),
                             "--synthetic", "--device", "cpu", "--workers", "0", "--set", *world])
        assert written["train"] > 0 and written["test"] > 0
    assert list(root.glob("*/exchange_database_second/*_boxflow.npz"))  # under the data root

    ego = f"{CFGS}/v2x_second_ego.yaml"
    ego_cfg = train_cli.load_cfg(train_cli.parse_args(["--cfg_file", ego, *base, "--set",
                                                       *data_sets]))[0]
    assert ego_cfg.DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY == "exchange_database_second"
    ds, _, _ = build_dataloader(ego_cfg.DATA_CONFIG, ["car"], batch_size=1, training=False,
                                workers=0)
    rows = sum(n for i in range(len(ds)) for _, n in ds[i]["metadata"]["exchange"].values())
    assert rows > 0, "the ego read no MoDAR row from exchange_database_second"
    out = train_cli.main(["--cfg_file", ego, *base, *once, "--seed", "2", "--set", *data_sets])
    assert out["steps"] > 0 and np.isfinite(out["losses"]).all()
    bev_scatter.reset_launches()
    metrics = test_cli.main(["--cfg_file", ego, *base, "--ckpt",
                             str(run / "v2x_second_ego/cli/ckpt/checkpoint_epoch_1.pth"),
                             "--set", *data_sets])
    assert np.isfinite(metrics["mAP"]) and not any(bev_scatter.launches.values())


# ------------------------------------------------------------ data parallel

DP_TOL = 1e-10


def test_float64_step_under_two_ranks_equals_one_process():
    """The anchor car (its loss over the global batch: the per-sample
    normalisers need no collective, ``/ batch_size`` is the global batch's)
    and the SECOND car (``MaskedBatchNorm``'s global statistics over the
    valid voxels of every rank) in one float64 train step on two gloo ranks
    of one sample each, against one process on both: loss, every tb term,
    gradients (over each leaf's largest |g|; the leaves whose gradient is 0
    in exact arithmetic over the model's largest), running statistics, all
    within 1e-10; the ranks' states after the step bitwise equal."""
    import tempfile
    from pathlib import Path

    from test_torch_anchor import ANCHOR_CFG
    from torch_dp_ranks import WORLD, build, model_step, senders_rank, spawn_ranks
    from torch_port_helpers import OPTIM, make_train_batch
    from torch_port_helpers import info_kwargs as pillar_info

    rng = np.random.default_rng(21)
    pts, mask, gt = make_train_batch(rng)
    anchor_batch = {"points": torch.from_numpy(pts[..., :7].copy()),
                    "points_mask": torch.from_numpy(mask), "gt_boxes": torch.from_numpy(gt)}
    second_batch = {k: torch.from_numpy(v) for k, v in make_batch(rng, 7).items()}
    steps = {"anchor": (ANCHOR_CFG, pillar_info(7), anchor_batch, torch.float64),
             "second": (small_cfg("v2x_second_car"), info_kwargs(7), second_batch, torch.float64)}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    one = {name: model_step(cfg, info, OPTIM, 5, batch, dtype)
           for name, (cfg, info, batch, dtype) in steps.items()}
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(senders_rank, (tmp, {"primitives": {}, "steps": steps, "recal": {}}, OPTIM, 5))
        ranks = [torch.load(Path(tmp) / f"senders{r}.pt", weights_only=False) for r in range(WORLD)]
    torch.set_num_threads(threads)
    for name, (cfg, info, _, _) in steps.items():
        want, zero = one[name], exact_zero_leaves(build(cfg, info))
        top = max(g.abs().max().item() for g in want["grads"].values())
        assert any(k.startswith("backbone_3d." if name == "second" else "dense_head.conv_")
                   for k in want["grads"])
        for r in ranks:
            got = r[name]
            assert got["loss"] == pytest.approx(want["loss"], rel=DP_TOL)
            assert got["tb"].keys() == want["tb"].keys()
            for k, v in want["tb"].items():
                assert got["tb"][k] == pytest.approx(v, rel=DP_TOL, abs=DP_TOL), (name, k)
            for k, g in want["grads"].items():
                scale = top if k in zero else g.abs().max().item()
                assert (got["grads"][k] - g).abs().max().item() <= DP_TOL * max(scale, 1e-30), k
            for k, v in want["state"].items():
                if "running_" in k:
                    torch.testing.assert_close(got["state"][k], v, atol=DP_TOL, rtol=0, msg=k)
        for k in want["state"]:
            assert torch.equal(ranks[0][name]["state"][k], ranks[1][name]["state"][k]), k


def test_entry_builds_the_new_configs():
    """``entry.build`` makes each new config's model on the CPU when asked,
    with the module list of its family, and defaults to the card (raising
    where there is none, as here); what stays refused names its ROADMAP
    item: BF16, FOLD_BN and W_PACK on these models (A11.1b), UNetV2 and
    Conv2DCollapse (A11.6), the ATSS assigner and AnchorHeadMulti (A11.4),
    other NMS types and MULTI_CLASSES_NMS (A11.3)."""
    from pcp_tpu_torch import entry

    for path, modules in ((entry.CFG_ANCHOR_CAR, ["vfe", "map_to_bev", "backbone_2d", "dense_head"]),
                          (entry.CFG_SECOND_CAR, ["vfe", "backbone_3d", "map_to_bev", "backbone_2d",
                                                  "corrector", "dense_head"]),
                          (entry.CFG_SECOND_RSU, ["vfe", "backbone_3d", "map_to_bev", "backbone_2d",
                                                  "corrector", "dense_head"]),
                          (entry.CFG_SECOND_EGO, ["vfe", "backbone_3d", "map_to_bev", "backbone_2d",
                                                  "dense_head"])):
        _, info, model = entry.build(path, device="cpu")
        assert model.module_names == modules, path
        assert next(model.parameters()).device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry.build(path)
    _, info, model = entry.build(entry.CFG_SECOND_EGO, device="cpu")
    assert info.grid_size == (1024, 1024, 40) and model.backbone_3d.conv_input[0].weight.shape == (
        16, 3, 3, 3, 11)
    for sets, item in ((["MODEL.BF16", "True"], "A11.1b"),
                       (["MODEL.BACKBONE_2D.FOLD_BN", "True"], "A11.1b"),
                       (["MODEL.BACKBONE_3D.NAME", "UNetV2"], "A11.6"),
                       (["MODEL.MAP_TO_BEV.NAME", "Conv2DCollapse"], "A11.6")):
        with pytest.raises(NotImplementedError, match=item):
            entry.build(entry.CFG_SECOND_CAR, device="cpu", set_cfgs=sets)
    for sets, item in ((["MODEL.BF16", "True"], "A11.1b"),
                       (["MODEL.BACKBONE_2D.W_PACK", "True"], "A11.1b"),
                       (["MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NAME", "ATSSTargetAssigner"],
                        "A11.4"),
                       (["MODEL.DENSE_HEAD.NAME", "AnchorHeadMulti"], "A11.4")):
        with pytest.raises(NotImplementedError, match=item):
            entry.build(entry.CFG_ANCHOR_CAR, device="cpu", set_cfgs=sets)
    from pcp_tpu_torch.models.detectors.pointpillar import generic_post_processing

    cfg, _, _ = entry.build(entry.CFG_ANCHOR_CAR, device="cpu")
    preds = {"batch_cls_preds": torch.zeros(1, 8, 1), "batch_box_preds": torch.ones(1, 8, 7)}
    for key, value in (("NMS_TYPE", "circle_nms"), ("MULTI_CLASSES_NMS", True)):
        model_cfg = copy.deepcopy(cfg.MODEL)
        model_cfg.POST_PROCESSING.NMS_CONFIG[key] = value
        with pytest.raises(NotImplementedError, match="A11.3"):
            generic_post_processing(model_cfg, preds)
