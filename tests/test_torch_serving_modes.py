"""The port's serving modes against the JAX package's: FOLD_BN, W_PACK, BF16.

FOLD_BN and W_PACK are held on the backbone alone, in the miniatures of
tests/test_bn_fold.py and tests/test_wpack.py, with every BN's parameters and
statistics randomised as those tests do; the port receives the JAX variables
through ``utils/jax_weights.py``. Tolerances are the JAX tests' own: FOLD_BN
rtol/atol 2e-5, W_PACK 1e-5 (kernels and backbone), W_PACK on folded weights
1e-4. The port's transforms of a state dict must equal the bridge of the JAX
transforms' output exactly.

BF16 is held on the backbone and on the small ego
(tests/torch_port_helpers.py). The port's BF16 backbone against the JAX
package's BF16 backbone on the same float32 BEV: plain and W_PACK equal to
the bit on this CPU, held at rtol = atol = 2^-8 (half a bfloat16 ulp of 1);
FOLD_BN at 2^-5, since the port's biased conv rounds once where flax rounds
the conv and then the bias add (measured max 0.0625 on outputs up to 13,
fails at 2^-6); each at least BF16_FLOOR in mean from the float32 backbone
(measured 0.0019-0.0029), so a BF16 mode that stayed float32 fails. The
ego's BF16 forward against the JAX package's BF16 forward on the same
weights and points, and against its own float32 forward, on every head
branch. Measured on this CPU, on the ``hm`` logits: port against JAX max
0.0117, mean 0.00365; port against its float32 max 0.0161, mean 0.00547 (the
other branches are closer). The two BF16 forwards differ about as much as
either differs from float32: the BEV differs at float32 rounding between the
packages, and bfloat16 rounds such inputs apart. Held at max 0.05, mean
0.01, inside tests/test_model_forward.py::TestBF16Mode's own bound (max 0.2,
mean 0.02); against its float32 forward, hm must differ by at least
BF16_FLOOR in mean, and every conv and norm of the backbone and the head
must give bfloat16 while the VFE's give float32.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pcp_tpu.config import CfgDict
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.backbones_2d.base_bev_backbone import BaseBEVBackbone as JaxBackbone
from pcp_tpu.models.backbones_2d.base_bev_backbone import (_pack_kernel, fold_bn_variables,
                                                           w_pack_variables)
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu_torch import bench
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.models import build_network as build_torch
from pcp_tpu_torch.models.backbones_2d.base_bev_backbone import (BaseBEVBackbone,
                                                                 fold_bn_state_dict, pack_kernel,
                                                                 pack_width, unpack_width,
                                                                 w_pack_state_dict)
from pcp_tpu_torch.utils import jax_weights
from torch_port_helpers import MODEL_CFG, build_pair, clustered_points, info_kwargs

FOLD_CFG = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2, 2], "LAYER_STRIDES": [2, 2, 2],
            "NUM_FILTERS": [8, 16, 32], "UPSAMPLE_STRIDES": [0.5, 1, 2],
            "NUM_UPSAMPLE_FILTERS": [16, 16, 16]}
# level 0 narrow (packed), levels 1-2 wide, as tests/test_wpack.py has it
PACK_CFG = {**FOLD_CFG, "LAYER_NUMS": [3, 2, 2], "NUM_FILTERS": [8, 128, 128]}
BF16_BOUND = {"max": 0.05, "mean": 0.01}
BF16_FLOOR = 5e-4  # least mean |BF16 - float32|: BF16 is engaged


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _randomize_bn(variables, rng):
    """Every norm's parameters and statistics non-trivial, by
    tests/test_bn_fold.py's rule: scale and var U(0.25, 2), bias and mean
    U(-0.75, 1)."""
    def rnd(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        if "norm" not in name:
            return x
        r = rng.uniform(0.25, 2.0, size=x.shape).astype(np.float32)
        return jnp.asarray(r - 1.0 if name.endswith(("bias", "mean")) else r)

    return jax.tree_util.tree_map_with_path(rnd, variables)


def _bridge(variables, cfg):
    """The backbone's JAX variables as the standalone port backbone's state
    dict."""
    sd = {}
    v = jax.tree_util.tree_map(np.asarray, variables)
    jax_weights._backbone(sd, v["params"], v.get("batch_stats") or None, cfg)
    return {k[len("backbone_2d."):]: t for k, t in sd.items()}


def _port_backbone(cfg, sd):
    bb = BaseBEVBackbone(TorchCfgDict(cfg), input_channels=8)
    bb.load_state_dict(sd, strict=True)
    return bb.eval()


def _run_port(bb, x):
    with torch.inference_mode():
        y = bb({"spatial_features": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()})
    return y["spatial_features_2d"].permute(0, 2, 3, 1).numpy()


def _run_jax(cfg, variables, x):
    bb = JaxBackbone(model_cfg=cfg, input_channels=8)
    batch = {"spatial_features": jnp.asarray(x), "batch_size": x.shape[0]}
    return np.asarray(bb.apply(variables, batch, train=False)["spatial_features_2d"])


def _init(cfg, x, seed):
    bb = JaxBackbone(model_cfg=cfg, input_channels=8)
    batch = {"spatial_features": jnp.asarray(x), "batch_size": x.shape[0]}
    return bb.init(jax.random.PRNGKey(seed), batch, train=False)


def _equal_state_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].float(), want[k].float()), k


@pytest.fixture(scope="module")
def fold_case():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, size=(2, 32, 32, 8)).astype(np.float32)
    v = _randomize_bn(_init(FOLD_CFG, x, 0), rng)
    return x, v


def test_fold_bn_matches_jax(fold_case):
    x, v = fold_case
    ref = _run_jax(FOLD_CFG, v, x)
    folded_v = fold_bn_variables(v, module_name=None)
    jax_folded = _run_jax({**FOLD_CFG, "FOLD_BN": True}, folded_v, x)
    plain = _port_backbone(FOLD_CFG, _bridge(v, FOLD_CFG))
    folded = _port_backbone({**FOLD_CFG, "FOLD_BN": True},
                            fold_bn_state_dict(plain.state_dict(), FOLD_CFG, prefix=""))
    got = _run_port(folded, x)
    for want in (jax_folded, ref, _run_port(plain, x)):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fold_bn_state_dict_equals_bridge_of_jax_fold(fold_case):
    _, v = fold_case
    got = fold_bn_state_dict(_bridge(v, FOLD_CFG), FOLD_CFG, prefix="")
    _equal_state_dicts(got, _bridge(fold_bn_variables(v, module_name=None), FOLD_CFG))
    assert not any(".running_" in k for k in got)


@pytest.mark.parametrize("strided", [False, True])
def test_pack_kernel_matches_direct_conv(strided):
    """One 3x3 conv (stride 2 where ``strided``) on the packed layout with the
    structured kernel against the plain conv; the kernel equals the bridge
    of the JAX package's."""
    rng = np.random.default_rng(2 if strided else 1)
    ci, co, s = (4, 6, 2) if strided else (4, 4, 1)
    w_hwio = rng.normal(0, 1, size=(3, 3, ci, co)).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    x = torch.from_numpy(rng.normal(0, 1, size=(1, ci, 8, 12)).astype(np.float32))
    ref = F.conv2d(x, w, stride=s, padding=1)
    k = pack_kernel(w, strided=strided)
    got = unpack_width(F.conv2d(pack_width(x), k, stride=s, padding=1))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    want = np.asarray(_pack_kernel(w_hwio, strided=strided)).transpose(3, 2, 0, 1)
    assert torch.equal(k, torch.from_numpy(np.ascontiguousarray(want)))


@pytest.fixture(scope="module")
def pack_case():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, size=(2, 32, 32, 8)).astype(np.float32)
    v = _randomize_bn(_init(PACK_CFG, x, 0), rng)
    return x, v


def test_wpack_backbone_matches_jax(pack_case):
    x, v = pack_case
    packed_cfg = {**PACK_CFG, "W_PACK": True}
    sd = w_pack_state_dict(_bridge(v, PACK_CFG), packed_cfg, prefix="")
    _equal_state_dicts(sd, _bridge(w_pack_variables(v, packed_cfg, module_name=None), PACK_CFG))
    got = _run_port(_port_backbone(packed_cfg, sd), x)
    np.testing.assert_allclose(got, _run_jax(PACK_CFG, v, x), rtol=1e-5, atol=1e-5)


def test_wpack_with_folded_bn_matches_jax(pack_case):
    x, v = pack_case
    both = {**PACK_CFG, "W_PACK": True, "FOLD_BN": True}
    folded = fold_bn_state_dict(_bridge(v, PACK_CFG), PACK_CFG, prefix="")
    got = _run_port(_port_backbone(both, w_pack_state_dict(folded, both, prefix="")), x)
    np.testing.assert_allclose(got, _run_jax(PACK_CFG, v, x), rtol=1e-4, atol=1e-4)


def test_wpack_training_raises():
    bb = BaseBEVBackbone(TorchCfgDict({**PACK_CFG, "W_PACK": True}), input_channels=8).train()
    with pytest.raises(RuntimeError, match="inference-only"):
        bb({"spatial_features": torch.zeros(1, 8, 16, 16)})


def _bf16_cfg():
    cfg = copy.deepcopy(MODEL_CFG)
    cfg["BF16"] = True
    return cfg


@pytest.fixture(scope="module")
def bf16_outputs():
    """Head outputs of the small ego: JAX f32 and BF16, port f32 and BF16, on
    the same weights and points."""
    rng = np.random.default_rng(5)
    pts = clustered_points(rng, 2, 3000)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, -300:] = False
    jmodel, variables, tmodel = build_pair(seed=3)
    jbf = build_jax(CfgDict(_bf16_cfg()), num_class=1, dataset_info=JaxInfo(**info_kwargs()))
    tbf = build_torch(TorchCfgDict(_bf16_cfg()), num_class=1,
                      dataset_info=TorchInfo(**info_kwargs()), device="cpu")
    tbf.load_state_dict(tmodel.state_dict(), strict=True)
    jb = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask), "batch_size": 2}
    tb = {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)}
    out = {}
    for name, m in (("jax_f32", jmodel), ("jax_bf16", jbf)):
        heads = jax.jit(lambda v, p, k: m.apply(v, {"points": p, "points_mask": k,
                                                    "batch_size": 2}, train=False)["head_preds"])
        out[name] = {k: np.asarray(a) for k, a in heads(variables, jb["points"],
                                                        jb["points_mask"])[0].items()}
    dtypes = {}
    for name, mod in tbf.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear,
                            torch.nn.modules.batchnorm._BatchNorm)):
            mod.register_forward_hook(lambda m, i, o, name=name: dtypes.update({name: o.dtype}))
    out["port_bf16_module_dtypes"] = dtypes
    with torch.inference_mode():
        for name, m in (("port_f32", tmodel), ("port_bf16", tbf)):
            res = m(tb)
            out[name] = {k: a.permute(0, 2, 3, 1).numpy() for k, a in res["head_preds"][0].items()}
            out[name + "_dtypes"] = {k: a.dtype for k, a in res["head_preds"][0].items()}
            out[name + "_bev_dtype"] = res["spatial_features_2d"].dtype
    return out


def test_bf16_outputs_are_float32(bf16_outputs):
    assert set(bf16_outputs["port_bf16_dtypes"].values()) == {torch.float32}
    assert bf16_outputs["port_bf16_bev_dtype"] == torch.float32


def test_bf16_engaged(bf16_outputs):
    """BF16 runs: every conv and norm of the backbone and the head gives
    bfloat16, the VFE's float32, and hm moves off the float32 forward's."""
    dtypes = bf16_outputs["port_bf16_module_dtypes"]
    bf16 = {k for k in dtypes if k.startswith(("backbone_2d.", "dense_head."))}
    assert len(bf16) > 10 and {dtypes[k] for k in bf16} == {torch.bfloat16}
    vfe = {k for k in dtypes if k.startswith("vfe.")}
    assert vfe and {dtypes[k] for k in vfe} == {torch.float32}
    err = np.abs(bf16_outputs["port_bf16"]["hm"] - bf16_outputs["port_f32"]["hm"])
    assert err.mean() > BF16_FLOOR, err.mean()


@pytest.mark.parametrize("mode,tol", [("plain", 2.0 ** -8), ("wpack", 2.0 ** -8),
                                      ("fold_bn", 2.0 ** -5)])
def test_bf16_backbone_matches_jax(mode, tol):
    """The port's BF16 backbone against the JAX package's on the same
    float32 BEV and weights (BN randomised), and away from float32."""
    base = PACK_CFG if mode == "wpack" else FOLD_CFG
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, size=(2, 32, 32, 8)).astype(np.float32)
    v = _randomize_bn(_init(base, x, 0), rng)
    cfg = {**base, "BF16": True, "W_PACK": mode == "wpack", "FOLD_BN": mode == "fold_bn"}
    sd = _bridge(v, base)
    f32 = _run_port(_port_backbone(base, sd), x)
    if mode == "fold_bn":
        v, sd = fold_bn_variables(v, module_name=None), fold_bn_state_dict(sd, base, prefix="")
    elif mode == "wpack":
        v, sd = w_pack_variables(v, cfg, module_name=None), w_pack_state_dict(sd, cfg, prefix="")
    got = _run_port(_port_backbone(cfg, sd), x)
    np.testing.assert_allclose(got, _run_jax(cfg, v, x), rtol=tol, atol=tol)
    assert np.abs(got - f32).mean() > BF16_FLOOR


@pytest.mark.parametrize("against", ["jax_bf16", "port_f32"])
@pytest.mark.parametrize("branch", ["hm", "center", "center_z", "dim", "rot"])
def test_bf16_head_within_bound(bf16_outputs, against, branch):
    got, want = bf16_outputs["port_bf16"][branch], bf16_outputs[against][branch]
    err = np.abs(got - want)
    assert err.max() < BF16_BOUND["max"], err.max()
    assert err.mean() < BF16_BOUND["mean"], err.mean()


def test_bf16_training_raises():
    """BF16 trains (tests/test_torch_bf16_train.py holds it against JAX);
    under W_PACK or FOLD_BN, serving forms of trained weights, training
    still raises."""
    pts = clustered_points(np.random.default_rng(0), 1, 256)
    batch = {"points": torch.from_numpy(pts), "points_mask": torch.ones(1, 256, dtype=torch.bool),
             "gt_boxes": torch.zeros(1, 4, 8)}
    model = build_torch(TorchCfgDict(_bf16_cfg()), num_class=1,
                        dataset_info=TorchInfo(**info_kwargs()), device="cpu").train()
    assert torch.isfinite(model(batch)["loss"])
    for mode in ("W_PACK", "FOLD_BN"):
        cfg = _bf16_cfg()
        cfg["BACKBONE_2D"][mode] = True
        model = build_torch(TorchCfgDict(cfg), num_class=1, dataset_info=TorchInfo(**info_kwargs()),
                            device="cpu").train()
        with pytest.raises(RuntimeError, match="inference-only"):
            model(batch)


@pytest.mark.parametrize("flags", [["--fold-bn"], ["--wpack"], ["--fold-bn", "--wpack", "--bf16"],
                                   ["--pre-reduce", "fused", "--ckpt", "none", "--wpack"]])
def test_bench_modes_load_strictly(flags):
    """Each of the bench's modes builds the full-width ego and loads its
    weights, folded and packed at load, with ``strict=True``; the folded
    and packed model's forward pieces are those the flags name."""
    args = bench.parse_args(flags)
    cfg, _, model = bench.load_trained_ego("cpu", args)
    bb = model.backbone_2d
    assert (bb.dtype is torch.bfloat16) == args.bf16
    assert (model.dense_head.dtype is torch.bfloat16) == args.bf16
    assert bb.packed_levels == ({0} if args.wpack else set())
    assert isinstance(bb.blocks[0][2], torch.nn.Identity) == args.fold_bn
    assert (bb.blocks[0][1].bias is not None) == args.fold_bn
    assert bench.modes(args)["pre_reduce"] == args.pre_reduce
