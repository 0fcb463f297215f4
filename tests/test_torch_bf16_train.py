"""BF16 training (``MODEL.BF16``) of the port against the JAX package's.

Under ``MODEL.BF16`` the JAX package builds the backbone and the head with
flax's ``dtype=bfloat16``: convs in bfloat16 from float32 parameters, BNs
taking float32 batch statistics from the bfloat16 input and normalising in
float32, and flax differentiates that through the casts. The port trains the
same way (``models/model_utils/norm.py``, ``precision.py``), its batch
variance two-pass where flax's is E[x^2] - E[x]^2. Tolerances, measured on
this CPU and then set with margin:

* one conv-BN-ReLU block and one transposed-conv-BN-ReLU block of the
  backbone, training mode, the same float32 input, weights and cotangent:
  the bfloat16 output within one bfloat16 ulp of its values, 2^-6 (conv
  seen equal, deconv 0.0156 in a few entries, mean 1.3e-6), running
  statistics atol 1e-6 (seen 6e-8), each gradient (kernel, BN scale and
  bias, the input) within 2e-2 of its largest |g| (seen 7.4e-3: the
  kernel's gradient is a bfloat16 conv's output); parameter gradients
  float32;
* the whole small ego (tests/torch_port_helpers.py) and the small car
  (``CAR_CFG``, its HunterJr corrector float32 as in JAX) in one training
  step from the same weights and batch, the JAX side jitted: loss and every
  tb term rtol 5e-3 (seen 5.2e-4 and 9.1e-4 for the ego, 7.3e-4 and 1.8e-3
  for the car); running statistics atol 5e-4 (seen 6.2e-5, the car
  3.4e-4); the BEV's cotangent at the VFE's output within 0.5 of its
  largest |g| (seen 0.27, the car 0.29); every parameter gradient of the
  backbone, the head and the corrector within a factor 1.5 of JAX's in
  norm, so that a leaf whose gradient was lost reads 0 (seen 0.94-1.07, the
  car 0.86-1.20); over all those leaves an L2 error under 0.25 for the ego
  (seen 0.13) and 0.4 for the car (seen 0.27); the ego's leaves also each
  within 0.5 of their largest |g| (seen up to 0.33; the car's reach 0.78).
  The two packages round the network's activations to bfloat16 at the same
  places but their convolutions accumulate in other orders, so one
  bfloat16 ulp here and there grows through the layers; each package's
  BF16 gradient lies about as far from its float32 gradient as from the
  other's (the ego's float32 gradient: L2 0.13 from JAX's BF16, the car's
  0.32), so these comparisons hold the gradient's size and direction, and
  the engaged check below that the step is BF16. The leaves whose gradient
  is 0 in exact arithmetic (``exact_zero_leaves``) are left out. The
  biases of the head's last convs are held against the port's float32 step
  instead, within the same 0.5 (seen 1.3e-2): JAX sums their gradient over
  every pixel in bfloat16 (the ego's hm bias: 0.36 of its value from
  float32), the port accumulates that sum in float32 and rounds it once.
  The VFE runs in float32: the ego's leaves, given the JAX side's
  cotangent at its output, within 0.5 of the port's own (seen 0.20) and
  the factor 1.5 in norm (seen 0.87-1.17);
* BF16 is engaged: the backbone's and head's gradient lies at least 1e-3
  in L2 from the float32 step's (seen 0.14, the car 0.30);
* the parameters, the optimizer's moments and the running statistics stay
  float32 through a step, and ``W_PACK`` or ``FOLD_BN`` training raises;
* the train CLI under ``--set MODEL.BF16 True`` trains the reduced ego and
  saves float32 weights.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pcp_tpu.config import CfgDict
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.backbones_2d.base_bev_backbone import ConvBNReLU, DeConvBNReLU
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.models import build_network as build_torch
from pcp_tpu_torch.models.model_utils.norm import BatchNorm2d
from pcp_tpu_torch.models.model_utils.precision import Conv2d, ConvTranspose2d
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from test_torch_sender_train import _car_case, _torch_batch
from torch_port_helpers import (CAR_FEATURES, MODEL_CFG, NUM_FEATURES, OPTIM, build_pair,
                                exact_zero_leaves, info_kwargs, jax_batch, make_train_batch,
                                torch_batch)

BLOCK_OUT_ATOL, BLOCK_STATS_ATOL, BLOCK_GRAD_SHARE = 2.0 ** -6, 1e-6, 2e-2
LOSS_RTOL, STATS_ATOL, GRAD_SHARE, GRAD_L2 = 5e-3, 5e-4, 0.5, 0.25
GRAD_NORM_FACTOR, CAR_GRAD_L2 = 1.5, 0.4
ENGAGED_L2 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def default_threads():
    """Two torch threads (the test suite runs several processes at once, and
    more threads than cores slow each of them); yields the default count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield threads
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _share(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------- one block

@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_bf16_block_matches_flax(kind):
    rng = np.random.default_rng(0)
    b, c, h, w, f = 2, 8, 16, 16, 16
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    up = 2 if kind == "deconv" else 1
    cot = rng.normal(0, 1, (b, h * up, w * up, f)).astype(np.float32)
    jm = ConvBNReLU(f, dtype=jnp.bfloat16) if kind == "conv" else DeConvBNReLU(f, 2, dtype=jnp.bfloat16)
    params = _np(jm.init(jax.random.PRNGKey(1), x, train=False)["params"])
    params["norm"]["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
    params["norm"]["bias"] = rng.normal(0, 0.3, f).astype(np.float32)
    stats = {"norm": {"mean": np.zeros(f, np.float32), "var": np.ones(f, np.float32)}}

    def apply(p, xx):
        return jm.apply({"params": p, "batch_stats": stats}, xx, train=True, mutable=["batch_stats"])

    # eager, as flax computes it op by op: jitted, XLA may drop a
    # bfloat16 round trip between fused ops
    y, vjp, upd = jax.vjp(apply, params, jnp.asarray(x), has_aux=True)
    gp, gx = vjp(jnp.asarray(cot).astype(y.dtype))
    conv_key = "conv" if kind == "conv" else "deconv"
    kernel = np.asarray(params[conv_key]["kernel"])
    if kind == "conv":
        conv = Conv2d(c, f, 3, padding=1, bias=False, compute_dtype=torch.bfloat16)
        conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    else:  # flax's transposed-conv kernel, flipped (utils/torch_converter.py)
        conv = ConvTranspose2d(c, f, 2, stride=2, bias=False, compute_dtype=torch.bfloat16)
        conv.weight.data = torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    bn = BatchNorm2d(f, eps=1e-3, momentum=0.01, compute_dtype=torch.bfloat16)
    bn.weight.data = torch.from_numpy(params["norm"]["scale"].copy())
    bn.bias.data = torch.from_numpy(params["norm"]["bias"].copy())
    block = nn.Sequential(conv, bn, nn.ReLU()).train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = block(xt)
    assert yt.dtype == torch.bfloat16
    yt.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16))

    got = yt.detach().float().numpy()
    want = np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)
    assert np.abs(got - want).max() <= BLOCK_OUT_ATOL and np.abs(got - want).mean() < 1e-4
    new = upd["batch_stats"]["norm"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), atol=BLOCK_STATS_ATOL, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), atol=BLOCK_STATS_ATOL, rtol=0)
    gk = np.asarray(gp[conv_key]["kernel"])
    gk = gk.transpose(3, 2, 0, 1) if kind == "conv" else gk[::-1, ::-1].transpose(2, 3, 0, 1)
    for got_g, want_g in ((conv.weight.grad, gk), (bn.weight.grad, gp["norm"]["scale"]),
                          (bn.bias.grad, gp["norm"]["bias"]),
                          (xt.grad, np.asarray(gx).transpose(0, 3, 1, 2))):
        assert got_g.dtype == torch.float32
        assert _share(got_g.numpy(), np.asarray(want_g)) <= BLOCK_GRAD_SHARE
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


# ------------------------------------------------------- the whole model

def _bf16(cfg):
    return dict(copy.deepcopy(cfg), BF16=True)


def _ego_case():
    """The small ego's weights (randomised running statistics), its BF16
    config and a two-cloud training batch, in both packages' forms."""
    pts, mask, gt = make_train_batch(np.random.default_rng(7))
    _, variables, f32 = build_pair(seed=3)
    return MODEL_CFG, NUM_FEATURES, variables, jax_batch(pts, mask, gt), torch_batch(pts, mask, gt), f32


def _car_bf16_case():
    cfg, f32, variables, jb = _car_case(False)
    batch = {k: jnp.asarray(v) for k, v in jb.items()}
    batch["batch_size"] = jb["points"].shape[0]
    return cfg, CAR_FEATURES, variables, batch, _torch_batch(jb), f32


def _jax_side(cfg, features, variables, batch, grads=True):
    """The JAX BF16 step, jitted: loss, tb, statistics; with ``grads`` the
    gradients of every module after the VFE and the cotangent at the VFE's
    output (the VFE and the rest compiled apart, one compile each)."""
    jmodel = build_jax(CfgDict(_bf16(cfg)), num_class=1, dataset_info=JaxInfo(**info_kwargs(features)))
    stats = variables["batch_stats"]

    def apply(params, fn, *args):
        return jmodel.apply({"params": params, "batch_stats": stats}, *args, method=fn,
                            mutable=["batch_stats"])

    if not grads:
        out, upd = jax.jit(lambda p: apply(p, lambda m: m(batch, train=True)))(variables["params"])
        loss, tb, new_stats = out["loss"], out["tb_dict"], upd["batch_stats"]
    else:
        def vfe(m):
            d = dict(batch)
            for module in m.module_list[:2]:
                d = module(d, train=True)
            return d["spatial_features"]

        def tail(m, spatial):  # the loss as ``CenterPoint.__call__`` sums it
            d = dict(batch, spatial_features=spatial)
            for module in m.module_list[2:]:
                d = module(d, train=True)
            loss, tb = m.module_list[-1].get_loss(d["head_preds"], d["head_targets"])
            if "corrector_loss" in d:
                tb = dict(tb, corrector_loss=d["corrector_loss"], **d.get("corrector_tb", {}))
                loss = loss + d["corrector_loss"]
            return loss, tb

        spatial, vfe_upd = jax.jit(lambda p: apply(p, vfe))(variables["params"])

        def loss_fn(params, spatial):
            (loss, tb), upd = apply(params, tail, spatial)
            return loss, (tb, upd["batch_stats"])

        (loss, (tb, new_stats)), (g, cot) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(variables["params"], spatial)
        new_stats = dict(new_stats, vfe=vfe_upd["batch_stats"]["vfe"])
    out = {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
           "state": state_dict_from_jax_variables({"params": variables["params"],
                                                   "batch_stats": _np(new_stats)}, cfg)}
    if grads:
        out["grads"] = {k: v for k, v in tensors_from_jax_params(_np(g), cfg).items()
                        if not k.startswith("vfe.")}  # the tail does not reach the VFE
        out["cot"] = torch.from_numpy(np.array(cot)).permute(0, 3, 1, 2)
    return out


def _port_side(cfg, features, f32, batch, grads=True):
    """The port's BF16 step from the weights of ``f32`` (a float32 model),
    the gradient at the VFE's output kept; and the float32 step's
    gradients. Without ``grads``, the training forward alone."""
    model = build_torch(TorchCfgDict(_bf16(cfg)), num_class=1,
                        dataset_info=TorchInfo(**info_kwargs(features)), device="cpu")
    model.load_state_dict(f32.state_dict(), strict=True)
    model.train()
    if not grads:
        out = model(batch)
        return {"loss": out["loss"].item(), "tb": {k: v.item() for k, v in out["tb_dict"].items()},
                "state": model.state_dict(), "model": model,
                "spatial_dtype": out["spatial_features_2d"].dtype}
    ref = copy.deepcopy(f32).train()
    ref(batch)["loss"].backward()
    scatter = model.map_to_bev.forward

    def keep(d):
        out = scatter(d)
        out["spatial_features"].retain_grad()
        keep.spatial = out["spatial_features"]
        return out

    model.map_to_bev.forward = keep
    out = model(batch)
    out["loss"].backward()
    got = {"loss": out["loss"].item(), "tb": {k: v.item() for k, v in out["tb_dict"].items()},
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "f32_grads": {n: p.grad for n, p in ref.named_parameters()},
           "state": {k: v.clone() for k, v in model.state_dict().items()},
           "cot": keep.spatial.grad, "model": model,
           "spatial_dtype": out["spatial_features_2d"].dtype}
    # then the optimizer step on those gradients: what it leaves in float32
    optimizer, _ = build_optimizer(TorchCfgDict(OPTIM), model, total_iters_each_epoch=10,
                                   total_epochs=1)
    optimizer.step()
    moments = [v for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.is_floating_point()]
    got["after_step_dtypes"] = ({p.dtype for p in model.parameters()}, {v.dtype for v in moments},
                                {v.dtype for k, v in model.state_dict().items() if ".running_" in k})
    return got


def _vfe_grads(model, batch, cot):
    """The port's VFE gradients given ``cot`` at its output."""
    model = copy.deepcopy(model).train()
    d = model.map_to_bev(model.vfe(dict(batch)))
    (d["spatial_features"] * cot).sum().backward()
    return {f"vfe.{n}": p.grad for n, p in model.vfe.named_parameters()}


@pytest.fixture(scope="module")
def ego_step():
    cfg, features, variables, jbatch, tbatch, f32 = _ego_case()
    j = _jax_side(cfg, features, variables, jbatch)
    t = _port_side(cfg, features, f32, tbatch)
    t["vfe_from_jax_cot"] = _vfe_grads(t["model"], tbatch, j["cot"])
    return "ego", j, t


@pytest.fixture(scope="module")
def car_step(default_threads):
    """The car's BF16 step on both sides, at the default thread count:
    ``_car_case`` checks its corrector decisions' margins there, as
    tests/test_torch_sender_train.py runs it."""
    torch.set_num_threads(default_threads)
    try:
        cfg, features, variables, jbatch, tbatch, f32 = _car_bf16_case()
        j = _jax_side(cfg, features, variables, jbatch)
        return "car", j, _port_side(cfg, features, f32, tbatch)
    finally:
        torch.set_num_threads(min(default_threads, 2))


@pytest.mark.parametrize("case", ["ego_step", "car_step"])
def test_bf16_loss_and_terms_match_jax(case, request):
    name, j, t = request.getfixturevalue(case)
    assert t["loss"] == pytest.approx(j["loss"], rel=LOSS_RTOL)
    assert set(t["tb"]) == set(j["tb"])
    for key, value in j["tb"].items():
        assert t["tb"][key] == pytest.approx(value, rel=LOSS_RTOL, abs=1e-6), (name, key)
    assert t["spatial_dtype"] == torch.float32


@pytest.mark.parametrize("case", ["ego_step", "car_step"])
def test_bf16_running_statistics_match_jax(case, request):
    name, j, t = request.getfixturevalue(case)
    names = [k for k in t["state"] if ".running_" in k]
    assert any(k.startswith("backbone_2d.") for k in names)
    for k in names:
        assert t["state"][k].dtype == torch.float32
        torch.testing.assert_close(t["state"][k], j["state"][k], atol=STATS_ATOL, rtol=0,
                                   msg=f"{name} {k}")


def test_bf16_car_corrector_stays_float32(car_step):
    """The backbone and head of the BF16 car compute in bfloat16, its
    corrector in float32, as the JAX package builds them."""
    model = car_step[2]["model"]
    dtypes = {name: m.compute_dtype for name, m in model.named_modules()
              if isinstance(m, (Conv2d, BatchNorm2d))}
    assert {d for n, d in dtypes.items() if n.startswith(("backbone_2d.", "dense_head."))} == {
        torch.bfloat16}
    assert {d for n, d in dtypes.items() if n.startswith("corrector.")} == {None}
    assert not any(isinstance(m, Conv2d) and m.compute_dtype for m in model.corrector.modules())


def _output_biases(model):
    """The biases of the BF16 convs that no BN follows: the head's last
    convs."""
    return {f"{name}.bias" for name, m in model.named_modules()
            if isinstance(m, Conv2d) and m.compute_dtype is not None and m.bias is not None
            } - exact_zero_leaves(model)


def _norm_ratio(got, want):
    return float(got.double().norm() / max(float(want.double().norm()), 1e-30))


def _hold_bf16_grads(step, share, l2):
    """Each leaf of the backbone, the head (and the corrector) against JAX
    within ``share`` of its largest |g| (None: not held) and within a
    factor GRAD_NORM_FACTOR in norm, all of them within ``l2`` in L2; the
    head's last conv biases against the port's float32 step; the BEV's
    cotangent; the VFE's leaves given JAX's cotangent, held alike, where
    the step has them (``vfe_from_jax_cot``)."""
    name, j, t = step
    zero, out_biases = exact_zero_leaves(t["model"]), _output_biases(t["model"])
    assert out_biases and all(".heads_list." in n for n in out_biases)
    for n in out_biases:
        assert _share(t["grads"][n].numpy(), t["f32_grads"][n].numpy()) <= GRAD_SHARE, (name, n)
    names = [n for n in j["grads"] if n not in zero | out_biases]
    assert names and all(n.startswith(("backbone_2d.", "dense_head.", "corrector.")) for n in names)
    num = den = 0.0
    for n in names:
        got, want = t["grads"][n], j["grads"][n]
        assert got.dtype == torch.float32 and got.shape == want.shape, n
        assert share is None or _share(got.numpy(), want.numpy()) <= share, (name, n)
        assert 1 / GRAD_NORM_FACTOR <= _norm_ratio(got, want) <= GRAD_NORM_FACTOR, (name, n)
        num += float(((got - want).double() ** 2).sum())
        den += float((want.double() ** 2).sum())
    assert (num / den) ** 0.5 < l2
    assert _share(t["cot"].numpy(), j["cot"].numpy()) <= GRAD_SHARE
    for n, want in t.get("vfe_from_jax_cot", {}).items():
        assert share is None or _share(t["grads"][n].numpy(), want.numpy()) <= share, (name, n)
        assert 1 / GRAD_NORM_FACTOR <= _norm_ratio(t["grads"][n], want) <= GRAD_NORM_FACTOR, (name, n)


def test_bf16_gradients_match_jax(ego_step):
    _hold_bf16_grads(ego_step, GRAD_SHARE, GRAD_L2)


def test_bf16_car_gradients_match_jax(car_step):
    """The car's leaves are held in norm and over all leaves, not one by
    one: its port and JAX BF16 gradients lie up to 0.78 of a leaf's largest
    |g| apart, as far as its float32 gradient lies from JAX's BF16 (0.89).
    Its VFE is not held given JAX's cotangent: the first layer's gradient,
    a sum over every point, comes to 0.54 of the port's own norm there, as
    the two cotangents' bfloat16 roundings (0.29 of the largest entry
    apart) add up differently over the points."""
    _hold_bf16_grads(car_step, None, CAR_GRAD_L2)


@pytest.mark.parametrize("case", ["ego_step", "car_step"])
def test_bf16_engaged(case, request):
    """The BF16 step's gradient is not the float32 step's."""
    _, _, t = request.getfixturevalue(case)
    names = [n for n in t["grads"] if n.startswith(("backbone_2d.", "dense_head."))]
    num = sum(float(((t["grads"][n] - t["f32_grads"][n]).double() ** 2).sum()) for n in names)
    den = sum(float((t["f32_grads"][n].double() ** 2).sum()) for n in names)
    assert (num / den) ** 0.5 > ENGAGED_L2


def _small_bf16(extra=None):
    cfg = _bf16(MODEL_CFG)
    cfg["BACKBONE_2D"].update(extra or {})
    return build_torch(TorchCfgDict(cfg), num_class=1, dataset_info=TorchInfo(**info_kwargs()),
                       device="cpu")


def test_bf16_step_keeps_float32_state(ego_step):
    """After the optimizer step on the BF16 gradients, parameters, moments
    and running statistics are float32."""
    params, moments, stats = ego_step[2]["after_step_dtypes"]
    assert params == moments == stats == {torch.float32}


@pytest.mark.parametrize("mode", ["W_PACK", "FOLD_BN"])
def test_bf16_serving_modes_refuse_training(mode):
    model = _small_bf16({mode: True}).train()
    batch = torch_batch(*make_train_batch(np.random.default_rng(2)))
    with pytest.raises(RuntimeError, match="inference-only"):
        model(batch)


def test_train_cli_bf16_saves_float32(tmp_path):
    """``tools/train.py --set MODEL.BF16 True`` trains the reduced ego one
    epoch on the CPU and saves float32 weights."""
    from test_torch_parallel import _ego_cli_argv

    from pcp_tpu_torch.tools import train as train_cli

    argv = _ego_cli_argv(tmp_path)
    argv[argv.index("--num_epochs_to_eval") + 1] = "0"
    summary = train_cli.main(argv + ["MODEL.BF16", "True"])
    assert summary["steps"] > 0 and np.isfinite(summary["losses"]).all()
    ckpt, = (tmp_path / "cfgs/v2x_sim_models/v2x_pointpillar_basic_ego/dp/ckpt").glob("*.pth")
    state = torch.load(ckpt, map_location="cpu", weights_only=False)["model_state"]
    assert {v.dtype for v in state.values() if v.is_floating_point()} == {torch.float32}
