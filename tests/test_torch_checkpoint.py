"""The port's trainer around the step: initial weights, checkpoints both ways,
resume, BN recalibration, the training loop, and the single-batch overfit.

* Initial weights follow the JAX package's distributions (flax's
  lecun_normal, truncated at 2 std): per leaf, the sample std of the port's
  and of the JAX package's init within 4 standard errors of sqrt(1/fan-in),
  every weight inside the truncation bound, the constants equal.
* A checkpoint the port writes (``save_checkpoint``, pcdet's ``.pth``) is
  read by the JAX package's ``load_torch_checkpoint``; its eval forward then
  equals the port's under the tolerances of ``tests/test_torch_centerpoint.py``
  (BEV 2e-4/1e-4, backbone 2e-3/1e-3, head 3e-3/1e-3).
* ``load_checkpoint`` and one step equal two steps without a stop, exactly.
* ``recalibrate_batch_stats`` equals the JAX package's on the two-convention
  net of ``tests/test_bn_recal.py`` (rtol 1e-5).
* The overfit criterion of ``tests/test_train.py``: 25 steps on one batch
  take the full-width ego model's loss under 0.7 of the first.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.train.bn_recal import recalibrate_batch_stats as jax_recalibrate
from pcp_tpu.utils.torch_converter import load_torch_checkpoint
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.config import cfg_from_yaml_file
from pcp_tpu_torch.entry import CFG_EGO
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.models import build_network
from pcp_tpu_torch.models.model_utils.norm import BatchNorm2d, MaskedBatchNorm
from pcp_tpu_torch.train import checkpoint
from pcp_tpu_torch.train.bn_recal import recalibrate_batch_stats
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.train.train_state import (TrainState, create_train_state, init_weights,
                                             make_eval_step, make_train_step)
from pcp_tpu_torch.train.train_utils import train_model
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from test_bn_recal import TwoFlavourNet
from torch_port_helpers import (MODEL_CFG, OPTIM, build_pair, info_kwargs,
                                make_train_batch, torch_batch)

SMALL = TorchCfgDict(MODEL_CFG)


def _small_model():
    return build_network(SMALL, num_class=1, dataset_info=TorchInfo(**info_kwargs()), device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The JAX model and its variables, built once: the port's models of
    this file are fresh ones that load them (:func:`_port_model`)."""
    jmodel, variables, _ = build_pair(seed=3)
    return jmodel, variables


def _port_model(variables):
    model = _small_model()
    model.load_state_dict(state_dict_from_jax_variables(variables, MODEL_CFG), strict=True)
    return model


def _state(model, steps=2):
    optimizer, _ = build_optimizer(TorchCfgDict(OPTIM), model, total_iters_each_epoch=steps,
                                   total_epochs=1)
    return TrainState(model.train(), optimizer)


def test_initial_weights_follow_the_jax_distributions(pair):
    _, variables = pair  # params as the JAX package initialises them
    want = tensors_from_jax_params(variables["params"], MODEL_CFG)
    model = _small_model()
    init_weights(model, seed=1)
    got = model.state_dict()
    again = _small_model()
    init_weights(again, seed=1)
    for name, w in want.items():
        g = got[name]
        assert torch.equal(g, again.state_dict()[name]), name  # a seed gives one weight set
        if name.endswith("weight") and g.dim() > 1:
            deconv = isinstance(model.get_submodule(name[:-len(".weight")]), torch.nn.ConvTranspose2d)
            fan_in = g.shape[0] * g[0, 0].numel() if deconv else g[0].numel()
            bound = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert g.abs().max().item() <= bound * (1 + 1e-6), name
            # the truncated normal has std sqrt(1 / fan_in); both packages'
            # samples within 4 standard errors of a sample std of it
            rel = 4 / (2 * g.numel()) ** 0.5
            assert g.std().item() == pytest.approx(fan_in ** -0.5, rel=rel), name
            assert w.std().item() == pytest.approx(fan_in ** -0.5, rel=rel), name
        else:  # biases and BN affine: constants
            torch.testing.assert_close(g, w, msg=name)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert not m.running_mean.any() and bool((m.running_var == 1).all()), name


def test_checkpoint_written_by_the_port_is_read_by_the_jax_package(tmp_path, pair):
    jmodel, variables = pair
    model = _port_model(variables)
    state = _state(model)
    step = make_train_step(model, state.optimizer)
    batch = torch_batch(*make_train_batch(np.random.default_rng(7)))
    for _ in range(2):
        step(batch)
    path = checkpoint.save_checkpoint(state, tmp_path, epoch=1, it=2)
    assert path.name == "checkpoint_epoch_1.pth"
    loaded = load_torch_checkpoint(str(path), MODEL_CFG)
    assert not np.allclose(loaded["params"]["vfe"]["pfn_0"]["linear"]["kernel"],
                           variables["params"]["vfe"]["pfn_0"]["linear"]["kernel"])  # it trained

    pts, mask = batch["points"].numpy(), batch["points_mask"].numpy()
    jout = jmodel.apply(loaded, {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
                                 "batch_size": 2}, train=False)
    model.eval()
    with torch.inference_mode():
        tout = model({"points": batch["points"], "points_mask": batch["points_mask"]})

    def nhwc(t):
        return t.permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(nhwc(tout["spatial_features"]), np.asarray(jout["spatial_features"]),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(tout["spatial_features_2d"]),
                               np.asarray(jout["spatial_features_2d"]), atol=2e-3, rtol=1e-3)
    for branch, want in jout["head_preds"][0].items():
        np.testing.assert_allclose(nhwc(tout["head_preds"][0][branch]), np.asarray(want),
                                   atol=3e-3, rtol=1e-3, err_msg=branch)
    boxes = make_eval_step(model)({"points": batch["points"], "points_mask": batch["points_mask"]})
    assert boxes["pred_boxes"].shape == (2, 83, 7) and not model.training


def test_resume_equals_an_unbroken_run(tmp_path, pair):
    batch = torch_batch(*make_train_batch(np.random.default_rng(7)))
    model = _port_model(pair[1])
    unbroken = _state(copy.deepcopy(model))
    step = make_train_step(unbroken.model, unbroken.optimizer)
    step(batch)
    step(batch)

    first = _state(copy.deepcopy(model))
    make_train_step(first.model, first.optimizer)(batch)
    path = checkpoint.save_checkpoint(first, tmp_path, epoch=0, it=1)
    other = _small_model()
    resumed = _state(other)
    init_weights(other, seed=9)  # anything: the checkpoint replaces it
    resumed, epoch, it = checkpoint.load_checkpoint(path, resumed)
    assert (epoch, it, resumed.step) == (0, 1, 1)
    make_train_step(resumed.model, resumed.optimizer)(batch)
    assert resumed.step == unbroken.step == 2
    for (name, a), b in zip(unbroken.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(unbroken.optimizer.state.values(), resumed.optimizer.state.values()):
        assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])


def test_rotation_snapshot_and_weights_only_load(tmp_path):
    state = _state(_small_model())
    for epoch in range(1, 5):
        checkpoint.save_checkpoint(state, tmp_path, epoch=epoch, it=0, max_ckpt_save_num=2)
    assert sorted(p.name for p in tmp_path.glob("checkpoint_epoch_*.pth")) == [
        "checkpoint_epoch_3.pth", "checkpoint_epoch_4.pth"]
    assert checkpoint.latest_checkpoint(tmp_path).name == "checkpoint_epoch_4.pth"
    assert checkpoint.latest_checkpoint(tmp_path / "none") is None
    snap = checkpoint.save_latest_snapshot(state, tmp_path, epoch=4, it=7)
    assert snap.name == "latest_model.pth" and len(list(tmp_path.glob("*.pth"))) == 3
    weights = checkpoint.load_params_from_file(snap)
    assert set(weights) == set(state.model.state_dict())


class TwoConventions(torch.nn.Module):
    """The port's counterpart of ``TwoFlavourNet``, plus a BN no forward reaches."""

    def __init__(self):
        super().__init__()
        self.bn_flax = BatchNorm2d(4, eps=1e-5, momentum=0.1)
        self.bn_masked = MaskedBatchNorm(4, eps=1e-3, momentum=0.01)
        self.dead = BatchNorm2d(4)

    def forward(self, batch):
        x = batch["x"]
        return self.bn_flax(x[..., None, None])[..., 0, 0] + self.bn_masked(x, batch["mask"])


def test_bn_recalibration_matches_the_jax_package():
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(3.0 * i, 1.0 + i, size=(16, 4)).astype(np.float32),
                "mask": rng.uniform(size=16) > 0.3} for i in range(5)]
    jnet = TwoFlavourNet()
    variables = jnet.init(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, batches[0]),
                          train=True)
    want = jax_recalibrate(jnet, variables["params"], variables["batch_stats"],
                           [jax.tree_util.tree_map(jnp.asarray, b) for b in batches],
                           to_device=lambda b: b)
    net = TwoConventions().eval()
    with torch.no_grad():
        net.dead.running_mean.fill_(0.5)
    count = recalibrate_batch_stats(net, batches, lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    assert count == 5 and not net.training
    for ours, theirs in (("bn_flax", "bn_flax"), ("bn_masked", "bn_masked")):
        m = getattr(net, ours)
        np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(want[theirs]["mean"]), rtol=1e-5)
        np.testing.assert_allclose(m.running_var.numpy(), np.asarray(want[theirs]["var"]), rtol=1e-5)
    assert net.bn_flax.momentum == 0.1 and net.bn_masked.momentum == 0.01  # put back
    np.testing.assert_array_equal(net.dead.running_mean.numpy(), 0.5)  # untouched: kept
    np.testing.assert_array_equal(net.dead.running_var.numpy(), 1.0)


class _Loader(list):
    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def test_train_model_runs_epochs_and_checkpoints(tmp_path):
    rng = np.random.default_rng(1)
    loader = _Loader()
    loader.epochs = []
    for _ in range(2):
        pts, mask, gt = make_train_batch(rng)
        loader.append({"points": pts, "points_mask": mask, "gt_boxes": gt, "batch_size": 2})
    model = _small_model()
    optimizer, _ = build_optimizer(TorchCfgDict(OPTIM), model, total_iters_each_epoch=2,
                                   total_epochs=2)
    state = create_train_state(model, optimizer, seed=0)
    train_model(state, loader, total_epochs=2, ckpt_dir=tmp_path, max_ckpt_save_num=1,
                precise_bn_batches=2)
    assert loader.epochs == [0, 1] and state.step == 4
    assert [p.name for p in tmp_path.glob("checkpoint_epoch_*.pth")] == ["checkpoint_epoch_2.pth"]
    saved = torch.load(tmp_path / "checkpoint_epoch_2.pth", weights_only=True)
    assert (saved["epoch"], saved["it"], saved["step"]) == (2, 4, 4)


@pytest.fixture
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    every worker's torch would otherwise take all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_overfit_single_batch(few_threads):
    """tests/test_train.py's criterion in the port: the ego config at full
    width on a 128x128 grid, one batch of 512 points, 25 steps."""
    cfg = cfg_from_yaml_file(CFG_EGO, TorchCfgDict())
    info = TorchInfo(class_names=("car",), num_point_features=13, **{
        k: v for k, v in info_kwargs().items() if k in ("point_cloud_range", "voxel_size", "grid_size")})
    model = build_network(cfg.MODEL, num_class=1, dataset_info=info, device="cpu")
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=50, total_epochs=1)
    create_train_state(model, optimizer, seed=0)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-12.0, 12.0, size=(1, 512, 13)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3.0, -0.5, size=(1, 512))
    mask = np.ones((1, 512), bool)
    mask[:, -50:] = False
    gt = np.zeros((1, 8, 8), np.float32)
    gt[:, :4, 0:2] = rng.uniform(-10, 10, size=(1, 4, 2))
    gt[:, :4, 2:6] = [-1.0, 4.2, 1.8, 1.6]
    gt[:, :4, 6] = rng.uniform(-np.pi, np.pi, size=(1, 4))
    gt[:, :4, 7] = 1
    step = make_train_step(model, optimizer)
    losses = [step(torch_batch(pts, mask, gt))[0].item() for _ in range(25)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses
