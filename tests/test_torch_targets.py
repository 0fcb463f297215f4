"""CenterPoint targets and losses of the port against the JAX package.

Gaussian radii (rtol 1e-6; their integer parts exactly), gaussian splats
(atol 1e-6: ``exp`` rounds differently by an ulp), the target assigner over a
batch (``inds`` and ``mask`` exactly, heatmaps atol 1e-6, box targets rtol
1e-6 / atol 1e-6) with boxes on cell borders and corners, past the grid,
without extent, padding rows, and more boxes than NUM_MAX_OBJS at the head;
the focal and L1 losses (rtol 1e-5) and their gradients (atol 1e-6), with
and without positives and with NaN targets.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models.dense_heads.center_head import CenterHead as JaxHead
from pcp_tpu.models.dense_heads.target_assigner import assign_targets_single_head as jax_assign
from pcp_tpu.models.loss_fnc import centernet_losses as jl
from pcp_tpu.models.model_utils import centernet_utils as ju
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.models.dense_heads.center_head import CenterHead
from pcp_tpu_torch.models.dense_heads.target_assigner import assign_targets_single_head
from pcp_tpu_torch.models.loss_fnc import centernet_losses as tl
from pcp_tpu_torch.models.model_utils import centernet_utils as tu
from torch_port_helpers import MODEL_CFG, PC_RANGE, VOXEL


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

STRIDE, FEAT = 4, 32  # the small model's 128x128 grid at feature stride 4


def test_gaussian_radius_matches():
    rng = np.random.default_rng(0)
    dims = rng.uniform(0.05, 12.0, size=(2, 400)).astype(np.float32)
    dims[:, :4] = [[0.0, 1.0, 5.25, 2.0], [0.0, 0.5, 2.25, 2.0]]
    for overlap in (0.1, 0.5, 0.7):
        want = np.asarray(ju.gaussian_radius(jnp.asarray(dims[0]), jnp.asarray(dims[1]), overlap))
        got = tu.gaussian_radius(torch.from_numpy(dims[0]), torch.from_numpy(dims[1]), overlap).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got.astype(np.int32), want.astype(np.int32))


def test_splat_gaussians_matches():
    rng = np.random.default_rng(1)
    b, m, nc, w, h = 2, 40, 2, 37, 29
    centers = rng.uniform(0, [w - 0.5, h - 0.5], size=(b, m, 2)).astype(np.float32)
    centers[0, :4] = [[0.0, 0.0], [w - 0.5, h - 0.5], [3.0, 7.0], [0.2, h - 0.7]]  # edges, a corner
    radii = rng.integers(0, 14, size=(b, m)).astype(np.int32)  # some past the patch radius 10
    cls = rng.integers(0, nc, size=(b, m)).astype(np.int32)
    valid = rng.uniform(size=(b, m)) > 0.2
    want = np.stack([np.asarray(ju.splat_gaussians(jnp.asarray(centers[i]), jnp.asarray(radii[i]),
                                                   jnp.asarray(cls[i]), jnp.asarray(valid[i]), nc,
                                                   (w, h))) for i in range(b)])
    got = tu.splat_gaussians(torch.from_numpy(centers), torch.from_numpy(radii),
                             torch.from_numpy(cls), torch.from_numpy(valid), nc, (w, h)).numpy()
    assert got.shape == (b, h, w, nc)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)  # the positives of the focal loss


def _boxes(rng, b, m, filled):
    """Car boxes with the awkward cases: centres on cell borders and corners
    of the stride-4 map, past the grid on every side, zero extent, padding
    rows (class 0) and a class the head lacks (2)."""
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :filled, 0:2] = rng.uniform(-12.8, 12.8, (b, filled, 2))
    gt[:, :filled, 2] = rng.uniform(-2, 0, (b, filled))
    gt[:, :filled, 3:6] = rng.uniform(0.3, 6.0, (b, filled, 3))
    gt[:, :filled, 6] = rng.uniform(-np.pi, np.pi, (b, filled))
    gt[:, :filled, 7] = 1
    cell = VOXEL[0] * STRIDE
    gt[0, 0, 0:2] = [PC_RANGE[0] + cell * 7, PC_RANGE[1] + cell * 11]  # a corner
    gt[0, 1, 0] = PC_RANGE[0] + cell * 3  # a column border
    gt[0, 2, 0:2] = [PC_RANGE[3], PC_RANGE[4]]  # the far corner of the grid
    gt[0, 3, 0:2] = [20.0, -30.0]  # past the grid
    gt[1, 0, 0:2] = [PC_RANGE[0], PC_RANGE[1]]  # the origin corner
    gt[1, 1, 3] = 0.0  # no extent: not a target
    gt[1, 2, 7] = 2  # a class this head lacks: clipped into the map as in the JAX package
    return gt


def test_assign_targets_matches():
    rng = np.random.default_rng(2)
    b, m = 2, 50
    gt = _boxes(rng, b, m, filled=30)
    head_map = np.array([0, 1], np.int32)
    kw = dict(num_classes=1, feat_w=FEAT, feat_h=FEAT, stride=STRIDE, gaussian_overlap=0.1,
              min_radius=2, num_max_objs=m)
    want = [jax_assign(jnp.asarray(gt[i]), jnp.asarray(head_map), pc_range=jnp.asarray(PC_RANGE),
                       voxel_size=jnp.asarray(VOXEL), **kw) for i in range(b)]
    want = [np.stack([np.asarray(w[k]) for w in want]) for k in range(4)]
    got = [t.numpy() for t in assign_targets_single_head(
        torch.from_numpy(gt), torch.from_numpy(head_map), pc_range=PC_RANGE, voxel_size=VOXEL, **kw)]
    np.testing.assert_array_equal(got[2], want[2])  # inds
    np.testing.assert_array_equal(got[3], want[3])  # mask
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)  # heatmap
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=1e-6)  # target boxes
    assert want[3].sum() == 2 * 30 - 1 and want[2][0, 3] == FEAT - 1  # past the grid: clipped


def _head_cfg(cap):
    cfg = copy.deepcopy(MODEL_CFG["DENSE_HEAD"])
    cfg["TARGET_ASSIGNER_CONFIG"]["NUM_MAX_OBJS"] = cap
    return cfg


@pytest.mark.parametrize("m", [7, 12], ids=["padded", "trimmed"])
def test_head_training_forward_targets_and_loss_match(m):
    """The CenterHead's training forward with NUM_MAX_OBJS 9: gt is padded
    (7 boxes) or trimmed (12) to it; targets and the loss of the same
    predictions match."""
    rng = np.random.default_rng(m)
    cap, c = 9, 16
    gt = _boxes(rng, 2, m, filled=m)
    feats = rng.normal(size=(2, FEAT, FEAT, c)).astype(np.float32)
    kw = dict(num_class=1, class_names=("car",), grid_size=(128, 128, 1),
              point_cloud_range=PC_RANGE, voxel_size=VOXEL)
    jhead = JaxHead(model_cfg=CfgDict(_head_cfg(cap)), input_channels=c, **kw)
    jb = {"spatial_features_2d": jnp.asarray(feats), "gt_boxes": jnp.asarray(gt)}
    variables = jhead.init(jax.random.PRNGKey(0), jb, train=True)
    jout, _ = jhead.apply(variables, jb, train=True, mutable=["batch_stats"])
    assert "final_box_dicts" not in jout

    head = CenterHead(model_cfg=TorchCfgDict(_head_cfg(cap)), input_channels=c, **kw).train()
    tout = head({"spatial_features_2d": torch.from_numpy(feats).permute(0, 3, 1, 2),
                 "gt_boxes": torch.from_numpy(gt)})
    assert "final_box_dicts" not in tout
    for key, want in jout["head_targets"][0].items():
        got = tout["head_targets"][0][key].detach().numpy()
        assert got.shape[:2] == (2, FEAT if key == "heatmap" else cap), key
        if key in ("inds", "mask"):
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=key)
        else:
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6, err_msg=key)

    # the same predictions (JAX layout for JAX, NCHW for the port) into both losses
    preds = {k: rng.normal(size=(2, FEAT, FEAT, int(v.shape[-1]))).astype(np.float32)
             for k, v in jout["head_preds"][0].items()}
    jloss, jtb = jhead.apply(variables, [{k: jnp.asarray(v) for k, v in preds.items()}],
                             jout["head_targets"], method=JaxHead.get_loss)
    tloss, ttb = head.get_loss([{k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in preds.items()}],
                               tout["head_targets"])
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert set(ttb) == set(jtb) == {"hm_loss_head_0", "loc_loss_head_0", "rpn_loss"}
    for key, value in jtb.items():
        assert ttb[key].item() == pytest.approx(float(value), rel=1e-5), key


@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss_and_gradient_match(positives):
    rng = np.random.default_rng(3)
    logits = rng.normal(-2, 2, (2, 16, 16, 2)).astype(np.float32)
    gt = np.clip(rng.uniform(-0.5, 0.99, logits.shape), 0, None).astype(np.float32)
    if positives:
        gt[0, 3, 4, 0] = gt[1, 7, 7, 1] = 1.0

    def jax_loss(x):
        return jl.focal_loss_centernet(jnp.clip(jax.nn.sigmoid(x), 1e-4, 1 - 1e-4), jnp.asarray(gt))

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tl.focal_loss_centernet(torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4), torch.from_numpy(gt))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-6, rtol=0)


def test_reg_loss_and_gradient_match_with_nan_targets():
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(2, 20, 8)).astype(np.float32)
    target = rng.normal(size=(2, 20, 8)).astype(np.float32)
    target[0, 3, 2] = target[1, 5, :] = np.nan
    mask = rng.uniform(size=(2, 20)) > 0.3

    def jax_loss(p):
        return jl.reg_loss_centernet(p, jnp.asarray(mask), jnp.asarray(target))

    want = jax_loss(jnp.asarray(pred))
    want_g = jax.grad(lambda p: jnp.sum(jax_loss(p) * jnp.arange(1, 9)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tl.reg_loss_centernet(p, torch.from_numpy(mask), torch.from_numpy(target))
    (got * torch.arange(1, 9)).sum().backward()
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), atol=1e-6, rtol=0)
    empty = tl.reg_loss_centernet(p, torch.zeros(2, 20, dtype=torch.bool), torch.from_numpy(target))
    np.testing.assert_array_equal(empty.detach().numpy(), 0.0)  # no valid box: divided by 1
