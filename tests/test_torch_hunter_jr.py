"""The port's HunterJr corrector and the sender detector against the JAX package.

The sender's structure at reduced size (``CAR_CFG`` of
tests/torch_port_helpers.py: 128x128 grid, narrow widths, a corrector with
hidden [8]) and 7-feature sweep batches as tests/test_hunter_jr.py makes
them; the same weights in both packages, the JAX VFE's Pallas kernel in
interpret mode. Tolerances, stated per test: the sampling ops atol 1e-6 /
rtol 1e-6 (the same float32 arithmetic, sums in another order); the
corrector's fused BEV atol 1e-4 / rtol 1e-4, ``points_cls_prob`` atol 1e-5,
``points_flow3d`` atol 1e-4 (convolutions and matmuls in another order);
the whole sender as tests/test_torch_centerpoint.py holds the ego.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.models.bev_layers import hunter_jr as jhj
from pcp_tpu.models.bev_layers import hunter_toolbox as jtb
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu_torch.models.bev_layers import hunter_toolbox as ttb
from pcp_tpu_torch.models.bev_layers.hunter_jr import HunterJr
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import put_mlp, state_dict_from_jax_variables
from test_hunter_jr import make_sweep_batch
from torch_port_helpers import (CAR_CFG, CAR_FEATURES, PC_RANGE, build_pair, info_kwargs,
                                load_eval_variables, randomize_batch_stats)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

THRESH = 0.3


def balance_seg_bias(seg_params, cls_prob, mask):
    """Shift the seg head's output bias by each class's mean logit over the
    valid rows. At initial weights one class wins every point; balanced, the
    dynamic class wins about a third of them, so both branches of the
    corrector run."""
    p = np.asarray(cls_prob, np.float64)[mask]
    last = f"lin_{len(seg_params) // 2}"
    shift = (np.log(p) - np.log1p(-p)).mean(0)
    seg_params[last]["bias"] = (seg_params[last]["bias"] - shift).astype(np.float32)


def _np_batch(rng, b, n):
    batch = make_sweep_batch(rng, b=b, n=n)
    return np.asarray(batch["points"]), np.asarray(batch["points_mask"])


# ------------------------------------------------------------ sampling ops

def _border_points(rng, b, h, w, pc, ps):
    """Metric xy on pixel borders (integer pixel coords), inside pixels,
    outside the range on every side, and in the last pixel row/column,
    where the clip makes x1 == x0."""
    px = np.concatenate([
        rng.integers(0, w + 1, 40).astype(np.float32),             # on borders
        rng.uniform(0, w, 40).astype(np.float32),                  # inside
        rng.uniform(-3, 0, 10).astype(np.float32),                 # left of the range
        rng.uniform(w, w + 3, 10).astype(np.float32),              # right of it
        rng.uniform(w - 1, w, 20).astype(np.float32),              # last column
    ])
    py = rng.permutation(np.concatenate([
        rng.integers(0, h + 1, 40).astype(np.float32), rng.uniform(0, h, 40).astype(np.float32),
        rng.uniform(-3, 0, 10).astype(np.float32), rng.uniform(h, h + 3, 10).astype(np.float32),
        rng.uniform(h - 1, h, 20).astype(np.float32)]))
    xy = np.stack([px * ps[0] + pc[0], py * ps[1] + pc[1]], -1).astype(np.float32)
    return np.stack([rng.permutation(xy) for _ in range(b)])


def test_bilinear_interpolate_bev_matches_jax():
    """Points on pixel borders, outside the range and at the clip edges;
    features and pixel coords, atol 1e-6 / rtol 1e-6 (coords exact)."""
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 12, 20, 8
    pc = np.asarray(PC_RANGE, np.float32)
    ps = np.float32([0.2, 0.2]) * 4
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    xy = _border_points(rng, b, h, w, pc, ps)
    jf, jc = jtb.bilinear_interpolate_bev(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(pc),
                                          jnp.asarray(ps))
    tf, tc = ttb.bilinear_interpolate_bev(torch.from_numpy(img), torch.from_numpy(xy),
                                          torch.from_numpy(pc), torch.from_numpy(ps))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6, rtol=1e-6)
    coord = tc.numpy()
    assert (coord == np.round(coord)).any() and (coord < 0).any() and (coord[..., 0] > w).any()


def test_bev_scatter_matches_jax():
    """Mean-scatter with coords at x == 0 and y == 0 (dropped: only strictly
    interior coords count), on the far borders, outside, inside, and padding
    rows; atol 1e-6 / rtol 1e-6."""
    rng = np.random.default_rng(1)
    b, n, c, h, w = 2, 300, 6, 10, 14
    coord = np.stack([rng.uniform(-1, w + 1, (b, n)), rng.uniform(-1, h + 1, (b, n))],
                     -1).astype(np.float32)
    coord[:, :20, 0] = 0.0
    coord[:, 20:40, 1] = 0.0
    coord[:, 40:50] = [w, h]
    coord[:, 50:60] = rng.integers(1, 9, (b, 10, 1)).astype(np.float32)  # many to one pixel
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) < 0.9
    want = jtb.bev_scatter(jnp.asarray(coord), jnp.asarray(feats), jnp.asarray(valid), h, w)
    got = ttb.bev_scatter(torch.from_numpy(coord), torch.from_numpy(feats),
                          torch.from_numpy(valid), h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hidden,is_head", [((8,), True), ((8,), False), ((), True)])
def test_mlp_eval_matches_jax(hidden, is_head):
    """The eval MLP with random running statistics; atol 1e-6 / rtol 1e-6."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    valid = rng.uniform(size=64) < 0.8
    jm = jtb.MLP(5, hidden, is_head=is_head)
    init = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), valid=jnp.asarray(valid))
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    stats = randomize_batch_stats(init.get("batch_stats", {}), rng)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                    valid=jnp.asarray(valid))
    tm = ttb.MLP(16, 5, hidden, is_head=is_head).eval()
    sd = {}
    put_mlp(sd, "m", params, stats)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------- HunterJr

@pytest.fixture(scope="module")
def corrector_pair():
    """The JAX HunterJr and the port's, same weights, on a random
    non-negative BEV (as the backbone hands it over) and a sweep batch."""
    rng = np.random.default_rng(3)
    b, n, c = 2, 1024, 24
    pts, mask = _np_batch(rng, b, n)
    bev = np.maximum(rng.standard_normal((b, 32, 32, c)), 0).astype(np.float32)
    cfg = CAR_CFG["CORRECTOR"]
    jm = jhj.HunterJr(model_cfg=cfg, info=JaxInfo(**info_kwargs(CAR_FEATURES)),
                      num_bev_features=c)
    jbatch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
              "spatial_features_2d": jnp.asarray(bev)}
    init = jax.jit(lambda key, batch: jm.init(key, batch, train=False))(jax.random.PRNGKey(3),
                                                                          jbatch)
    variables = {"params": {"corrector": jax.tree_util.tree_map(np.asarray, init["params"])},
                 "batch_stats": {"corrector": randomize_batch_stats(init["batch_stats"], rng)}}
    inner = {k: v["corrector"] for k, v in variables.items()}
    apply = jax.jit(lambda v, batch: jm.apply(v, batch, train=False))
    balance_seg_bias(inner["params"]["point_head"]["seg"], apply(inner, jbatch)["points_cls_prob"],
                     mask)
    jout = apply(inner, jbatch)
    tm = HunterJr(cfg, TorchInfo(**info_kwargs(CAR_FEATURES)), c).eval()
    sd = state_dict_from_jax_variables(variables, {"CORRECTOR": cfg})
    # an eval-mode init has no object head (only training calls it)
    missing = tm.load_state_dict({k[len("corrector."):]: v for k, v in sd.items()}, strict=False)
    assert not missing.unexpected_keys
    assert missing.missing_keys and all(k.startswith("object_head.") for k in missing.missing_keys)
    with torch.inference_mode():
        tout = tm({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask),
                   "spatial_features_2d": torch.from_numpy(bev).permute(0, 3, 1, 2)})
    return jout, tout, mask


def _dynamic(prob, mask):
    return (prob.max(-1) > THRESH) & (prob.argmax(-1) == 2) & mask


def test_hunter_jr_point_outputs_match_jax(corrector_pair):
    """points_cls_prob atol 1e-5, points_flow3d atol 1e-4 (valid rows; padding
    rows get predictions too); both branches of the dynamic mask taken, and
    the same points moved in both packages."""
    jout, tout, mask = corrector_pair
    jp, tp = np.asarray(jout["points_cls_prob"]), tout["points_cls_prob"].numpy()
    assert tp.shape == jp.shape == mask.shape + (3,)
    np.testing.assert_allclose(tp[mask], jp[mask], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tout["points_flow3d"].numpy()[mask],
                               np.asarray(jout["points_flow3d"])[mask], atol=1e-4, rtol=0)
    dyn = _dynamic(jp, mask)
    assert 0 < dyn.sum() < mask.sum(), "both corrector branches must be exercised"
    clear = np.abs(jp.max(-1) - THRESH) > 1e-5
    np.testing.assert_array_equal(_dynamic(tp, mask)[clear], dyn[clear])


def test_hunter_jr_fused_bev_matches_jax(corrector_pair):
    """The blended BEV, atol 1e-4 / rtol 1e-4."""
    jout, tout, _ = corrector_pair
    got = tout["spatial_features_2d"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jout["spatial_features_2d"]), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def car_pair():
    """The sender in both packages, its seg bias balanced on the batch the
    whole-forward test takes, and both packages' outputs on that batch."""
    jmodel, variables, tmodel = build_pair(seed=9, model_cfg=CAR_CFG, num_features=CAR_FEATURES)
    pts, mask = _np_batch(np.random.default_rng(5), 2, 2048)
    apply = jax.jit(lambda v, p, m: jmodel.apply(
        v, {"points": p, "points_mask": m, "batch_size": 2}, train=False))
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    balance_seg_bias(variables["params"]["corrector"]["point_head"]["seg"],
                     apply(variables, jp, jm)["points_cls_prob"], mask)
    load_eval_variables(tmodel, variables, CAR_CFG)
    jout = apply(variables, jp, jm)
    with torch.inference_mode():
        tout = tmodel({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})
    return tmodel, (jout, tout, mask)


def test_corrector_width_is_the_backbones(car_pair):
    """As the JAX package, the corrector takes num_bev_features (here 48, the
    backbone's upsample sum) whatever CONV_INPUT_CHANNELS (64) says."""
    tmodel, _ = car_pair
    assert tmodel.corrector.conv_input[0].weight.shape == (48, 48, 3, 3)
    assert tmodel.corrector.conv_weightor[1].weight.shape == (2, 96, 3, 3)


# ------------------------------------------------------- the whole sender

def test_car_sender_forward_matches_jax(car_pair):
    """The whole car-config eval forward: BEV 2e-4/1e-4, corrected BEV
    2e-3/1e-3, point outputs as above, head 3e-3/1e-3, surviving boxes
    under the margin rule."""
    jout, tout, mask = car_pair[1]
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(tout["spatial_features"]),
                               np.asarray(jout["spatial_features"]), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(tout["spatial_features_2d"]),
                               np.asarray(jout["spatial_features_2d"]), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(tout["points_cls_prob"].numpy()[mask],
                               np.asarray(jout["points_cls_prob"])[mask], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tout["points_flow3d"].numpy()[mask],
                               np.asarray(jout["points_flow3d"])[mask], atol=1e-4, rtol=0)
    dyn = _dynamic(np.asarray(jout["points_cls_prob"]), mask)
    assert 0 < dyn.sum() < mask.sum(), "both corrector branches must be exercised"
    for branch, t in tout["head_preds"][0].items():
        np.testing.assert_allclose(nhwc(t), np.asarray(jout["head_preds"][0][branch]),
                                   atol=3e-3, rtol=1e-3, err_msg=branch)
    pp = CAR_CFG["DENSE_HEAD"]["POST_PROCESSING"]
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = {k: np.asarray(v) for k, v in jout["final_box_dicts"].items()}
    heat = 1 / (1 + np.exp(-np.asarray(jout["head_preds"][0]["hm"], np.float64)))
    for i in range(2):
        match_surviving_boxes({k: v[i] for k, v in got.items()}, {k: v[i] for k, v in want.items()},
                              heat[i].reshape(-1), top_k=pp["MAX_OBJ_PER_SAMPLE"],
                              score_thresh=pp["SCORE_THRESH"],
                              post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"])
    assert got["pred_valid"].any()


def test_oracle_corrector_raises_naming_a9():
    """The oracle corrector was refused naming A9 until DiscoNet's slice
    ported it; ``build_corrector`` now builds it beside HunterJr (held
    against the JAX module in ``test_torch_disconet.py``), and a corrector
    that neither package registers is refused."""
    from pcp_tpu_torch.models.bev_layers import build_corrector
    from pcp_tpu_torch.models.bev_layers.oracle_corrector import OracleCorrector

    info = TorchInfo(**info_kwargs(CAR_FEATURES))
    assert isinstance(build_corrector({"NAME": "OracleCorrector"}, info, 8), OracleCorrector)
    with pytest.raises(KeyError):
        build_corrector({"NAME": "NoSuchCorrector"}, info, 8)
