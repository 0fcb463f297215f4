"""The port's rotated IoU and greedy NMS against the JAX package.

IoU within atol 1e-5 (same edge-clip algorithm; float32 trigonometry may
differ in the last bits). NMS keep-indices must be equal, to JAX and to the
plain-Python greedy reference, on box sets whose IoUs all lie at least 1e-3
from the threshold, where no rounding can flip a suppression.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops.nms import class_agnostic_nms as jax_class_agnostic_nms
from pcp_tpu.ops.nms import nms_bev as jax_nms_bev
from pcp_tpu.ops.rotated_iou import boxes_iou_bev as jax_iou
from pcp_tpu_torch.ops.nms import class_agnostic_nms, nms_bev
from pcp_tpu_torch.ops.rotated_iou import boxes_iou_bev
from reference_impls import greedy_nms_ref


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

THRESH = 0.2


def random_boxes(rng, n, scale=8.0):
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0:2] = rng.uniform(-scale, scale, (n, 2))
    boxes[:, 2] = rng.uniform(-2, 0, n)
    boxes[:, 3:5] = rng.uniform(1.0, 6.0, (n, 2))
    boxes[:, 5] = rng.uniform(1.0, 3.0, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes


def clear_of_threshold(rng, n, margin=1e-3):
    """n boxes (and scores) whose pairwise IoUs are all >= margin from THRESH."""
    boxes = random_boxes(rng, 4 * n)
    iou = np.asarray(jax_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    keep = []
    for i in range(len(boxes)):
        if all(abs(iou[i, j] - THRESH) >= margin for j in keep):
            keep.append(i)
        if len(keep) == n:
            break
    assert len(keep) == n
    return boxes[keep], rng.permutation(n).astype(np.float32) / n + 0.01


def test_iou_matches_random_pairs():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 40), random_boxes(rng, 30)
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0).sum() > 20
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_iou_identical_and_edge_sharing_boxes():
    base = np.array([[1.0, 2.0, -1.0, 4.0, 2.0, 1.5, 0.3]], np.float32)
    shifted = base.copy()
    shifted[0, 0] += 4.0 * np.cos(0.3)  # shares an edge with base
    shifted[0, 1] += 4.0 * np.sin(0.3)
    axis = np.array([[0, 0, 0, 2, 2, 1, 0], [2, 0, 0, 2, 2, 1, 0], [1, 1, 0, 2, 2, 1, 0]],
                    np.float32)  # axis-aligned: an edge-sharing and a quarter-overlap pair
    boxes = np.concatenate([base, base, shifted, axis])
    want = np.asarray(jax_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = boxes_iou_bev(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    assert abs(got[0, 2]) < 1e-4 and abs(got[3, 4]) < 1e-4  # shared edge, no area
    np.testing.assert_allclose(got[3, 5], 1.0 / 7.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_indices_match(seed):
    rng = np.random.default_rng(seed)
    boxes, scores = clear_of_threshold(rng, 48)
    valid = rng.uniform(size=48) > 0.15
    want_idx, want_n = jax_nms_bev(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                   THRESH, post_max_size=30)
    got_idx, got_n = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), THRESH, post_max_size=30)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert int(got_n) == int(want_n)

    vi = np.flatnonzero(valid)
    ref = [int(vi[i]) for i in greedy_nms_ref(boxes[vi].astype(np.float64), scores[vi], THRESH)]
    assert got_idx.numpy()[: int(got_n)].tolist() == ref[:30]


def test_nms_batched_equals_per_sample():
    rng = np.random.default_rng(7)
    sets = [clear_of_threshold(rng, 32) for _ in range(3)]
    boxes = torch.from_numpy(np.stack([s[0] for s in sets]))
    scores = torch.from_numpy(np.stack([s[1] for s in sets]))
    valid = torch.ones(scores.shape, dtype=torch.bool)
    batched, counts = nms_bev(boxes, scores, valid, THRESH, post_max_size=20)
    for i in range(3):
        one, n = nms_bev(boxes[i], scores[i], valid[i], THRESH, post_max_size=20)
        assert torch.equal(batched[i], one) and int(counts[i]) == int(n)


def test_class_agnostic_nms_preselects_like_jax():
    rng = np.random.default_rng(3)
    boxes, scores = clear_of_threshold(rng, 40)
    valid = np.ones(40, bool)
    cfg = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": THRESH, "NMS_PRE_MAXSIZE": 25,
           "NMS_POST_MAXSIZE": 12}
    want, want_n = jax_class_agnostic_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                          jnp.asarray(valid), cfg)
    got, got_n = class_agnostic_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    torch.from_numpy(valid), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n)


@pytest.mark.parametrize("thresh", [0.1, 0.8])
def test_pair_restricted_overlaps_equal_the_dense_ones(thresh, monkeypatch):
    """Above ``PAIRS_ABOVE`` candidates the NMS takes the IoU only for pairs
    whose BEV circles meet: that overlap matrix equals the dense path's,
    batched, in several chunks, on clustered boxes (many overlaps) among
    scattered ones with near twins, and the kept indices (padding rows
    among them) equal a sequential greedy pass over the dense matrix."""
    from pcp_tpu_torch.ops import nms

    rng = np.random.default_rng(int(thresh * 10))
    b, k = 2, 300
    centres = rng.uniform([0, -40], [70, 40], (b, 20, 2))
    xy = centres[:, rng.integers(0, 20, k)] + rng.normal(0, 1.0, (b, k, 2))
    boxes = np.concatenate([xy, rng.uniform(-2, 0, (b, k, 1)), rng.uniform(0.5, 4.5, (b, k, 3)),
                            rng.uniform(-np.pi, np.pi, (b, k, 1))], -1).astype(np.float32)
    boxes[:, 1::3] = boxes[:, 0::3] + rng.normal(0, 0.02, boxes[:, 0::3].shape)  # near twins
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    valid = np.ones((b, k), bool)
    valid[1, -50:] = False
    bt = torch.from_numpy(boxes)
    idx = torch.arange(k)
    dense = (boxes_iou_bev(bt, bt) > thresh) & (idx[None, :] < idx[:, None])
    assert torch.equal(nms._over_dense(bt, thresh), dense)
    monkeypatch.setattr(nms, "PAIR_CHUNK", 2000)
    assert torch.equal(nms._over_pairs(bt, thresh), dense)
    monkeypatch.setattr(nms, "PAIRS_ABOVE", 0)
    got_idx, got_n = nms_bev(bt, torch.from_numpy(scores), torch.from_numpy(valid), thresh, 300)
    for s in range(b):
        order = np.argsort(-np.where(valid[s], scores[s], -np.inf), kind="stable")
        bs = bt[s][torch.from_numpy(order)]
        over = (boxes_iou_bev(bs, bs) > thresh).numpy()
        kept = []
        for i in range(k):
            if valid[s, order[i]] and not any(over[i, j] for j in kept):
                kept.append(i)
        assert got_idx[s, :int(got_n[s])].tolist() == order[kept].tolist()
    assert 10 < int(got_n[0]) < k - 50
    with pytest.raises(ValueError, match="above 0"):
        nms_bev(bt, torch.from_numpy(scores), torch.from_numpy(valid), 0.0, 300)
