"""The port's exchange against the JAX package's: points in boxes, flow
pooling, the writer's files, the ego's reading of them, the SE(3) helpers,
and databases written by one package and read by the other.

The host side of both packages is numpy; wherever the two compute the same
float arithmetic in the same order the results must be equal, and the tests
say where they hold a tolerance instead and why.
"""
import types

import numpy as np
import pytest
import torch

from pcp_tpu.datasets.v2x_sim.v2x_sim_dataset_ego import V2XSimDataset_EGO
from pcp_tpu.exchange.database import ExchangeDatabase as JaxDB
from pcp_tpu.exchange.database import pool_box_flow as jax_pool
from pcp_tpu.native import points_in_boxes_np as native_points_in_boxes
from pcp_tpu.train.eval_utils import make_exchange_writer as jax_writer
from pcp_tpu.utils import geometry as jgeo
from pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_ego import (load_and_propagate_modar,
                                                                 modar_to_points)
from pcp_tpu_torch.exchange.database import ExchangeDatabase, pool_box_flow
from pcp_tpu_torch.ops.points_in_boxes import points_in_boxes
from pcp_tpu_torch.train.eval_utils import make_exchange_writer
from pcp_tpu_torch.utils import geometry as tgeo


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

def _boxes(rng, m):
    b = np.zeros((m, 7), np.float32)
    b[:, 0:2] = rng.uniform(-10, 10, (m, 2))
    b[:, 2] = rng.uniform(-2, 0, m)
    b[:, 3:6] = rng.uniform([2, 1, 1], [5, 2.5, 2], (m, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, m)
    return b


def _face_distance(points, boxes):
    """(N, M) float64 distance of each point to the nearest face of each
    box's containment test (z against the center, xy with the margin)."""
    p, b = points.astype(np.float64), boxes.astype(np.float64)
    rel = p[:, None, :3] - b[None, :, :3]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    lx = c * rel[..., 0] + s * rel[..., 1]
    ly = -s * rel[..., 0] + c * rel[..., 1]
    return np.minimum.reduce([np.abs(np.abs(rel[..., 2]) - b[:, 5] / 2),
                              np.abs(np.abs(lx) - b[:, 3] / 2 - 1e-5),
                              np.abs(np.abs(ly) - b[:, 4] / 2 - 1e-5)])


def _clear_points(rng, boxes, n):
    """Points around the boxes, at least 1e-4 from every face."""
    pts = np.concatenate([
        boxes[rng.integers(0, len(boxes), n), :3] + rng.uniform(-2.5, 2.5, (n, 3)),
        rng.uniform([-12, -12, -3], [12, 12, 1], (n, 3))]).astype(np.float32)
    return pts[_face_distance(pts, boxes).min(1) >= 1e-4]


def test_points_in_boxes_matches_native():
    """First containing box, against the native host kernel, on points at
    least 1e-4 from every face (overlapping boxes: the first wins): equal."""
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 30)
    boxes[1] = boxes[0] + np.float32([0.5, 0.3, 0.0, 0.0, 0.0, 0.0, 0.2])  # overlaps box 0
    pts = _clear_points(rng, boxes, 3000)
    want = native_points_in_boxes(pts, boxes)
    got = points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 500 and (want == -1).sum() > 500 and (want == 1).any()
    empty = points_in_boxes(torch.from_numpy(pts), torch.zeros((0, 7))).numpy()
    np.testing.assert_array_equal(empty, -1)


def test_points_in_boxes_on_faces():
    """Points exactly on a face. Axis-aligned box: both sides count them in
    (z by ``<=``, xy by the 1e-5 margin). Turned box: float32 cos/sin (and
    the native build's fused multiply-adds) round the point's box-frame x by
    up to about 1e-6 m, inside the 1e-5 margin, so both sides count every
    one in as well."""
    box = np.float32([[1.0, -2.0, -1.0, 4.0, 2.0, 1.5, 0.0]])
    on = np.float32([[3.0, -2.0, -1.0], [-1.0, -2.5, -1.0], [1.0, -1.0, -1.0], [1.0, -3.0, -0.5],
                     [1.0, -2.0, -0.25], [1.0, -2.0, -1.75], [0.0, -2.99999, -1.75]])
    want = native_points_in_boxes(on, box)
    got = points_in_boxes(torch.from_numpy(on), torch.from_numpy(box)).numpy()
    np.testing.assert_array_equal(want, 0)
    np.testing.assert_array_equal(got, 0)

    rng = np.random.default_rng(1)
    turned = np.float32([[0.5, 0.25, -1.0, 4.0, 2.0, 1.5, 0.7]])
    u = rng.uniform(-1, 1, 200)
    c, s = np.cos(0.7), np.sin(0.7)
    lx, ly = np.where(u > 0, 2.0, -2.0), u  # on the +-x faces, in the box frame
    face = np.stack([0.5 + c * lx - s * ly, 0.25 + s * lx + c * ly, np.full(200, -1.0)],
                    -1).astype(np.float32)
    want = native_points_in_boxes(face, turned)
    got = points_in_boxes(torch.from_numpy(face), torch.from_numpy(turned)).numpy()
    np.testing.assert_array_equal(want, 0)
    np.testing.assert_array_equal(got, 0)


def _modar_and_foreground(rng, m=6, n=400):
    modar = np.zeros((m, 9), np.float32)
    modar[:, :7] = _boxes(rng, m)
    modar[:, 7] = rng.uniform(0.1, 1, m)
    modar[:, 8] = 1
    fg = np.zeros((n, 13), np.float32)
    fg[:, :3] = _clear_points(rng, modar[:, :7], n)[:n]
    fg[:, 3:10] = rng.uniform(0, 1, (n, 7))
    fg[:, 10:13] = rng.normal(0, 1, (n, 3))
    return modar, fg


def test_pool_box_flow_matches_jax():
    """Sender-side pooling: equal to the JAX package's (float64 rows), with
    boxes that hold points and boxes that hold none."""
    rng = np.random.default_rng(2)
    modar, fg = _modar_and_foreground(rng)
    modar[-1, :2] = 40.0  # holds no point: zero flow
    want, got = jax_pool(modar, fg), pool_box_flow(modar, fg)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert (got[:-1, 9:] != 0).any() and not got[-1, 9:].any()
    np.testing.assert_array_equal(pool_box_flow(modar, None), jax_pool(modar, None))


def _sender_outputs(rng, b=3, n=500, k=8):
    """A sender batch and eval outputs as numpy: cloud 0 with boxes and
    foreground, cloud 1 with boxes and no foreground, cloud 2 with no valid
    box; padding rows in the masks."""
    pts = np.zeros((b, n, 7), np.float32)
    pts[..., :3] = rng.uniform([-12, -12, -3], [12, 12, 0], (b, n, 3))
    pts[..., 3:] = rng.uniform(0, 1, (b, n, 4))
    mask = np.ones((b, n), bool)
    mask[:, -50:] = False
    boxes = np.stack([_boxes(rng, k) for _ in range(b)])
    boxes[0, :, :3] = pts[0, rng.choice(n - 50, k, replace=False), :3]  # boxes on points
    valid = np.ones((b, k), bool)
    valid[0, -2:] = False
    valid[2] = False
    prob = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    prob[1, :, 0] = 0.9  # background everywhere: no foreground broadcast
    out = {"final_box_dicts": {"pred_boxes": boxes,
                               "pred_scores": rng.uniform(0.1, 1, (b, k)).astype(np.float32),
                               "pred_labels": np.ones((b, k), np.int32), "pred_valid": valid},
           "points_cls_prob": prob, "points_flow3d": rng.normal(0, 1, (b, n, 3)).astype(np.float32)}
    batch = {"points": pts, "points_mask": mask,
             "metadata": [{"sample_token": f"kf{i % 2}", "lidar_id": 2 + i} for i in range(b)]}
    return batch, out


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same sender outputs broadcast by the JAX writer, by the port's
    writer from numpy, and by the port's writer from torch tensors."""
    batch, out = _sender_outputs(np.random.default_rng(3))
    dirs = {name: tmp_path_factory.mktemp(name) for name in ("jax", "port", "port_torch")}
    jax_writer(JaxDB(dirs["jax"]))(batch, out)
    make_exchange_writer(ExchangeDatabase(dirs["port"]))(batch, out)
    make_exchange_writer(ExchangeDatabase(dirs["port_torch"]))(_as_torch(batch), _as_torch(out))
    return batch, out, dirs


def test_writer_files_match_jax(written):
    """modar, foreground and boxflow: the same files, arrays, dtypes; no modar
    or boxflow for a cloud without a valid box (its foreground still goes
    out), no foreground file for a cloud without foreground."""
    _, _, dirs = written
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == ["kf0_id2_boxflow.npz", "kf0_id2_foreground.npz", "kf0_id2_modar.npz",
                     "kf0_id4_foreground.npz", "kf1_id3_boxflow.npz", "kf1_id3_modar.npz"]
    for name in ("port", "port_torch"):
        assert sorted(p.name for p in dirs[name].iterdir()) == names
        for f in names:
            want, got = np.load(dirs["jax"] / f)["data"], np.load(dirs[name] / f)["data"]
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert np.load(dirs["jax"] / "kf0_id2_boxflow.npz")["data"][:, 9:].any()


def _jax_reader(directory):
    """``V2XSimDataset_EGO._load_and_propagate_modar_pred`` on a stub ``self``
    that holds what the method reads."""
    stub = types.SimpleNamespace(exchange_database={i: JaxDB(directory) for i in range(6)},
                                 _exchange_misses=0, logger=None)
    return lambda token, lid, propagate: V2XSimDataset_EGO._load_and_propagate_modar_pred(
        stub, token, lid, propagate)


def _legacy_db(directory, rng):
    """A database without boxflow: modar and foreground only."""
    modar, fg = _modar_and_foreground(rng)
    db = JaxDB(directory)
    db.save_modar("old", 4, modar)
    db.save_foreground("old", 4, fg)
    db.save_modar("old", 5, modar[:2])  # no foreground file
    return db


@pytest.mark.parametrize("propagate", [True, False])
@pytest.mark.parametrize("case", [("kf0", 2), ("kf1", 3), ("old", 4), ("old", 5), ("kf1", 0)])
def test_load_and_propagate_matches_jax(written, tmp_path, case, propagate):
    """The ego's reading: boxflow (kf0/kf1), legacy modar + foreground
    pooling (old, 4), modar without foreground (old, 5), a missing file
    (kf1, 0), propagation on and off; equal to the JAX package's method."""
    _, _, dirs = written
    directory = dirs["port"] if case[0] != "old" else tmp_path
    if case[0] == "old":
        _legacy_db(tmp_path, np.random.default_rng(4))
    want = _jax_reader(directory)(*case, propagate)
    got = load_and_propagate_modar(ExchangeDatabase(directory), *case, propagate)
    assert got[1] == want[1]
    if want[0] is None:
        assert got[0] is None and case == ("kf1", 0)
        return
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    if propagate and case == ("old", 4):  # the receiver-side pooling moved a box
        unmoved = load_and_propagate_modar(ExchangeDatabase(directory), *case, False)[0]
        assert got[1] == 400 and (got[0][:, :3] != unmoved[:, :3]).any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_round_trip(written, writer):
    """Each package's reader on the database the other (and itself) wrote:
    the same MoDAR rows."""
    _, _, dirs = written
    for case in (("kf0", 2), ("kf1", 3)):
        want = _jax_reader(dirs[writer])(*case, True)[0]
        got = load_and_propagate_modar(ExchangeDatabase(dirs[writer]), *case, True)[0]
        np.testing.assert_array_equal(got, want)
    jax_on_port = _jax_reader(dirs["port"])("kf0", 2, True)[0]
    port_on_jax = load_and_propagate_modar(ExchangeDatabase(dirs["jax"]), "kf0", 2, True)[0]
    np.testing.assert_array_equal(jax_on_port, port_on_jax)


def _seeded_pose(rng):
    yaw = rng.uniform(-np.pi, np.pi)
    tf = np.eye(4)
    tf[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    tf[:3, 3] = rng.uniform([-30, -30, -1], [30, 30, 1])
    return tf


def test_geometry_matches_jax():
    rng = np.random.default_rng(5)
    tf = _seeded_pose(rng) @ _seeded_pose(rng)
    np.testing.assert_array_equal(tgeo.se3_inverse(tf), jgeo.se3_inverse(tf))
    boxes = rng.normal(0, 3, (20, 9))
    pts = rng.normal(0, 3, (20, 5))
    np.testing.assert_array_equal(tgeo.apply_se3(tf, boxes=boxes), jgeo.apply_se3(tf, boxes=boxes))
    for got, want in zip(tgeo.apply_se3(tf, points=pts, boxes=boxes),
                         jgeo.apply_se3(tf, points=pts, boxes=boxes)):
        np.testing.assert_array_equal(got, want)
    a = rng.uniform(-10, 10, 50)
    np.testing.assert_array_equal(tgeo.wrap_angle(a), jgeo.wrap_angle(a))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_modar_to_points_matches_jax(dtype):
    """The MoDAR rows of the ego's 13-feature cloud, as the JAX package's
    ``__getitem__`` builds them (v2x_sim_dataset_ego.py:313-324): float64
    boxflow rows and float32 legacy modar rows, whose transformed boxes the
    JAX package keeps in float32."""
    rng = np.random.default_rng(6)
    modar = rng.normal(0, 5, (12, 9)).astype(dtype)
    target = tgeo.se3_inverse(_seeded_pose(rng)) @ _seeded_pose(rng)
    max_sweep = 10.0

    ref = modar.copy()  # the JAX package's lines, verbatim
    ref[:, :7] = jgeo.apply_se3(target, boxes=ref[:, :7])
    modar_ = np.zeros((ref.shape[0], 13))
    modar_[:, :3] = ref[:, :3]
    modar_[:, 4] = 0.0
    modar_[:, 5:11] = ref[:, 3:]
    modar_[:, -2] = max_sweep
    modar_[:, -1] = -1

    got = modar_to_points(modar, target, max_sweep)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, modar_)
