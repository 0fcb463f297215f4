"""Fake KITTI and custom-dataset trees for the port's tests and the chip
smoke script (no JAX, no imaging library).

``make_kitti_tree(root, train_ids, val_ids, n_points, seed)`` writes
``ImageSets/{train,val}.txt`` and per frame ``training/velodyne/<id>.bin``
(ground returns ahead of and behind the camera, some past 40 m, and the
points of each object), ``calib/<id>.txt`` (the calibration of KITTI's
frame 000000), ``label_2/<id>.txt`` (two or three objects of each class and
a DontCare, the 2D box the projection of the 3D one) and
``image_2/<id>.png``: a real grey PNG written with ``zlib`` and ``struct``,
370 x 1224, except for the last frame, which has none (the readers then
fall back to 375 x 1242). ``make_custom_tree`` writes the custom dataset's
``points/*.npy``, ``labels/*.txt`` and ``ImageSets``.
"""
import struct
import zlib
from pathlib import Path

import numpy as np

P2 = [7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01, 0.0, 7.215377e+02, 1.728540e+02,
      2.163791e-01, 0.0, 0.0, 1.0, 2.745884e-03]
R0 = [9.999239e-01, 9.837760e-03, -7.445048e-03, -9.869795e-03, 9.999421e-01, -4.278459e-03,
      7.402527e-03, 4.351614e-03, 9.999631e-01]
TR = [7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03, 1.480249e-02, 7.280733e-04,
      -9.998902e-01, -7.631618e-02, 9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01]
IMAGE_HW = (370, 1224)
SIZES = {"Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73), "Cyclist": (1.76, 0.6, 1.73)}
GROUND_Z = -1.7


def write_png(path, h, w):
    """A grey 8-bit PNG of h x w."""
    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = b"".join(b"\x00" + bytes(w) for _ in range(h))
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _calib_text():
    line = lambda name, v: f"{name}: " + " ".join(f"{x:.6e}" for x in v) + "\n"
    return "".join([line("P0", P2), line("P1", P2), line("P2", P2), line("P3", P2),
                    line("R0_rect", R0), line("Tr_velo_to_cam", TR)])


def _matrices():
    p2, r0, v2c = (np.array(P2, np.float32).reshape(3, 4), np.array(R0, np.float32).reshape(3, 3),
                   np.array(TR, np.float32).reshape(3, 4))
    rect = np.eye(4, dtype=np.float32)
    rect[:3, :3] = r0
    velo = np.eye(4, dtype=np.float32)
    velo[:3, :4] = v2c
    return p2, rect @ velo


def _label_line(name, box, p2, lidar_to_rect):
    """A KITTI label line of the lidar centre box ``box`` (7,)."""
    x, y, z, l, w, h, yaw = box
    bottom = np.array([x, y, z - h / 2, 1.0])
    loc = (lidar_to_rect @ bottom)[:3]
    ry = -yaw - np.pi / 2
    # the 2D box: the projection of the 3D box's corners
    cx, cy = np.array([1, 1, -1, -1]) * l / 2, np.array([1, -1, -1, 1]) * w / 2
    c, s = np.cos(yaw), np.sin(yaw)
    corners = [[x + c * a - s * b, y + s * a + c * b, zz, 1.0]
               for a, b in zip(cx, cy) for zz in (z - h / 2, z + h / 2)]
    rect = np.array(corners) @ lidar_to_rect.T
    img = rect @ p2.T
    uv = img[:, :2] / img[:, 2:3]
    x1, y1 = np.clip(uv.min(0), 0, [IMAGE_HW[1] - 1, IMAGE_HW[0] - 1])
    x2, y2 = np.clip(uv.max(0), 0, [IMAGE_HW[1] - 1, IMAGE_HW[0] - 1])
    alpha = -np.arctan2(-y, x) + ry
    return (f"{name} 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} {h:.2f} {w:.2f} "
            f"{l:.2f} {loc[0]:.2f} {loc[1]:.2f} {loc[2]:.2f} {ry:.2f}\n")


def _frame(rng, n_points):
    """(points (N, 4) float32, [(name, box)]): objects ahead of the camera and
    ground returns, a tenth of them behind it and a tenth past 40 m."""
    objects = []
    for name, (l, w, h) in SIZES.items():
        for _ in range(int(rng.integers(2, 4))):
            for _ in range(50):  # a free spot
                x, y = rng.uniform(6, 35), rng.uniform(-12, 12)
                if all(np.hypot(x - b[0], y - b[1]) > 5.0 for _, b in objects):
                    break
            objects.append((name, np.array([x, y, GROUND_Z + h / 2, l, w, h,
                                            rng.uniform(-np.pi, np.pi)])))
    per_obj = max(n_points // (4 * len(objects)), 8)
    clouds = []
    for _, (x, y, z, l, w, h, yaw) in objects:
        local = rng.uniform(-0.45, 0.45, (per_obj, 3)) * np.array([l, w, h])
        c, s = np.cos(yaw), np.sin(yaw)
        clouds.append(np.stack([x + c * local[:, 0] - s * local[:, 1],
                                y + s * local[:, 0] + c * local[:, 1], z + local[:, 2]], 1))
    n_ground = n_points - per_obj * len(objects)
    ground = np.stack([rng.uniform(2, 70, n_ground), rng.uniform(-35, 35, n_ground),
                       GROUND_Z + rng.normal(0, 0.03, n_ground)], 1)
    ground[: n_ground // 10, 0] *= -1  # behind the camera
    ground[n_ground // 10: n_ground // 5, 0] = rng.uniform(41, 70, n_ground // 5 - n_ground // 10)
    xyz = np.concatenate(clouds + [ground])
    pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1).astype(np.float32)
    return pts, objects


def make_kitti_tree(root, train_ids=("000000", "000001", "000002"), val_ids=("000003", "000004"),
                    n_points=2000, seed=0):
    """Write the tree under ``root``; returns ``root``."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    p2, lidar_to_rect = _matrices()
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets" / "train.txt").write_text("\n".join(train_ids) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(val_ids) + "\n")
    training = root / "training"
    for sub in ("velodyne", "calib", "label_2", "image_2"):
        (training / sub).mkdir(parents=True, exist_ok=True)
    ids = list(train_ids) + list(val_ids)
    for sid in ids:
        pts, objects = _frame(rng, n_points)
        pts.tofile(str(training / "velodyne" / f"{sid}.bin"))
        (training / "calib" / f"{sid}.txt").write_text(_calib_text())
        lines = [_label_line(name, box, p2, lidar_to_rect) for name, box in objects]
        lines.append("DontCare -1 -1 -10 500.00 160.00 540.00 190.00 -1 -1 -1 -1000 -1000 -1000 -10\n")
        (training / "label_2" / f"{sid}.txt").write_text("".join(lines))
        if sid != ids[-1]:
            write_png(training / "image_2" / f"{sid}.png", *IMAGE_HW)
    return root


def make_custom_tree(root, train_ids=("a0", "a1"), val_ids=("b0",), n_points=1500, seed=0):
    """The custom dataset's tree (classes Vehicle, Pedestrian, Cyclist)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    names = {"Car": "Vehicle", "Pedestrian": "Pedestrian", "Cyclist": "Cyclist"}
    for sub in ("ImageSets", "points", "labels"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets" / "train.txt").write_text("\n".join(train_ids) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(val_ids) + "\n")
    for sid in list(train_ids) + list(val_ids):
        pts, objects = _frame(rng, n_points)
        np.save(root / "points" / f"{sid}.npy", pts)
        (root / "labels" / f"{sid}.txt").write_text("".join(
            " ".join(f"{v:.3f}" for v in box) + f" {names[name]}\n" for name, box in objects))
    return root
