"""Native host kernels of the data pipeline: C++ through ctypes.

Counterpart of ``pcp_tpu/native/__init__.py``. ``pointcloud.cpp`` (a copy of
the JAX package's source) is built with ``g++ -march=native`` on first use
into ``build/`` beside this file, under a name that carries a hash of the
source, the flags and the host's CPU (a library built for one CPU may not
run on another), and loaded with ctypes. A failed build raises: the pipeline never swaps in the
numpy versions. Those stay beside each native function as ``<name>_plain``
for the tests to hold the native ones against.
"""
import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "pointcloud.cpp"
BUILD_DIR = _HERE / "build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_LIB = None


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return platform.processor()


def library_path():
    key = _SRC.read_bytes() + " ".join(FLAGS + [_cpu_model()]).encode()
    return BUILD_DIR / f"libpcppc_{hashlib.md5(key).hexdigest()[:10]}.so"


def _load():
    """The loaded library, built first if its file is missing. Raises
    RuntimeError when ``g++`` fails or is absent."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise RuntimeError(f"building the native point-cloud kernels failed: "
                               f"{' '.join(cmd)}\n{detail}") from e
        os.replace(tmp, so_path)  # atomic: concurrent builders each write their own file
    lib = ctypes.CDLL(str(so_path))
    f32, f64, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double), ctypes.c_int64
    lib.transform_points.argtypes = [f32, i64, i64, f64]
    lib.sweep_expand.argtypes = [f32, i64, f64, f64, i64, ctypes.c_double, f32]
    lib.range_mask_pad.restype = i64
    lib.range_mask_pad.argtypes = [f32, i64, i64, ctypes.c_float, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float, f32, i64]
    lib.points_in_boxes.argtypes = [f32, i64, i64, f32, i64, ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def transform_points_(pts, se3):
    """SE(3) transform of the first 3 columns of (N, C>=3) float32 points,
    in place where ``pts`` is already a contiguous float32 array. Returns
    the transformed array."""
    lib = _load()
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    se3 = np.ascontiguousarray(se3, dtype=np.float64)
    lib.transform_points(_fptr(pts), pts.shape[0], pts.shape[1], _dptr(se3))
    return pts


def transform_points_plain(pts, se3):
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    rot, t = np.asarray(se3)[:3, :3], np.asarray(se3)[:3, 3]
    pts[:, :3] = pts[:, :3] @ rot.T + t
    return pts


def sweep_expand(pts_box, poses, timelags, inst_idx):
    """One instance's box-frame points through its historical poses.

    pts_box (n, 4) float32 box-frame points, poses (s, 4, 4) lidar_se3_box
    per sweep, timelags (s,). Returns (s * n, 7) float32 rows: x, y, z,
    intensity, time lag, sweep index, ``inst_idx``."""
    lib = _load()
    pts_box = np.ascontiguousarray(pts_box, dtype=np.float32)
    poses = np.ascontiguousarray(poses, dtype=np.float64)
    timelags = np.ascontiguousarray(timelags, dtype=np.float64)
    s, n = poses.shape[0], pts_box.shape[0]
    out = np.empty((s * n, 7), dtype=np.float32)
    lib.sweep_expand(_fptr(pts_box), n, _dptr(poses), _dptr(timelags), s, float(inst_idx),
                     _fptr(out))
    return out


def sweep_expand_plain(pts_box, poses, timelags, inst_idx):
    pts_box = np.ascontiguousarray(pts_box, dtype=np.float32)
    poses = np.asarray(poses, dtype=np.float64)
    timelags = np.asarray(timelags, dtype=np.float64)
    s, n = poses.shape[0], pts_box.shape[0]
    batch = np.tile(pts_box[None], (s, 1, 1))
    xyz = np.einsum("sij,snj->sni", poses[:, :3, :3], batch[:, :, :3]) + poses[:, None, :3, 3]
    out = np.concatenate([xyz, batch[:, :, 3:4],
                          np.tile(timelags[:, None, None], (1, n, 1)),
                          np.tile(np.arange(s, dtype=np.float64)[:, None, None], (1, n, 1)),
                          np.full((s, n, 1), inst_idx)], axis=-1)
    return out.reshape(s * n, 7).astype(np.float32)


def range_mask_pad(pts, x_min, y_min, x_max, y_max, capacity):
    """The points of (N, C) float32 ``pts`` whose xy lie in the closed range,
    in order, zero-padded to ``capacity`` rows. Returns (padded, kept)."""
    lib = _load()
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    out = np.empty((capacity, pts.shape[1]), dtype=np.float32)
    k = lib.range_mask_pad(_fptr(pts), pts.shape[0], pts.shape[1], x_min, y_min, x_max, y_max,
                           _fptr(out), capacity)
    return out, int(k)


def range_mask_pad_plain(pts, x_min, y_min, x_max, y_max, capacity):
    pts = np.asarray(pts, dtype=np.float32)
    f = np.float32
    keep = ((pts[:, 0] >= f(x_min)) & (pts[:, 0] <= f(x_max))
            & (pts[:, 1] >= f(y_min)) & (pts[:, 1] <= f(y_max)))
    kept = pts[keep][:capacity]
    out = np.zeros((capacity, pts.shape[1]), dtype=np.float32)
    out[:kept.shape[0]] = kept
    return out, int(kept.shape[0])


def points_in_boxes_np(points, boxes):
    """(N,) int64 index of the first box of (M, 7) ``boxes`` that holds each
    point of (N, 3+) ``points``, -1 where none: z within half the height of
    the box's centre, xy within half the length and width plus 1e-5, in
    float32."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    if boxes.shape[0] == 0:
        return -np.ones(points.shape[0], dtype=np.int64)
    lib = _load()
    out = np.empty(points.shape[0], dtype=np.int64)
    lib.points_in_boxes(_fptr(points), points.shape[0], points.shape[1], _fptr(boxes),
                        boxes.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def points_in_boxes_plain(points, boxes):
    points = np.asarray(points, dtype=np.float32)
    boxes = np.asarray(boxes, dtype=np.float32)
    out = -np.ones(points.shape[0], dtype=np.int64)
    for j, b in enumerate(boxes):
        rel = points[:, :3] - b[:3]
        c, s = np.cos(b[6]), np.sin(b[6])
        lx = c * rel[:, 0] + s * rel[:, 1]
        ly = -s * rel[:, 0] + c * rel[:, 1]
        inside = ((np.abs(rel[:, 2]) <= b[5] / 2)
                  & (np.abs(lx) < b[3] / 2 + np.float32(1e-5))
                  & (np.abs(ly) < b[4] / 2 + np.float32(1e-5)))
        out[(out < 0) & inside] = j
    return out
