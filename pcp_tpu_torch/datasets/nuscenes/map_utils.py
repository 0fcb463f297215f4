"""HD-map BEV rasters of the "pointpillar_jr" configs, in numpy alone.

Counterpart of ``pcp_tpu/datasets/nuscenes/map_utils.py`` (after the
reference's ``nuscenes_map_utils.py``, ``MapMaker``): four binary layers
(drivable_area, ped_crossing, walkway, carpark_area) and one lane-direction
layer, rasterized in the sensor frame at ``resolution`` m a pixel over the
point-cloud range, read at each point as five extra point features
(:func:`interpolate_map_at_points`).

The JAX package draws with OpenCV where it imports (``cv2.line``,
``cv2.fillPoly``) and falls back to numpy and matplotlib. The port has one
route, numpy, and it is the JAX package's fallback: lanes are stamped as
discs of ``LANE_THICKNESS // 2`` pixels along each segment, and a polygon
fills the pixels whose centre lies inside it by the crossing-number rule of
matplotlib's ``Path.contains_points`` (the same comparisons, float64). The
OpenCV route differs from it on the edges of lanes and polygons (ROADMAP C).

``MapMaker`` reads the nuScenes map expansion through the devkit and raises
ImportError where the devkit is absent, as the JAX package's does; the
datasets read pre-rasterized maps (an info's ``map_path``).
"""
import numpy as np

from ...utils.geometry import quat_to_rotmat

LAYER_NAMES = ("drivable_area", "ped_crossing", "walkway", "carpark_area")
LANE_THICKNESS = 10  # pixels
TWO_PI = 2 * np.pi


def put_in_2pi(angles):
    """[-pi, pi) -> [0, 2 pi)."""
    angles = np.asarray(angles, dtype=np.float64).copy()
    assert np.all(np.abs(angles) < (np.pi + 1e-3)), "angles must be in [-pi, pi)"
    angles[angles < 0] += TWO_PI
    return angles


def map_lanes_to_sensor(sensor_from_glob, lanes):
    """Lane centre lines {token: (N, 3) global (x, y, yaw)} -> the same in
    the sensor frame, yaw in [0, 2 pi)."""
    out = {}
    rot = sensor_from_glob[:3, :3]
    for token, lane in lanes.items():
        lane = np.asarray(lane, dtype=np.float64)
        xyz = np.pad(lane[:, :2], ((0, 0), (0, 1)))
        xyz = xyz @ rot.T + sensor_from_glob[:3, 3]
        cos, sin = np.cos(lane[:, 2]), np.sin(lane[:, 2])
        dx = rot[0, 0] * cos + rot[0, 1] * sin
        dy = rot[1, 0] * cos + rot[1, 1] * sin
        yaw = put_in_2pi(np.arctan2(dy, dx))
        out[token] = np.concatenate([xyz[:, :2], yaw[:, None]], axis=1)
    return out


def compute_bev_coord(points, point_cloud_range, resolution, to_int=False):
    """(N, >=2) sensor-frame points -> BEV pixel coordinates (floored with
    ``to_int``)."""
    pts = np.asarray(points)
    coord = (pts[:, :2] - np.asarray(point_cloud_range[:2])) / resolution
    return np.floor(coord).astype(int) if to_int else coord


def draw_lane_in_bev(lanes, point_cloud_range, resolution, canvas_size,
                     normalize_lane_angle=False, thickness=LANE_THICKNESS):
    """(H, W) float64 image of the lane polylines, each segment stamped
    with discs coloured by its first point's yaw: yaw / (2 pi + 1e-3) with
    ``normalize_lane_angle``, else the yaw; 0 where no lane passes."""
    img = np.zeros(canvas_size, dtype=np.float64)
    max_angle = TWO_PI + 1e-3
    rad = thickness // 2
    yy, xx = np.mgrid[-rad: rad + 1, -rad: rad + 1]
    disc = (xx ** 2 + yy ** 2) <= rad ** 2
    h, w = canvas_size
    for lane in lanes.values():
        xy = compute_bev_coord(lane, point_cloud_range, resolution, to_int=True)
        for i in range(len(xy) - 1):
            color = float(lane[i, 2]) / max_angle
            p0, p1 = xy[i], xy[i + 1]
            n = max(int(np.abs(p1 - p0).max()), 1)
            for t in np.linspace(0, 1, n + 1):
                cx, cy = np.round(p0 + t * (p1 - p0)).astype(int)
                x0, x1 = max(cx - rad, 0), min(cx + rad + 1, w)
                y0, y1 = max(cy - rad, 0), min(cy + rad + 1, h)
                if x0 < x1 and y0 < y1:
                    patch = disc[y0 - (cy - rad): y1 - (cy - rad), x0 - (cx - rad): x1 - (cx - rad)]
                    img[y0:y1, x0:x1][patch] = color
    if not normalize_lane_angle:
        img = img * max_angle
    return img


def _inside(vertices, tx, ty):
    """Crossing-number test of the points (tx, ty) against the closed
    polygon ``vertices`` (K, 2), matplotlib's ``point_in_path`` comparisons."""
    inside = np.zeros(tx.shape, dtype=bool)
    x0, y0 = vertices[-1]
    yflag0 = y0 >= ty
    for x1, y1 in vertices:
        yflag1 = y1 >= ty
        cross = (yflag0 != yflag1) & (((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1)
        inside ^= cross
        x0, y0, yflag0 = x1, y1, yflag1
    return inside


def rasterize_polygons(polygons, point_cloud_range, resolution, canvas_size):
    """(H, W) float64 mask of the sensor-frame polygons: 1 where a pixel's
    centre lies inside one."""
    h, w = canvas_size
    img = np.zeros(canvas_size, dtype=np.uint8)
    ys, xs = np.mgrid[0:h, 0:w]
    tx, ty = xs.ravel() + 0.5, ys.ravel() + 0.5
    for poly in polygons:
        xy = compute_bev_coord(np.asarray(poly, dtype=np.float64), point_cloud_range, resolution)
        img[_inside(xy, tx, ty).reshape(h, w)] = 1
    return img.astype(np.float64)


def make_map_representation(layer_polygons, lanes_global, sensor_from_glob,
                            point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                            resolution=0.2, normalize_lane_angle=False):
    """(5, H, W) raster: ``layer_polygons`` {layer: [poly (K, 2) in the
    sensor frame]} for the layers of LAYER_NAMES (missing ones empty), then
    the lanes {token: (N, 3) global (x, y, yaw)} moved by
    ``sensor_from_glob``."""
    size = int((point_cloud_range[3] - point_cloud_range[0]) / resolution)
    canvas = (size, size)
    layers = [rasterize_polygons(layer_polygons.get(name, []), point_cloud_range, resolution, canvas)
              for name in LAYER_NAMES]
    lanes = map_lanes_to_sensor(sensor_from_glob, lanes_global)
    lane_img = draw_lane_in_bev(lanes, point_cloud_range, resolution, canvas,
                                normalize_lane_angle=normalize_lane_angle)
    return np.stack(layers + [lane_img], axis=0)


def interpolate_map_at_points(img_map, points, point_cloud_range, resolution):
    """(N, 5) float32: the (5, H, W) raster at each point's BEV cell, zeros
    for a point off the raster."""
    h, w = img_map.shape[1:]
    coord = compute_bev_coord(points, point_cloud_range, resolution, to_int=True)
    ok = (coord[:, 0] >= 0) & (coord[:, 0] < w) & (coord[:, 1] >= 0) & (coord[:, 1] < h)
    out = np.zeros((len(points), img_map.shape[0]), dtype=np.float32)
    cc = np.clip(coord, 0, [w - 1, h - 1])
    out[ok] = img_map[:, cc[ok, 1], cc[ok, 0]].T
    return out


def get_nuscenes_sensor_pose_in_global(nusc, sample_data_token):
    """glob_from_sensor = glob_from_ego @ ego_from_sensor of a sample_data
    record."""
    sd = nusc.get("sample_data", sample_data_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    ep = nusc.get("ego_pose", sd["ego_pose_token"])

    def tf(rec):
        m = np.eye(4)
        m[:3, :3] = quat_to_rotmat(rec["rotation"])
        m[:3, 3] = rec["translation"]
        return m

    return tf(ep) @ tf(cs)


class MapMaker:
    """The map expansion through the nuScenes devkit: (5, H, W) rasters of
    a lidar sample. Raises ImportError where the devkit is absent."""

    def __init__(self, nuscenes_api, resolution=0.2,
                 point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 normalize_lane_angle=False):
        try:
            from nuscenes.prediction import PredictHelper
            from nuscenes.prediction.input_representation.static_layers import load_all_maps
        except ImportError as e:
            raise ImportError("MapMaker needs nuscenes-devkit; the geometric core "
                              "(make_map_representation) works without it") from e
        self.nusc = nuscenes_api
        self.helper = PredictHelper(self.nusc)
        self.maps = load_all_maps(self.helper)
        self.point_cloud_range = np.asarray(point_cloud_range)
        self.resolution = resolution
        size = int((point_cloud_range[3] - point_cloud_range[0]) / resolution)
        self.canvas_size = (size, size)
        self.normalize_lane_angle = normalize_lane_angle

    def make_representation(self, sample_data_token):
        from nuscenes.prediction.input_representation.static_layers import (
            get_lanes_in_radius, get_patchbox, quaternion_yaw)
        from pyquaternion import Quaternion

        sd = self.nusc.get("sample_data", sample_data_token)
        map_name = self.helper.get_map_name_from_sample_token(sd["sample_token"])
        glob_from_sensor = get_nuscenes_sensor_pose_in_global(self.nusc, sample_data_token)
        x, y = glob_from_sensor[:2, 3]
        yaw = quaternion_yaw(Quaternion(matrix=glob_from_sensor))
        patch = get_patchbox(x, y, self.point_cloud_range[3] - self.point_cloud_range[0])
        masks = self.maps[map_name].get_map_mask(patch, np.rad2deg(yaw), list(LAYER_NAMES),
                                                 canvas_size=self.canvas_size)
        lanes = get_lanes_in_radius(x, y, self.point_cloud_range[3], discretization_meters=1,
                                    map_api=self.maps[map_name])
        lanes_in_sensor = map_lanes_to_sensor(np.linalg.inv(glob_from_sensor), lanes)
        lane_img = draw_lane_in_bev(lanes_in_sensor, self.point_cloud_range, self.resolution,
                                    self.canvas_size, normalize_lane_angle=self.normalize_lane_angle)
        return np.concatenate([np.asarray(masks, dtype=float), lane_img[None]], axis=0)
