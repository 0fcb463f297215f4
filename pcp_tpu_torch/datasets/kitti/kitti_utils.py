"""KITTI-format annotation helpers: counterpart of
``pcp_tpu/datasets/kitti/kitti_utils.py``.

``transform_annotations_to_kitti_format`` has the upstream devkit-free
semantics the JAX package keeps: a pseudo camera frame derived from the
lidar boxes, which is what the custom dataset's KITTI-protocol eval needs.
"""
import numpy as np


def transform_annotations_to_kitti_format(annos, map_name_to_kitti=None,
                                          info_with_fakelidar=False):
    """Lidar-frame annos -> KITTI-style camera annos (in place, returned)."""
    for anno in annos:
        if "name" not in anno:
            anno["name"] = anno.pop("gt_names")
        anno["name"] = np.array(
            [map_name_to_kitti.get(n, n) if map_name_to_kitti else n
             for n in anno["name"]], dtype=object)
        n = len(anno["name"])
        anno["bbox"] = np.zeros((n, 4))
        anno["bbox"][:, 2:4] = 50  # dummy 2D box, never height-filtered out
        anno["truncated"] = np.zeros(n)
        anno["occluded"] = np.zeros(n, np.int64)
        if "boxes_lidar" in anno:
            boxes = np.array(anno["boxes_lidar"], dtype=np.float64, copy=True)
        else:
            boxes = np.array(anno["gt_boxes_lidar"], dtype=np.float64, copy=True)
        if info_with_fakelidar:
            from ...utils.box_utils import boxes3d_kitti_fakelidar_to_lidar

            boxes = boxes3d_kitti_fakelidar_to_lidar(boxes)
        if boxes.shape[0]:
            boxes[:, 2] -= boxes[:, 5] / 2  # center -> bottom
            anno["location"] = np.zeros((n, 3))
            anno["location"][:, 0] = -boxes[:, 1]  # x_cam = -y_lidar
            anno["location"][:, 1] = -boxes[:, 2]  # y_cam = -z_lidar
            anno["location"][:, 2] = boxes[:, 0]  # z_cam = x_lidar
            dxdydz = boxes[:, 3:6]
            anno["dimensions"] = dxdydz[:, [0, 2, 1]]  # lwh (lidar) -> lhw (cam)
            anno["rotation_y"] = -boxes[:, 6] - np.pi / 2
            anno["alpha"] = (-np.arctan2(-boxes[:, 1], boxes[:, 0])
                             + anno["rotation_y"])
        else:
            anno["location"] = anno["dimensions"] = np.zeros((0, 3))
            anno["rotation_y"] = anno["alpha"] = np.zeros(0)
    return annos


def calib_to_matricies(calib):
    """(lidar -> rect 4x4, P2)."""
    v2c = np.vstack((calib.V2C, np.array([0, 0, 0, 1], dtype=np.float32)))
    r0 = np.hstack((calib.R0, np.zeros((3, 1), dtype=np.float32)))
    r0 = np.vstack((r0, np.array([0, 0, 0, 1], dtype=np.float32)))
    return r0 @ v2c, calib.P2
