"""KITTI camera calibration: counterpart of ``pcp_tpu/utils/calibration_kitti.py``.

Parses P2, R0 and Tr_velo_to_cam from a KITTI ``calib/<id>.txt`` and maps
points between the lidar, the rectified camera and the image, in float32
numpy as the JAX package does.
"""
import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()

    def mat(line_idx, shape):
        vals = lines[line_idx].strip().split(" ")[1:]
        return np.array(vals, dtype=np.float32).reshape(shape)

    return {"P2": mat(2, (3, 4)), "P3": mat(3, (3, 4)), "R0": mat(4, (3, 3)),
            "Tr_velo2cam": mat(5, (3, 4))}


class Calibration:
    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) else get_calib_from_file(calib_file)
        self.P2 = calib["P2"]
        self.R0 = calib["R0"]
        self.V2C = calib["Tr_velo2cam"]
        self.cu, self.cv = self.P2[0, 2], self.P2[1, 2]
        self.fu, self.fv = self.P2[0, 0], self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def _rect_from_lidar_4x4(self):
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = self.R0
        v2c = np.eye(4, dtype=np.float32)
        v2c[:3, :4] = self.V2C
        return r0 @ v2c

    def rect_to_lidar(self, pts_rect):
        m = np.linalg.inv(self._rect_from_lidar_4x4())
        return (self.cart_to_hom(pts_rect) @ m.T)[:, 0:3]

    def lidar_to_rect(self, pts_lidar):
        return (self.cart_to_hom(pts_lidar) @ self._rect_from_lidar_4x4().T)[:, 0:3]

    def rect_to_img(self, pts_rect):
        hom = self.cart_to_hom(pts_rect) @ self.P2.T
        pts_img = hom[:, 0:2] / hom[:, 2:3]
        depth = hom[:, 2] - self.P2.T[3, 2]
        return pts_img, depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)
