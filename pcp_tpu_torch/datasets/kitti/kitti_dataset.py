"""The KITTI 3D object dataset: counterpart of
``pcp_tpu/datasets/kitti/kitti_dataset.py``.

At run time it reads the info pickles that :func:`create_kitti_infos` writes
and, per item, the frame's ``velodyne/<id>.bin``; with ``FOV_POINTS_ONLY``
it keeps the points that project into the image, and turns the camera-frame
labels into lidar boxes. Per-sample host objects (the calibration, the image
shape, the frame id) ride the ``metadata`` list of the padded collate.
:meth:`KittiDataset.generate_prediction_dicts` turns fixed-shape outputs
back into KITTI camera annotations, and :meth:`KittiDataset.evaluation` runs
the official AP (``kitti_eval/eval.py``).

Building the infos needs the raw tree (``ImageSets/``, ``training/{velodyne,
calib,label_2,image_2}``). An image's shape is read from its PNG header
(the IHDR chunk), with no imaging library; a frame without ``image_2/<id>.png``
takes the JAX package's fallback shape (375, 1242). A gt's
``num_points_in_gt`` counts its points in the field of view with
``ops/points_in_boxes.py`` in float32 on the CPU, the JAX package's rule.

    python -m pcp_tpu_torch.datasets.kitti.kitti_dataset create_kitti_infos \
        tools/cfgs/dataset_configs/kitti_dataset.yaml [--data_path data/kitti]

writes ``kitti_infos_{train,val,test}.pkl`` (the splits whose ``ImageSets``
file exists), the train gt database (``gt_database/``) and
``kitti_dbinfos_train.pkl`` under the data path.
"""
import argparse
import copy
import pickle
import struct
from pathlib import Path

import numpy as np
import torch

from ...config import ROOT_DIR, CfgDict, cfg_from_yaml_file
from ...ops.points_in_boxes import points_in_boxes_mask
from ...utils import box_utils
from ...utils.calibration_kitti import Calibration, get_calib_from_file
from ..dataset import DatasetTemplate

DEFAULT_IMAGE_SHAPE = (375, 1242)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def resolve_root(path):
    """A data path as the configs write it: absolute as given, relative with
    its leading ``../`` stripped and taken from the repository root."""
    path = Path(path)
    if path.is_absolute():
        return path
    stripped = str(path)
    while stripped.startswith("../"):
        stripped = stripped[3:]
    return ROOT_DIR / stripped


def png_shape(path):
    """(height, width) int32 from a PNG's IHDR chunk; None where the file is
    absent or not a PNG."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return None
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    w, h = struct.unpack(">II", head[16:24])
    return np.array([h, w], dtype=np.int32)


def count_points_in_boxes(points, boxes):
    """(M,) int: the points (N, 3+) inside each box (M, 7), in float32."""
    inside = points_in_boxes_mask(torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32)),
                                  torch.from_numpy(np.asarray(boxes, np.float32).reshape(-1, 7)))
    return inside.sum(dim=0).numpy()


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        root_path = resolve_root(root_path if root_path is not None else dataset_cfg["DATA_PATH"])
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        self.root_split_path = self.root_path / ("training" if self.split != "test" else "testing")
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = ([x.strip() for x in open(split_file).readlines()]
                               if split_file.exists() else None)
        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        for info_path in self.dataset_cfg.get("INFO_PATH", {}).get(mode, []):
            p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.kitti_infos.extend(pickle.load(f))
        if self.logger is not None:
            self.logger.info(f"Total samples for KITTI dataset: {len(self.kitti_infos)}")
        if not self.kitti_infos:
            raise FileNotFoundError(
                f"no KITTI infos found under {self.root_path}: run python -m "
                "pcp_tpu_torch.datasets.kitti.kitti_dataset create_kitti_infos <cfg> on the "
                "raw tree first")

    def get_lidar(self, idx):
        f = self.root_split_path / "velodyne" / f"{idx}.bin"
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return Calibration(str(self.root_split_path / "calib" / f"{idx}.txt"))

    def get_image_shape(self, idx):
        shape = png_shape(self.root_split_path / "image_2" / f"{idx}.png")
        return shape if shape is not None else np.array(DEFAULT_IMAGE_SHAPE, dtype=np.int32)

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val_flag_1 = np.logical_and(pts_img[:, 0] >= 0, pts_img[:, 0] < img_shape[1])
        val_flag_2 = np.logical_and(pts_img[:, 1] >= 0, pts_img[:, 1] < img_shape[0])
        return np.logical_and(np.logical_and(val_flag_1, val_flag_2), pts_rect_depth >= 0)

    def __len__(self):
        return len(self.kitti_infos)

    def get_item(self, index, rng):
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        img_shape = info["image"]["image_shape"]
        calib = Calibration(info["calib"]) if "calib" in info else self.get_calib(sample_idx)

        input_dict = {"frame_id": sample_idx}
        if "annos" in info:
            annos = {k: np.asarray(v) for k, v in info["annos"].items()}
            keep = annos["name"] != "DontCare"
            gt_boxes_camera = np.concatenate(
                [annos["location"][keep], annos["dimensions"][keep],
                 annos["rotation_y"][keep][..., None]], axis=1).astype(np.float32)
            gt_boxes_lidar = box_utils.boxes3d_kitti_camera_to_lidar(gt_boxes_camera, calib)
            input_dict.update({"gt_names": annos["name"][keep],
                               "gt_boxes": gt_boxes_lidar.astype(np.float64)})

        points = self.get_lidar(sample_idx)
        if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            points = points[self.get_fov_flag(pts_rect, img_shape, calib)]
        input_dict["points"] = points
        input_dict["metadata"] = {"calib": calib, "image_shape": np.asarray(img_shape),
                                  "frame_id": sample_idx}
        return self.prepare_data(input_dict, rng)

    def generate_prediction_dicts(self, batch_dict, final_box_dicts, class_names,
                                  output_path=None):
        """Fixed-shape outputs (numpy) -> one KITTI camera annotation per
        sample; with ``output_path`` also ``<frame_id>.txt`` in KITTI's
        label format."""
        annos = []
        for i in range(batch_dict["batch_size"]):
            meta = batch_dict["metadata"][i]
            valid = np.asarray(final_box_dicts["pred_valid"][i])
            boxes = np.asarray(final_box_dicts["pred_boxes"][i])[valid][:, :7]
            scores = np.asarray(final_box_dicts["pred_scores"][i])[valid]
            labels = np.asarray(final_box_dicts["pred_labels"][i])[valid]
            n = boxes.shape[0]
            anno = {"name": np.zeros(n, dtype=object), "truncated": np.zeros(n),
                    "occluded": np.zeros(n), "alpha": np.zeros(n), "bbox": np.zeros([n, 4]),
                    "dimensions": np.zeros([n, 3]), "location": np.zeros([n, 3]),
                    "rotation_y": np.zeros(n), "score": np.zeros(n), "boxes_lidar": boxes,
                    "frame_id": meta["frame_id"]}
            if n:
                calib = meta["calib"]
                cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
                img = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam, calib, image_shape=meta["image_shape"])
                anno["name"] = np.array(class_names)[labels - 1]
                anno["alpha"] = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
                anno["bbox"] = img
                anno["dimensions"] = cam[:, 3:6]
                anno["location"] = cam[:, 0:3]
                anno["rotation_y"] = cam[:, 6]
                anno["score"] = scores
            annos.append(anno)
            if output_path is not None:
                with open(Path(output_path) / f"{meta['frame_id']}.txt", "w") as f:
                    for k in range(n):
                        bb, lo, dd = anno["bbox"][k], anno["location"][k], anno["dimensions"][k]
                        print("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                              "%.4f %.4f" % (anno["name"][k], anno["alpha"][k], bb[0], bb[1],
                                             bb[2], bb[3], dd[1], dd[2], dd[0], lo[0], lo[1],
                                             lo[2], anno["rotation_y"][k], anno["score"][k]),
                              file=f)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """(AP table text, R40 results) of ``det_annos`` against the infos'
        annotations."""
        if "annos" not in self.kitti_infos[0]:
            return "no GT annos", {}
        from .kitti_eval import eval as kitti_eval

        eval_gt = [copy.deepcopy(info["annos"]) for info in self.kitti_infos]
        return kitti_eval.get_official_eval_result(eval_gt, copy.deepcopy(det_annos), class_names)

    def get_infos(self, has_label=True, count_inside_pts=True, sample_id_list=None):
        """The infos of the raw frames: calibration, image shape and, with
        labels, the annotations with difficulty, lidar boxes and the points
        in each gt."""
        infos = []
        for sample_idx in (sample_id_list or self.sample_id_list or []):
            calib_dict = get_calib_from_file(self.root_split_path / "calib" / f"{sample_idx}.txt")
            calib = Calibration(calib_dict)
            info = {"point_cloud": {"num_features": 4, "lidar_idx": sample_idx},
                    "image": {"image_idx": sample_idx,
                              "image_shape": self.get_image_shape(sample_idx)},
                    "calib": calib_dict}
            if has_label:
                lines = open(self.root_split_path / "label_2" / f"{sample_idx}.txt").readlines()
                objs = [line.strip().split(" ") for line in lines if line.strip()]
                annos = {
                    "name": np.array([o[0] for o in objs]),
                    "truncated": np.array([float(o[1]) for o in objs]),
                    "occluded": np.array([int(float(o[2])) for o in objs]),
                    "alpha": np.array([float(o[3]) for o in objs]),
                    "bbox": np.array([[float(v) for v in o[4:8]] for o in objs]).reshape(-1, 4),
                    "dimensions": np.array([[float(o[10]), float(o[8]), float(o[9])]
                                            for o in objs]).reshape(-1, 3),  # lhw
                    "location": np.array([[float(v) for v in o[11:14]] for o in objs]).reshape(-1, 3),
                    "rotation_y": np.array([float(o[14]) for o in objs]),
                    "score": np.array([float(o[15]) if len(o) > 15 else -1.0 for o in objs]),
                }
                # KITTI's difficulty: the 2D box's height, occlusion, truncation
                bb_h = annos["bbox"][:, 3] - annos["bbox"][:, 1]
                occ, trunc = annos["occluded"], annos["truncated"]
                difficulty = np.full(len(objs), -1, dtype=np.int32)
                difficulty[(bb_h >= 25) & (occ <= 2) & (trunc <= 0.50)] = 2
                difficulty[(bb_h >= 25) & (occ <= 1) & (trunc <= 0.30)] = 1
                difficulty[(bb_h >= 40) & (occ <= 0) & (trunc <= 0.15)] = 0
                annos["difficulty"] = difficulty
                num_objects = int((annos["name"] != "DontCare").sum())
                annos["index"] = np.concatenate(
                    [np.arange(num_objects), -np.ones(len(objs) - num_objects)]).astype(np.int32)
                gt_cam = np.concatenate([annos["location"], annos["dimensions"],
                                         annos["rotation_y"][..., None]], axis=1)[:num_objects]
                annos["gt_boxes_lidar"] = box_utils.boxes3d_kitti_camera_to_lidar(gt_cam, calib)
                if count_inside_pts:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib.lidar_to_rect(points[:, 0:3])
                    fov = self.get_fov_flag(pts_rect, info["image"]["image_shape"], calib)
                    cnt = count_points_in_boxes(points[fov], annos["gt_boxes_lidar"])
                    annos["num_points_in_gt"] = np.concatenate(
                        [cnt, -np.ones(len(objs) - num_objects)]).astype(np.int32)
                info["annos"] = annos
            infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path=None, used_classes=None, split="train"):
        """One box-centred ``.bin`` per object and ``kitti_dbinfos_{split}.pkl``."""
        from ..augmentor.gt_database import create_groundtruth_database

        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        return create_groundtruth_database(infos, self.get_lidar, self.root_path, "kitti",
                                           used_classes=used_classes, split=split,
                                           logger=self.logger)


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path, with_gt_database=True):
    """``kitti_infos_{train,val,test}.pkl`` under ``save_path`` for the
    splits whose ``ImageSets`` file exists, and the train gt database."""
    dataset = KittiDataset.__new__(KittiDataset)
    DatasetTemplate.__init__(dataset, dataset_cfg, class_names, False, data_path, None)
    for split, has_label in (("train", True), ("val", True), ("test", False)):
        dataset.split = split
        dataset.root_split_path = Path(data_path) / ("training" if split != "test" else "testing")
        ids_file = Path(data_path) / "ImageSets" / f"{split}.txt"
        if not ids_file.exists():
            continue
        dataset.sample_id_list = [x.strip() for x in open(ids_file).readlines()]
        infos = dataset.get_infos(has_label=has_label)
        out = Path(save_path) / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"KITTI infos {split}: {len(infos)} -> {out}")
        if split == "train" and with_gt_database:
            dataset.create_groundtruth_database(info_path=out, split=split)


def main(argv=None):
    parser = argparse.ArgumentParser(description="build KITTI infos and the gt database")
    parser.add_argument("func", choices=("create_kitti_infos",))
    parser.add_argument("cfg_file", help="the dataset config (kitti_dataset.yaml)")
    parser.add_argument("--data_path", default=None,
                        help="the raw tree (default: the config's DATA_PATH)")
    parser.add_argument("--class_names", nargs="+", default=["Car", "Pedestrian", "Cyclist"])
    args = parser.parse_args(argv)
    path = Path(args.cfg_file)
    if not path.is_absolute() and not path.exists():
        path = ROOT_DIR / path
    cfg = cfg_from_yaml_file(path, CfgDict())
    data_path = resolve_root(args.data_path or cfg.DATA_PATH)
    create_kitti_infos(cfg, args.class_names, data_path, data_path)


if __name__ == "__main__":
    main()
