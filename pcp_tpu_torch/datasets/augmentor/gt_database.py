"""The gt database of the gt sampler: counterpart of
``pcp_tpu/datasets/augmentor/gt_database.py``.

* :func:`create_groundtruth_database` walks an info list, crops each gt
  box's points (box-centred), writes one ``.bin`` per object and a
  ``{prefix}_dbinfos_{split}.pkl`` keyed by class, the format
  ``database_sampler.DataBaseSampler`` reads;
* :func:`create_integrated_database` packs every object's ``.bin`` into one
  ``.npy`` and stamps ``global_data_offset`` row ranges into the db-info pkl.

Host numpy throughout (offline tooling).
"""
import pickle
from pathlib import Path

import numpy as np


def _points_in_box_mask(points, box):
    """(N,) bool — points inside one (7,) box [x,y,z,dx,dy,dz,heading]."""
    rel = points[:, :3] - box[:3]
    c, s = np.cos(box[6]), np.sin(box[6])
    lx = c * rel[:, 0] + s * rel[:, 1]
    ly = -s * rel[:, 0] + c * rel[:, 1]
    return (np.abs(lx) < box[3] / 2) & (np.abs(ly) < box[4] / 2) & (np.abs(rel[:, 2]) < box[5] / 2)


def create_groundtruth_database(infos, get_lidar, root_path, db_prefix,
                                used_classes=None, split="train", logger=None):
    """Build the gt-paste database from an info list.

    Args:
        infos: list of info dicts with ``point_cloud.lidar_idx`` and ``annos``
            (``name``, ``gt_boxes_lidar``; optional ``difficulty``/``bbox``/
            ``score``/``index``).
        get_lidar: callable(sample_idx) -> (N, F) float32 points.
        root_path: dataset root; the database dir + info pkl land under it.
        db_prefix: e.g. ``"kitti"`` or ``"custom"`` — names the dbinfos pkl.
        used_classes: optional class whitelist for the info pkl (every
            object's .bin is still written).
        split: ``gt_database`` for train, ``gt_database_{split}`` otherwise.
    Returns:
        dict class_name -> list of db_info dicts (also pickled to disk).
    """
    root_path = Path(root_path)
    database_save_path = root_path / ("gt_database" if split == "train" else f"gt_database_{split}")
    db_info_save_path = root_path / f"{db_prefix}_dbinfos_{split}.pkl"
    database_save_path.mkdir(parents=True, exist_ok=True)
    all_db_infos = {}

    for k, info in enumerate(infos):
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = get_lidar(sample_idx)
        annos = info["annos"]
        names = annos["name"]
        gt_boxes = np.asarray(annos["gt_boxes_lidar"], dtype=np.float64)

        for i in range(gt_boxes.shape[0]):
            filename = f"{sample_idx}_{names[i]}_{i}.bin"
            filepath = database_save_path / filename
            gt_points = points[_points_in_box_mask(points, gt_boxes[i])].copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points.astype(np.float32).tofile(str(filepath))

            if used_classes is None or names[i] in used_classes:
                db_info = {
                    "name": names[i],
                    "path": str(filepath.relative_to(root_path)),
                    "image_idx": sample_idx,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": gt_points.shape[0],
                }
                for key in ("difficulty", "bbox", "score"):
                    if key in annos and len(annos[key]) > i:
                        db_info[key] = annos[key][i]
                all_db_infos.setdefault(names[i], []).append(db_info)

    for name, v in all_db_infos.items():
        msg = f"gt database {name}: {len(v)}"
        logger.info(msg) if logger is not None else print(msg)
    with open(db_info_save_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos


def create_integrated_database(db_info_path, root_path, new_db_name,
                               num_point_features=4, logger=None):
    """Pack the per-object .bin files into one ``{new_db_name}.npy`` and add
    ``global_data_offset`` (start, end) row ranges to the db-info pkl. The
    sampler then slices the resident array instead of opening a file per
    object.
    """
    db_info_path = Path(db_info_path)
    root_path = Path(root_path)
    global_db_path = root_path / f"{new_db_name}.npy"

    with open(db_info_path, "rb") as f:
        db_infos = pickle.load(f)

    start_idx = 0
    global_db_list = []
    for category, class_infos in db_infos.items():
        for info in class_infos:
            obj_points = np.fromfile(
                str(root_path / info["path"]), dtype=np.float32
            ).reshape(-1, num_point_features)
            assert obj_points.shape[0] == info["num_points_in_gt"], (
                f"{info['path']}: {obj_points.shape[0]} rows on disk vs "
                f"num_points_in_gt={info['num_points_in_gt']}"
            )
            info["global_data_offset"] = (start_idx, start_idx + obj_points.shape[0])
            start_idx += obj_points.shape[0]
            global_db_list.append(obj_points)

    global_db = (
        np.concatenate(global_db_list)
        if global_db_list
        else np.zeros((0, num_point_features), np.float32)
    )
    np.save(str(global_db_path), global_db)
    with open(db_info_path, "wb") as f:
        pickle.dump(db_infos, f)
    msg = f"integrated gt database: {global_db.shape} -> {global_db_path}"
    logger.info(msg) if logger is not None else print(msg)
    return db_infos, global_db
