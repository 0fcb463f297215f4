"""V2X-Sim ego dataset: the lately-fusion data path.

Counterpart of ``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_ego.py``:
  * the ego's (lidar id 1) pseudo-sweeps;
  * the ground truth of every agent moved into the ego's frame and
    deduplicated with rotated NMS (``USE_GT_FROM_EVERY_AGENT``), optionally
    cut at ``EVAL_FILTER_GT_BEYOND_RANGE``;
  * each other agent's MoDAR boxes read from the exchange database at the
    previous keyframe (async) or the current one (``EXCHANGE_NOW``), advanced
    by twice their pooled scene flow (``load_and_propagate_modar``, unless
    ``EXCHANGE_FLOW_PROPAGATION`` is False) and appended as point rows
    (``modar_to_points``);
  * the levers ``EXCHANGE_ORACLE`` (the senders broadcast their gt with exact
    constant-velocity flow), ``EXCHANGE_ORACLE_FLOW`` (predicted boxes, the
    matched gt's flow) and ``EXCHANGE_DROPOUT`` (each agent's broadcast lost
    with that probability: drawn from ``default_rng(12345)`` in training,
    from a hash of (sample, agent) at evaluation so that it repeats).

The ego's points have 13 features: x, y, z, intensity, time | dx, dy, dz,
heading, score, label | sweep_idx, instance_idx.
"""
import copy
import hashlib
from pathlib import Path

import numpy as np

from ...exchange.database import ExchangeDatabase, points_in_boxes_np
from ...utils.geometry import apply_se3, se3_inverse
from ...utils.nms_np import nms_bev_np
from .source import NUM_AGENTS
from .v2x_sim_dataset_car import V2XSimDataset_CAR
from .v2x_sim_utils import get_pseudo_sweeps_of_1lidar

EGO_LIDAR_ID = 1

NUM_EGO_FEATURES = 13


def load_and_propagate_modar(db, sample_token, lidar_id, propagate=True):
    """A sender's MoDAR boxes from ``db`` (an ``ExchangeDatabase``),
    advanced by twice their mean scene flow when ``propagate``: the
    keyframe interval is twice the flow's horizon (constant velocity).

    Reads ``boxflow`` where the sender wrote it, else pools the flow of the
    ``foreground`` points in each ``modar`` box here. Returns ``(modar
    (N, 9), n_foreground)``, float64 from boxflow and the file's dtype from
    modar, where ``n_foreground`` counts the foreground rows read (0 under
    boxflow), or ``(None, 0)`` when the sender broadcast nothing for this
    keyframe."""
    boxflow = db.load(sample_token, lidar_id, "boxflow")
    if boxflow is not None:
        modar = boxflow[:, :9].copy()
        if propagate and modar.shape[0]:
            modar[:, :3] += boxflow[:, 9:12] * 2.0
        return modar, 0
    modar = db.load(sample_token, lidar_id, "modar")
    if modar is None:
        return None, 0
    modar = modar.copy()
    n_fg = 0
    if propagate:
        foregr = db.load(sample_token, lidar_id, "foreground")
        if foregr is not None and foregr.shape[0] > 0 and modar.shape[0] > 0:
            n_fg = int(foregr.shape[0])
            box_idx = points_in_boxes_np(foregr[:, :3], modar[:, :7])
            valid = box_idx > -1
            if valid.any():
                fg, bi = foregr[valid], box_idx[valid]
                for b in np.unique(bi):
                    modar[b, :3] += fg[bi == b, -3:].mean(axis=0) * 2.0
    return modar, n_fg


def modar_to_points(modar, target_se3_lidar, max_sweep_idx):
    """(N, 9) MoDAR boxes in the sender's lidar frame -> (N, 13) float64
    point rows in the ego's: the boxes moved by ``target_se3_lidar`` (4x4,
    sender lidar -> ego lidar), then the box center as xyz, time 0, the
    box's size, heading, score and label, the ego's newest sweep index and
    instance -1."""
    boxes = apply_se3(target_se3_lidar, boxes=modar[:, :7])  # in modar's dtype, as the JAX package
    rows = np.zeros((modar.shape[0], NUM_EGO_FEATURES))
    rows[:, :3] = boxes[:, :3]
    rows[:, 5:9] = boxes[:, 3:7]
    rows[:, 9:11] = modar[:, 7:9]
    rows[:, -2] = max_sweep_idx
    rows[:, -1] = -1
    return rows


class V2XSimDataset_EGO(V2XSimDataset_CAR):
    LIDAR_IDS = (EGO_LIDAR_ID,)

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self.exchange_now = bool(dataset_cfg.get("EXCHANGE_NOW", False))
        self.flow_propagation = bool(dataset_cfg.get("EXCHANGE_FLOW_PROPAGATION", True))
        # an absolute directory stands as given; a relative one lies under the data root
        exch_dir = self.root_path / dataset_cfg.get("EXCHANGE_DATABASE_DIRECTORY",
                                                    "exchange_database_flow")
        self.exchange_database = {lid: ExchangeDatabase(exch_dir) for lid in range(NUM_AGENTS)}
        self.exchange_with_rsu_only = bool(dataset_cfg.get("EXCHANGE_WITH_RSU_ONLY", False))
        self.exchange_oracle = bool(dataset_cfg.get("EXCHANGE_ORACLE", False))
        self.exchange_oracle_flow = bool(dataset_cfg.get("EXCHANGE_ORACLE_FLOW", False))
        self.exchange_dropout = float(dataset_cfg.get("EXCHANGE_DROPOUT", 0.0))
        self._exchange_rng = np.random.default_rng(12345)
        self._exchange_misses = 0

        if dataset_cfg.get("USE_GT_FROM_EVERY_AGENT", True):
            rng_limit = float(dataset_cfg.get("EVAL_FILTER_GT_BEYOND_RANGE", -1))
            for info in self.infos:
                gt_boxes, gt_names = self.get_all_ground_truth(info["lidar_token"])
                if rng_limit > 0:
                    kept = np.linalg.norm(gt_boxes[:, :2], axis=1) < rng_limit
                    if np.any(kept):
                        gt_boxes, gt_names = gt_boxes[kept], gt_names[kept]
                    else:
                        gt_boxes = np.zeros((1, gt_boxes.shape[1]))
                        gt_names = gt_names[[0]] if gt_names.shape[0] else np.array(["car"])
                info["gt_boxes"] = gt_boxes
                info["gt_names"] = gt_names

    def get_all_ground_truth(self, ego_lidar_token):
        """The gt of every agent in the ego's frame, deduplicated by greedy
        rotated BEV NMS at IoU 0.2 (equal scores: the first of each
        overlapping cluster stays)."""
        sample = self.source.sample_record("_".join(ego_lidar_token.split("_")[:-1]))
        ego_se3_glob = se3_inverse(self.source.get_pose(ego_lidar_token))
        gt_boxes, gt_names = [], []
        for lidar_name, lidar_token in sample["data"].items():
            if not lidar_name.startswith("LIDAR_TOP_id_"):
                continue
            frame = self.source.get_frame(lidar_token,
                                          classes_of_interest=tuple(self.classes_of_interest),
                                          threshold_boxes_by_points=1)
            if frame["boxes"].shape[0] == 0:
                continue
            gt_boxes.append(apply_se3(ego_se3_glob @ frame["glob_se3_lidar"],
                                      boxes=frame["boxes"].copy()))
            gt_names.append(frame["names"])
        if not gt_boxes:
            return np.zeros((0, 7)), np.zeros((0,), dtype="<U16")
        gt_boxes = np.concatenate(gt_boxes)
        gt_names = np.concatenate(gt_names)
        selected = nms_bev_np(gt_boxes[:, :7], np.ones(gt_boxes.shape[0]), 0.2)
        return gt_boxes[selected], gt_names[selected]

    # ------------------------------------------------------------- exchange
    def _exchange_agent_ids(self):
        ids = [0] if self.exchange_with_rsu_only else list(range(NUM_AGENTS))
        return [i for i in ids if i != EGO_LIDAR_ID]

    def _oracle_boxflow(self, lidar_token):
        """(N, 12) boxflow rows from the sender's gt at that keyframe: box7,
        score 1, the 1-based label, and half the keyframe's displacement as
        flow (the x2 propagation then advances each box by exactly one
        keyframe)."""
        frame = self.source.get_frame(lidar_token, classes_of_interest=tuple(self.class_names),
                                      threshold_boxes_by_points=1)
        boxes = frame["boxes"]
        out = np.zeros((boxes.shape[0], 12))
        if boxes.shape[0]:
            out[:, :7] = boxes[:, :7]
            out[:, 7] = 1.0
            name_to_label = {name: i + 1 for i, name in enumerate(self.class_names)}
            out[:, 8] = [name_to_label.get(nm, 1) for nm in frame["names"]]
            out[:, 9:12] = (boxes[:, :3] - frame["prev_boxes"][:, :3]) / 2.0
        return out

    def _load_and_propagate_modar(self, sample_token, lidar_id, propagate=True,
                                  lidar_token=None):
        """(modar (N, 9) or None, foreground rows read) of one agent."""
        if self.exchange_oracle and lidar_token is not None:
            boxflow = self._oracle_boxflow(lidar_token)
            modar = boxflow[:, :9].copy()
            if propagate and modar.shape[0]:
                modar[:, :3] += boxflow[:, 9:12] * 2.0
            return modar, 0
        if self.exchange_oracle_flow and lidar_token is not None:
            return self._predicted_modar_with_oracle_flow(sample_token, lidar_id, lidar_token,
                                                          propagate), 0
        modar, n_fg = load_and_propagate_modar(self.exchange_database[lidar_id], sample_token,
                                               lidar_id, propagate)
        if modar is None:
            # a sender broadcasts nothing for the first async frame; many
            # misses mean the database was never generated for this split
            self._exchange_misses += 1
            if self._exchange_misses == 50 and self.logger is not None:
                self.logger.warning(
                    "exchange database: 50 modar files missing so far (e.g. token="
                    f"{sample_token} id={lidar_id}): was the exchange database generated "
                    "for this split?")
        return modar, n_fg

    def _predicted_modar_with_oracle_flow(self, sample_token, lidar_id, lidar_token, propagate):
        """Predicted boxes, gt flow: each box takes the constant-velocity flow
        of the nearest gt centre within 2 m, else stays put."""
        db = self.exchange_database[lidar_id]
        modar = db.load(sample_token, lidar_id, "boxflow")
        modar = modar[:, :9].copy() if modar is not None else db.load(sample_token, lidar_id,
                                                                       "modar")
        if modar is None:
            return None
        modar = np.asarray(modar)[:, :9].copy()
        if propagate and modar.shape[0]:
            gt = self._oracle_boxflow(lidar_token)
            if gt.shape[0]:
                d = np.linalg.norm(modar[:, None, :2] - gt[None, :, :2], axis=-1)
                j = d.argmin(axis=1)
                matched = d[np.arange(modar.shape[0]), j] < 2.0
                modar[matched, :3] += gt[j[matched], 9:12] * 2.0
        return modar

    def _dropped(self, exch_token, lidar_id):
        if self.training:
            return self._exchange_rng.random() < self.exchange_dropout
        h = hashlib.blake2b(f"{exch_token}/{lidar_id}".encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") / 2.0**64 < self.exchange_dropout

    # --------------------------------------------------------------- getitem
    def get_item(self, index, rng):
        info = copy.deepcopy(self.infos[index])
        ego = get_pseudo_sweeps_of_1lidar(
            self.source, info["lidar_token"], self.num_historical_sweeps,
            self.classes_of_interest,
            points_in_boxes_by_gpu=self.dataset_cfg.get("POINTS_IN_BOXES_GPU", False),
            threshold_boxes_by_points=self.dataset_cfg.get("THRESHOLD_BOXES_BY_POINTS", 5))
        points = ego["points"]  # (N, 7)
        gt_boxes = info.get("gt_boxes", ego["gt_boxes"])
        gt_names = info.get("gt_names", ego["gt_names"])

        rows = np.zeros((points.shape[0], NUM_EGO_FEATURES))
        rows[:, :5] = points[:, :5]
        rows[:, -2:] = points[:, -2:]
        num_original = rows.shape[0]

        target_se3_glob = se3_inverse(self.source.get_pose(info["lidar_token"]))
        max_sweep_idx = points[:, -2].max() if points.shape[0] else 0.0
        sample_token = info["token"]
        sample = self.source.sample_record(sample_token)
        others = [i for i in range(NUM_AGENTS) if i != EGO_LIDAR_ID]
        exchange_metadata = {i: [0.0, 0.0] for i in others}
        exchange_coord = {i: np.zeros(3) for i in others}

        use_prev = sample["prev"] != "" and not self.exchange_now
        exch_sample = self.source.sample_record(sample["prev"]) if use_prev else sample
        if (use_prev or self.exchange_now) and self.dataset_cfg.get("EXCHANGE_MODAR", True):
            exch_token = exch_sample["token"]
            for lidar_name, lidar_token in exch_sample["data"].items():
                if not lidar_name.startswith("LIDAR_TOP_id_"):
                    continue
                lidar_id = int(lidar_name.split("_")[-1])
                if lidar_id not in self._exchange_agent_ids():
                    continue
                if self.exchange_dropout > 0.0 and self._dropped(exch_token, lidar_id):
                    continue
                modar, n_fg = self._load_and_propagate_modar(
                    exch_token, lidar_id, propagate=use_prev and self.flow_propagation,
                    lidar_token=lidar_token)
                if modar is None or modar.shape[0] == 0:
                    continue
                exchange_metadata[lidar_id][0] = float(n_fg)
                target_se3_lidar = target_se3_glob @ self.source.get_pose(lidar_token)
                modar_rows = modar_to_points(modar, target_se3_lidar, max_sweep_idx)
                exchange_metadata[lidar_id][1] = modar_rows.shape[0]
                exchange_coord[lidar_id] = target_se3_lidar[:3, 3]
                rows = np.concatenate([rows, modar_rows])

        input_dict = {
            "points": rows,
            "gt_boxes": np.asarray(gt_boxes, dtype=np.float64)[:, :7],
            "gt_names": np.asarray(gt_names),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"lidar_token": info["lidar_token"],
                         "num_sweeps_target": self.num_sweeps,
                         "sample_token": sample_token,
                         "lidar_id": EGO_LIDAR_ID,
                         "num_original": num_original,
                         "exchange": exchange_metadata,
                         "exchange_coord": exchange_coord},
        }
        return self.prepare_data(input_dict, rng)
