"""V2X-Sim data sources: counterpart of ``pcp_tpu/datasets/v2x_sim/source.py``.

``SyntheticV2XSource`` is a deterministic procedural world with V2X-Sim's
schema: 6 agents (the RSU, lidar id 0, and cars 1..5), object trajectories,
per-agent LiDAR clouds, a town-based train/val split. Every draw comes from a
generator seeded by an md5 hash of its key (``_rng_for``), so the same
config gives the same world, point for point, in both packages.
``NuScenesV2XSource`` reads the real V2X-Sim 2.0 through the nuScenes devkit,
or through any object with the devkit's table interface handed to it
(``.sample`` and ``.scene`` lists, ``.get(table, token)``,
``.get_sample_data_path(token)``). Its instance ids are
``abs(hash(instance_token)) % 2**62``, the JAX package's rule: Python salts
``hash`` of a string per process (``PYTHONHASHSEED``), so the ids agree only
within one process (ROADMAP C).

A "frame" returned by a source:
    points:        (N, 4) x, y, z, intensity, in the agent's lidar frame
    boxes:         (M, 7) current gt boxes, in the agent's lidar frame
    prev_boxes:    (M, 7) the same instances at the previous keyframe, in the
                   *current* lidar frame (a copy of the current one at kf 0)
    names:         (M,) class names
    instance_ids:  (M,) global instance ids (ints)
    glob_se3_lidar:(4, 4) lidar pose in the global frame
"""
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ...native import points_in_boxes_np
from ...utils.geometry import apply_se3, make_se3, quat_to_rotmat, se3_inverse, wrap_angle

KEYFRAME_DT = 0.2  # seconds between keyframes (V2X-Sim annotates at 5 Hz)
NUM_AGENTS = 6  # lidar ids 0 (RSU) .. 5


def _rng_for(*key):
    h = hashlib.md5("_".join(str(k) for k in key).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


@dataclass
class SceneSpec:
    token: str
    town: int
    num_keyframes: int
    seed: int


class SyntheticV2XSource:
    """Procedural multi-agent world. Deterministic per (data root, scene).

    Two world layouts:

    * ``world='open'`` — objects and agents drift freely on an open plane.
      Occlusion is only ever momentary (everything moves, nothing is large),
      so a single agent with 11 pseudo-sweeps sees nearly every object and
      collaborative modes cannot beat it (the round-2 finding).
    * ``world='urban'`` — a Manhattan grid like the CARLA towns V2X-Sim is
      rendered from: streets at +-40 m and 0 on both axes, city blocks filled
      with tall buildings (persistent occluders no sweep horizon defeats),
      moving traffic + parked cars + pedestrians constrained to the streets,
      CAVs driving on streets and an elevated RSU at an intersection. An ego
      on one street cannot see the parallel streets at all — only
      collaborators (different streets / the RSU) cover them, which is what
      makes collaboration *necessary*, reproducing the reference's
      single-agent-is-the-floor table shape (ref README.md:50-54).
    """

    # street grid for world='urban' (centerlines, both axes)
    STREETS = (-40.0, 0.0, 40.0)
    HALF_ROAD = 8.0  # street half-width: road edge at centerline +- 8 m
    BLOCK_CENTERS = (-60.0, -20.0, 20.0, 60.0)
    GROUND_Z = -2.0

    def __init__(self, num_scenes=4, keyframes_per_scene=12, num_cars=24, num_peds=8, seed=0,
                 world="open", num_parked=0, visible_faces=False, car_profile=None):
        self.num_scenes = num_scenes
        self.keyframes_per_scene = keyframes_per_scene
        self.num_cars = num_cars
        self.num_peds = num_peds
        self.world = world
        self.num_parked = num_parked
        self.visible_faces = visible_faces
        # Sedan silhouette (hood compressed ahead of the cabin). A plain
        # cuboid's surface cloud is EXACTLY invariant under a heading flip —
        # even with visible-face weighting, the flipped box's sensor-facing
        # faces are congruent rectangles landing in the same world positions
        # (measured: flip L1 distance == resampling noise floor). So a static
        # car's heading DIRECTION is unlearnable from shape alone unless the
        # shape itself is front/back asymmetric, which is how real lidar
        # disambiguates. Defaults to visible_faces so the VF world gets both.
        self.car_profile = visible_faces if car_profile is None else car_profile
        self.seed = seed
        self.scenes: List[SceneSpec] = [
            SceneSpec(
                token=f"scene{si}",
                town=3 + (si % 3),  # towns 4,5 -> train; town 3 -> val (ref split)
                num_keyframes=keyframes_per_scene,
                seed=seed * 1000 + si,
            )
            for si in range(num_scenes)
        ]
        self._scene_cache: Dict[str, dict] = {}

    # ------------------------------------------------------------- world gen
    def _street_slot(self, rng):
        """Random street pose: returns (axis, street, dir_sign).
        axis 0 = travel along x on a horizontal street y=street; axis 1 =
        travel along y on a vertical street x=street."""
        axis = int(rng.integers(0, 2))
        street = float(self.STREETS[int(rng.integers(0, len(self.STREETS)))])
        d = float(rng.choice([-1.0, 1.0]))
        return axis, street, d

    def _on_street(self, axis, street, along, lateral):
        """(x, y) for a position `along` the street with `lateral` offset."""
        return (np.array([along, street + lateral]) if axis == 0
                else np.array([street + lateral, along]))

    def _street_heading(self, axis, d):
        return 0.0 if (axis == 0 and d > 0) else (np.pi if axis == 0 else d * np.pi / 2)

    def _scene_buildings(self, scene: SceneSpec):
        """Static block-filling occluders for world='urban' (not GT)."""
        if self.world != "urban":
            return []
        rng = _rng_for("bldg", scene.seed)
        buildings = []
        bid = 1 << 20  # instance ids far above object ids
        for bx in self.BLOCK_CENTERS:
            for by in self.BLOCK_CENTERS:
                if rng.uniform() < 0.15:  # empty lot
                    continue
                h = rng.uniform(5.0, 9.0)
                buildings.append(
                    dict(
                        instance_id=bid,
                        name="building",
                        dims=np.array([rng.uniform(17.0, 22.0), rng.uniform(17.0, 22.0), h]),
                        pos0=np.array([bx + rng.uniform(-1, 1), by + rng.uniform(-1, 1),
                                       self.GROUND_Z + h / 2]),
                        heading0=0.0,
                        vel=np.zeros(3),
                        yaw_rate=0.0,
                    )
                )
                bid += 1
        return buildings

    def _scene_objects_urban(self, scene: SceneSpec):
        rng = _rng_for("objs", scene.seed)
        objs = []
        iid = 0
        for _ in range(self.num_cars):
            axis, street, d = self._street_slot(rng)
            speed = rng.uniform(2.0, 10.0)
            heading = self._street_heading(axis, d)
            xy = self._on_street(axis, street, rng.uniform(-65, 65), -3.0 * d if axis == 0 else 3.0 * d)
            objs.append(
                dict(
                    instance_id=iid,
                    name="car",
                    dims=np.array([rng.uniform(4.0, 5.0), rng.uniform(1.7, 2.1), rng.uniform(1.4, 1.9)]),
                    pos0=np.array([xy[0], xy[1], rng.uniform(-1.6, -1.2)]),
                    heading0=heading,
                    vel=np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0]),
                    yaw_rate=0.0,
                )
            )
            iid += 1
        for _ in range(self.num_parked):
            axis, street, d = self._street_slot(rng)
            heading = self._street_heading(axis, d)
            xy = self._on_street(axis, street, rng.uniform(-65, 65), 6.3 * d)
            objs.append(
                dict(
                    instance_id=iid,
                    name="car",
                    dims=np.array([rng.uniform(4.0, 5.0), rng.uniform(1.7, 2.1), rng.uniform(1.4, 1.9)]),
                    pos0=np.array([xy[0], xy[1], rng.uniform(-1.6, -1.2)]),
                    heading0=heading,
                    vel=np.zeros(3),
                    yaw_rate=0.0,
                )
            )
            iid += 1
        for _ in range(self.num_peds):
            axis, street, d = self._street_slot(rng)
            speed = rng.uniform(0.0, 1.5)
            heading = self._street_heading(axis, d)
            xy = self._on_street(axis, street, rng.uniform(-60, 60), 7.3 * d)
            objs.append(
                dict(
                    instance_id=iid,
                    name="pedestrian",
                    dims=np.array([0.7, 0.7, rng.uniform(1.6, 1.9)]),
                    pos0=np.array([xy[0], xy[1], rng.uniform(-1.2, -0.8)]),
                    heading0=heading,
                    vel=np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0]),
                    yaw_rate=0.0,
                )
            )
            iid += 1
        return objs

    def _scene_objects(self, scene: SceneSpec):
        if scene.token in self._scene_cache:
            return self._scene_cache[scene.token]
        if self.world == "urban":
            objs = self._scene_objects_urban(scene) + self._scene_buildings(scene)
            self._scene_cache[scene.token] = objs
            return objs
        rng = _rng_for("objs", scene.seed)
        objs = []
        for i in range(self.num_cars):
            speed = rng.uniform(0.0, 10.0)
            heading = rng.uniform(-np.pi, np.pi)
            objs.append(
                dict(
                    instance_id=i,
                    name="car",
                    dims=np.array(
                        [rng.uniform(4.0, 5.0), rng.uniform(1.7, 2.1), rng.uniform(1.4, 1.9)]
                    ),
                    pos0=np.array([rng.uniform(-60, 60), rng.uniform(-60, 60), rng.uniform(-1.6, -1.2)]),
                    heading0=heading,
                    vel=np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0]),
                    yaw_rate=rng.uniform(-0.15, 0.15),
                )
            )
        for i in range(self.num_peds):
            speed = rng.uniform(0.0, 1.5)
            heading = rng.uniform(-np.pi, np.pi)
            objs.append(
                dict(
                    instance_id=self.num_cars + i,
                    name="pedestrian",
                    dims=np.array([0.7, 0.7, rng.uniform(1.6, 1.9)]),
                    pos0=np.array([rng.uniform(-50, 50), rng.uniform(-50, 50), rng.uniform(-1.2, -0.8)]),
                    heading0=heading,
                    vel=np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0]),
                    yaw_rate=0.0,
                )
            )
        self._scene_cache[scene.token] = objs
        return objs

    def _object_pose(self, obj, t):
        """Global box at time t (seconds)."""
        pos = obj["pos0"] + obj["vel"] * t
        heading = wrap_angle(obj["heading0"] + obj["yaw_rate"] * t)
        return pos, heading

    def _agent_pose(self, scene: SceneSpec, lidar_id: int, t: float):
        """Global 4x4 pose of an agent's lidar at time t."""
        rng = _rng_for("agent", scene.seed, lidar_id)
        if self.world == "urban":
            if lidar_id == 0:  # RSU: static, elevated, at an intersection
                sx = float(self.STREETS[int(rng.integers(0, len(self.STREETS)))])
                sy = float(self.STREETS[int(rng.integers(0, len(self.STREETS)))])
                pos = np.array([sx + rng.uniform(-2, 2), sy + rng.uniform(-2, 2), 3.5])
                return make_se3(pos, yaw=rng.uniform(-np.pi, np.pi))
            axis, street, d = self._street_slot(rng)
            yaw = self._street_heading(axis, d)
            xy = self._on_street(axis, street, rng.uniform(-45, 45),
                                 -3.0 * d if axis == 0 else 3.0 * d)
            speed = rng.uniform(3.0, 9.0)
            vel = np.array([speed * np.cos(yaw), speed * np.sin(yaw), 0.0])
            return make_se3(np.array([xy[0], xy[1], 1.8]) + vel * t, yaw=yaw)
        if lidar_id == 0:  # RSU: static, elevated
            pos = np.array([rng.uniform(-15, 15), rng.uniform(-15, 15), 3.0])
            yaw = rng.uniform(-np.pi, np.pi)
            return make_se3(pos, yaw=yaw)
        start = np.array([rng.uniform(-45, 45), rng.uniform(-45, 45), 1.8])
        yaw = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(3.0, 9.0)
        vel = np.array([speed * np.cos(yaw), speed * np.sin(yaw), 0.0])
        return make_se3(start + vel * t, yaw=yaw)

    # --------------------------------------------------------------- tokens
    def sample_token(self, scene: SceneSpec, kf: int) -> str:
        return f"{scene.token}_kf{kf}"

    def lidar_token(self, scene: SceneSpec, kf: int, lidar_id: int) -> str:
        return f"{scene.token}_kf{kf}_id{lidar_id}"

    def parse_lidar_token(self, lidar_token: str):
        scene_token, kf_s, id_s = lidar_token.split("_")
        scene = next(s for s in self.scenes if s.token == scene_token)
        return scene, int(kf_s[2:]), int(id_s[2:])

    def iter_samples(self):
        for scene in self.scenes:
            for kf in range(scene.num_keyframes):
                yield scene, kf

    def sample_record(self, sample_token: str):
        """Mimics nusc.sample: data dict mapping lidar names to tokens + prev."""
        scene_token, kf_s = sample_token.split("_")
        scene = next(s for s in self.scenes if s.token == scene_token)
        kf = int(kf_s[2:])
        data = {
            f"LIDAR_TOP_id_{lid}": self.lidar_token(scene, kf, lid) for lid in range(NUM_AGENTS)
        }
        return {
            "token": sample_token,
            "data": data,
            "prev": self.sample_token(scene, kf - 1) if kf > 0 else "",
            "next": self.sample_token(scene, kf + 1) if kf < scene.num_keyframes - 1 else "",
            "scene_token": scene.token,
            "timestamp": int(kf * KEYFRAME_DT * 1e6),
        }

    # ---------------------------------------------------------------- frame
    def get_pose(self, lidar_token: str) -> np.ndarray:
        scene, kf, lid = self.parse_lidar_token(lidar_token)
        return self._agent_pose(scene, lid, kf * KEYFRAME_DT)

    # azimuth resolution of the occlusion model (bins over 2*pi)
    OCCLUSION_BINS = 2048

    def _lidar_points_for_agent(self, scene, kf, lid, objs_global):
        """Simulated LiDAR return: surface samples on visible objects + ground.

        Occlusion model (what makes collaboration non-trivial — without it a
        single agent sees every box and saturates eval): objects are
        processed nearest-first; each occupies an azimuth interval with the
        elevation angle of its top edge, and a farther object only returns
        points from the azimuth bins where its own top edge rises above the
        accumulated occluder horizon (so a tall RSU sees over cars, while a
        car behind a car is shadowed). Points scale with the visible
        fraction; <15% visible yields no return.
        """
        rng = _rng_for("pts", scene.seed, kf, lid)
        pose = self._agent_pose(scene, lid, kf * KEYFRAME_DT)
        inv_pose = se3_inverse(pose)
        sensor = pose[:3, 3]

        # sensing range: urban street-level agents model a car-grade LiDAR
        # (dense returns out to ~48 m); the elevated RSU keeps the long range.
        # Limited per-agent range + persistent building occlusion are the two
        # mechanisms that make collaboration necessary (ref README.md:50-54).
        if self.world == "urban" and lid != 0:
            max_range = 48.0
        else:
            max_range = 70.0

        nbins = self.OCCLUSION_BINS
        horizon = np.full(nbins, -np.inf)  # per-bin max occluder elevation
        # Ground-shadow raster (azimuth x range). Every occluder shadows the
        # ground behind it: from its own distance out to where rays grazing
        # its top edge re-hit the ground (infinity when the top is above the
        # sensor, e.g. buildings). Without this the ground disk leaks points
        # into occluded areas and every "hidden" box still collects ground
        # returns (boxes wrap down to the road surface), defeating the
        # >=1-point GT visibility test.
        n_rbins = 64
        r_max_grid = 70.0
        ground_shadow = np.zeros((nbins, n_rbins), dtype=bool)
        ground_z = self.GROUND_Z

        order = sorted(
            range(len(objs_global)),
            key=lambda i: np.linalg.norm((objs_global[i][0] - sensor)[:2]),
        )
        pts = []
        for oi in order:
            pos, heading, dims, _name, _iid = objs_global[oi]
            rel = pos - sensor
            d = np.linalg.norm(rel[:2])
            if d > max_range:
                continue
            theta = np.arctan2(rel[1], rel[0])
            half_width = np.arctan2(max(dims[0], dims[1]) / 2, max(d, 1.0))
            top_z = pos[2] + dims[2] / 2
            elev = np.arctan2(top_z - sensor[2], max(d, 1.0))
            b0 = int((theta - half_width + np.pi) / (2 * np.pi) * nbins)
            b1 = int((theta + half_width + np.pi) / (2 * np.pi) * nbins)
            bins = np.arange(b0, b1 + 1) % nbins
            visible_frac = float(np.mean(elev > horizon[bins])) if len(bins) else 1.0
            # the object itself becomes an occluder over its interval
            horizon[bins] = np.maximum(horizon[bins], elev)
            if len(bins) and visible_frac > 0.0:
                if top_z >= sensor[2]:
                    r_end = r_max_grid
                else:
                    # ray over the top edge re-hits the ground at r_end
                    r_end = d * (sensor[2] - ground_z) / max(sensor[2] - top_z, 1e-3)
                i0 = int(d / r_max_grid * n_rbins)
                i1 = min(int(np.ceil(r_end / r_max_grid * n_rbins)), n_rbins)
                if i1 > i0:
                    ground_shadow[np.ix_(bins, range(i0, i1))] = True
            if visible_frac < 0.15:
                continue
            n = int(np.clip(4000.0 / max(d, 2.0) ** 1.5, 8, 300) * visible_frac)
            if n < 4:
                continue
            # sample on the box surface (sides + top), in box frame
            u = rng.uniform(-0.5, 0.5, size=(n, 3))
            if self.visible_faces:
                # Real-lidar face visibility: only sensor-facing faces return
                # points, weighted by projected area (area x incidence
                # cosine). NOTE: this alone does NOT make heading direction
                # learnable — a plain cuboid's visible cloud is still exactly
                # flip-symmetric (the flipped box's sensor-facing faces are
                # congruent rectangles in the same world positions). The
                # sedan-profile carve below (car_profile) is what breaks the
                # 180-degree ambiguity; VF makes the self-occlusion realistic.
                c0, s0 = np.cos(heading), np.sin(heading)
                dl = np.array([(sensor[0] - pos[0]) * c0 + (sensor[1] - pos[1]) * s0,
                               -(sensor[0] - pos[0]) * s0 + (sensor[1] - pos[1]) * c0,
                               sensor[2] - pos[2]])
                dl /= max(np.linalg.norm(dl), 1e-6)
                # the sedan carve (below) compresses the front (+x) face to
                # 65% height, so weight it by its carved area — otherwise the
                # forward face is over-dense relative to its true surface
                fx = 0.65 if (self.car_profile and _name == "car") else 1.0
                w = np.array([
                    max(dl[0], 0.0) * dims[1] * dims[2] * fx,  # +x face (carved)
                    max(-dl[0], 0.0) * dims[1] * dims[2],  # -x face
                    max(dl[1], 0.0) * dims[0] * dims[2],   # +y face
                    max(-dl[1], 0.0) * dims[0] * dims[2],  # -y face
                    max(dl[2], 0.0) * dims[0] * dims[1],   # top face
                ])
                w = w / max(w.sum(), 1e-6)
                face = rng.choice(5, size=n, p=w)
            else:
                face = rng.integers(0, 5, size=n)
            u[face == 0, 0] = 0.5
            u[face == 1, 0] = -0.5
            u[face == 2, 1] = 0.5
            u[face == 3, 1] = -0.5
            u[face == 4, 2] = 0.5
            local = u * dims
            if self.car_profile and _name == "car":
                # carve the sedan silhouette: forward of the cabin front
                # (x > 0.15 L) the surface compresses to hood height (65% of
                # the box), making the cloud front/back asymmetric so heading
                # direction is geometrically identifiable (points stay inside
                # the GT box; eval/IoU unaffected)
                front = local[:, 0] > 0.15 * dims[0]
                local[front, 2] = -dims[2] / 2 + (local[front, 2] + dims[2] / 2) * 0.65
            c, s = np.cos(heading), np.sin(heading)
            world = np.stack(
                [
                    pos[0] + local[:, 0] * c - local[:, 1] * s,
                    pos[1] + local[:, 0] * s + local[:, 1] * c,
                    pos[2] + local[:, 2],
                ],
                axis=1,
            )
            pts.append(world)

        # ground plane + clutter around the agent (rays blocked by full
        # occluders return nothing beyond them)
        n_ground = 4096
        r = np.sqrt(rng.uniform(4.0, min(55.0, max_range + 7.0) ** 2, size=n_ground))
        th = rng.uniform(-np.pi, np.pi, size=n_ground)
        gbins = ((th + np.pi) / (2 * np.pi) * nbins).astype(int) % nbins
        grbins = np.clip((r / r_max_grid * n_rbins).astype(int), 0, n_rbins - 1)
        keep_g = ~ground_shadow[gbins, grbins]
        r, th = r[keep_g], th[keep_g]
        ground = np.stack(
            [
                pose[0, 3] + r * np.cos(th),
                pose[1, 3] + r * np.sin(th),
                rng.normal(-2.0, 0.05, size=r.shape[0]),
            ],
            axis=1,
        )
        pts.append(ground)

        world_pts = np.concatenate(pts, axis=0)
        local_pts = apply_se3(inv_pose, points=world_pts)
        intensity = rng.uniform(0.0, 1.0, size=(local_pts.shape[0], 1))
        return np.concatenate([local_pts, intensity], axis=1).astype(np.float32)

    def get_frame(self, lidar_token: str, classes_of_interest=("car", "pedestrian"),
                  threshold_boxes_by_points: Optional[int] = 1, box_range: float = 70.0):
        """Full frame bundle in the agent's lidar frame (see module docstring)."""
        scene, kf, lid = self.parse_lidar_token(lidar_token)
        t = kf * KEYFRAME_DT
        objs = self._scene_objects(scene)

        objs_global = []
        for o in objs:
            pos, heading = self._object_pose(o, t)
            objs_global.append((pos, heading, o["dims"], o["name"], o["instance_id"]))

        points = self._lidar_points_for_agent(scene, kf, lid, objs_global)

        pose = self._agent_pose(scene, lid, t)
        inv_pose = se3_inverse(pose)
        boxes, prev_boxes, names, iids = [], [], [], []
        for o in objs:
            if o["name"] not in classes_of_interest:
                continue
            pos, heading = self._object_pose(o, t)
            if np.linalg.norm(pos[:2] - pose[:3, 3][:2]) > box_range:
                continue
            box_g = np.concatenate([pos, o["dims"], [heading]])
            t_prev = max(t - KEYFRAME_DT, 0.0)
            pos_p, heading_p = self._object_pose(o, t_prev)
            box_p = np.concatenate([pos_p, o["dims"], [heading_p]])
            boxes.append(box_g)
            prev_boxes.append(box_p)
            names.append(o["name"])
            iids.append(o["instance_id"])

        if boxes:
            boxes = apply_se3(inv_pose, boxes=np.asarray(boxes, dtype=np.float64))
            prev_boxes = apply_se3(inv_pose, boxes=np.asarray(prev_boxes, dtype=np.float64))
            names = np.asarray(names)
            iids = np.asarray(iids)
        else:
            boxes = np.zeros((0, 7))
            prev_boxes = np.zeros((0, 7))
            names = np.zeros((0,), dtype="<U16")
            iids = np.zeros((0,), dtype=np.int64)

        # count points in boxes; drop below-threshold boxes (reference
        # find_nonempty_boxes, v2x_sim_utils.py:60-111)
        box_idx = _points_in_boxes_np(points[:, :3], boxes)
        counts = np.array([(box_idx == i).sum() for i in range(boxes.shape[0])], dtype=np.int64)
        if threshold_boxes_by_points is not None and boxes.shape[0] > 0:
            keep = counts >= threshold_boxes_by_points
            remap = -np.ones(boxes.shape[0] + 1, dtype=np.int64)
            remap[np.where(keep)[0]] = np.arange(keep.sum())
            box_idx = np.where(box_idx >= 0, remap[box_idx], -1)
            boxes, prev_boxes = boxes[keep], prev_boxes[keep]
            names, iids, counts = names[keep], iids[keep], counts[keep]

        return {
            "points": points,
            "boxes": boxes.astype(np.float64),
            "prev_boxes": prev_boxes.astype(np.float64),
            "names": names,
            "instance_ids": iids,
            "num_points_in_boxes": counts,
            "box_idx_of_points": box_idx,
            "glob_se3_lidar": pose,
        }


def _points_in_boxes_np(points_xyz, boxes):
    """First containing-box index per point, -1 if none (center-z convention,
    matching the CUDA points_in_boxes), through the native kernel."""
    return points_in_boxes_np(np.asarray(points_xyz), np.asarray(boxes))


class NuScenesV2XSource:
    """The real V2X-Sim 2.0 through the nuScenes devkit, with the interface
    of ``SyntheticV2XSource``. ``nusc``, a devkit ``NuScenes`` or an object
    with its table interface, is used as given; without one the devkit is
    imported and raises ImportError where it is absent."""

    def __init__(self, dataroot, version, nusc=None):
        if nusc is not None:
            self.nusc = nusc
            return
        try:
            from nuscenes import NuScenes  # type: ignore
        except ImportError as e:
            raise ImportError(
                "nuscenes-devkit is required for real V2X-Sim data; "
                "use USE_SYNTHETIC_DATA: True otherwise"
            ) from e
        self.nusc = NuScenes(dataroot=str(dataroot), version=version, verbose=False)

    def sample_record(self, sample_token):
        return self.nusc.get("sample", sample_token)

    def get_pose(self, lidar_token):
        """glob_se3_lidar: the ego pose times the sensor's calibration."""
        sd = self.nusc.get("sample_data", lidar_token)
        cs = self.nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ep = self.nusc.get("ego_pose", sd["ego_pose_token"])
        glob_se3_ego = make_se3(ep["translation"], rotmat=quat_to_rotmat(ep["rotation"]))
        ego_se3_sensor = make_se3(cs["translation"], rotmat=quat_to_rotmat(cs["rotation"]))
        return glob_se3_ego @ ego_se3_sensor

    def get_frame(self, lidar_token, classes_of_interest=("car", "pedestrian"),
                  threshold_boxes_by_points=1, box_range=70.0):
        """The frame of one lidar sample: its points, and the annotated boxes
        of ``classes_of_interest`` (the current and the previous keyframe's,
        a copy of the current where there is none before) in its lidar
        frame, those with fewer than ``threshold_boxes_by_points`` points
        dropped. ``box_range`` is not read, as in the JAX package."""
        nusc = self.nusc
        sd = nusc.get("sample_data", lidar_token)
        points = np.fromfile(nusc.get_sample_data_path(lidar_token), dtype=np.float32)
        points = points.reshape(-1, 5)[:, :4]

        pose = self.get_pose(lidar_token)
        inv_pose = se3_inverse(pose)

        def box_of(anno):
            rot = quat_to_rotmat(anno["rotation"])
            yaw = np.arctan2(rot[1, 0], rot[0, 0])
            return np.concatenate([anno["translation"], np.asarray(anno["size"])[[1, 0, 2]], [yaw]])

        boxes, prev_boxes, names, iids = [], [], [], []
        sample = nusc.get("sample", sd["sample_token"])
        for anno_token in sample["anns"]:
            anno = nusc.get("sample_annotation", anno_token)
            name = _detection_name(anno["category_name"])
            if name not in classes_of_interest:
                continue
            box_g = box_of(anno)
            boxes.append(box_g)
            prev_boxes.append(box_of(nusc.get("sample_annotation", anno["prev"])) if anno["prev"]
                              else box_g.copy())
            names.append(name)
            iids.append(abs(hash(anno["instance_token"])) % (1 << 62))

        if boxes:
            boxes = apply_se3(inv_pose, boxes=np.asarray(boxes))
            prev_boxes = apply_se3(inv_pose, boxes=np.asarray(prev_boxes))
            names = np.asarray(names)
            iids = np.asarray(iids)
        else:
            boxes = np.zeros((0, 7))
            prev_boxes = np.zeros((0, 7))
            names = np.zeros((0,), dtype="<U16")
            iids = np.zeros((0,), dtype=np.int64)

        box_idx = _points_in_boxes_np(points[:, :3], boxes)
        counts = np.array([(box_idx == i).sum() for i in range(boxes.shape[0])], dtype=np.int64)
        if threshold_boxes_by_points is not None and boxes.shape[0] > 0:
            keep = counts >= threshold_boxes_by_points
            remap = -np.ones(boxes.shape[0] + 1, dtype=np.int64)
            remap[np.where(keep)[0]] = np.arange(keep.sum())
            box_idx = np.where(box_idx >= 0, remap[box_idx], -1)
            boxes, prev_boxes = boxes[keep], prev_boxes[keep]
            names, iids, counts = names[keep], iids[keep], counts[keep]

        return {
            "points": points,
            "boxes": boxes,
            "prev_boxes": prev_boxes,
            "names": names,
            "instance_ids": iids,
            "num_points_in_boxes": counts,
            "box_idx_of_points": box_idx,
            "glob_se3_lidar": pose,
        }


def _detection_name(category_name: str) -> str:
    """The first of car, pedestrian, truck, bus, bicycle, motorcycle that
    the category names, else the category itself."""
    for key in ("car", "pedestrian", "truck", "bus", "bicycle", "motorcycle"):
        if key in category_name:
            return key
    return category_name
