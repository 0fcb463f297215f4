"""Config-driven construction of the detector.

Counterpart of ``pcp_tpu/models/detectors/detector_template.py``. The MODEL
config names the sub-modules; each is registered under its pcdet name so
that the state dict carries pcdet's keys, and the forward threads a batch
dict through them in the JAX package's order: DiscoNet's frozen BEV makers
(``bev_maker_rsu``, ``bev_maker_car``, ``bev_maker_early``), the
distillation ``teacher``, ``vfe``, ``map_to_bev``, ``backbone_2d``, the
``corrector`` (HunterJr or the oracle), DiscoNet's ``v2x_mid_fusion`` and
the ``dense_head``. Any other MODEL key raises naming its ROADMAP item.
"""
import dataclasses
from typing import Tuple

from torch import nn

# MODEL keys the port builds, in forward order
MAKER_KEYS = ("BEV_MAKER_RSU", "BEV_MAKER_CAR", "BEV_MAKER_EARLY")
MODULE_KEYS = (tuple((key, key.lower()) for key in MAKER_KEYS)
               + (("TEACHER", "teacher"), ("VFE", "vfe"), ("MAP_TO_BEV", "map_to_bev"),
                  ("BACKBONE_2D", "backbone_2d"), ("CORRECTOR", "corrector"),
                  ("V2X_MID_FUSION", "v2x_mid_fusion"), ("DENSE_HEAD", "dense_head")))
# MODEL keys that configure no module
PLAIN_KEYS = ("NAME", "POST_PROCESSING", "BF16")


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    """Static dataset geometry the model builder needs."""

    class_names: Tuple[str, ...]
    num_point_features: int
    point_cloud_range: Tuple[float, ...]
    voxel_size: Tuple[float, ...]
    grid_size: Tuple[int, ...]  # (nx, ny, nz)

    @classmethod
    def from_data_cfg(cls, data_cfg, class_names):
        pc_range = tuple(float(v) for v in data_cfg["POINT_CLOUD_RANGE"])
        voxel_size = None
        for proc in data_cfg.get("DATA_PROCESSOR", []):
            if "VOXEL_SIZE" in proc:
                voxel_size = tuple(float(v) for v in proc["VOXEL_SIZE"])
        if voxel_size is None:
            voxel_size = (0.2, 0.2, pc_range[5] - pc_range[2])
        grid = tuple(int(round((pc_range[3 + i] - pc_range[i]) / voxel_size[i])) for i in range(3))
        return cls(
            class_names=tuple(class_names),
            num_point_features=len(data_cfg["POINT_FEATURE_ENCODING"]["used_feature_list"]),
            point_cloud_range=pc_range,
            voxel_size=voxel_size,
            grid_size=grid,
        )


class Detector3DTemplate(nn.Module):
    def __init__(self, model_cfg, num_class, dataset_info):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset_info = dataset_info
        self.module_names = self.build_module_list()

    def build_module_list(self):
        from ..backbones_2d import build_backbone_2d
        from ..bev_layers import build_bev_maker, build_corrector, build_teacher, build_v2x_fusion
        from ..dense_heads import build_dense_head
        from ..map_to_bev import build_map_to_bev
        from ..vfe import build_vfe

        cfg, info = self.model_cfg, self.dataset_info
        known = {key for key, _ in MODULE_KEYS} | set(PLAIN_KEYS)
        extra = sorted(k for k, v in cfg.items() if v is not None and k not in known)
        if extra:
            raise NotImplementedError(f"MODEL keys {extra} are not ported yet (ROADMAP A11)")
        # MODEL.BF16: the backbone's and the head's conv stacks serve in bfloat16
        bf16 = bool(cfg.get("BF16", False))

        names = []
        num_bev_features = None
        for key in MAKER_KEYS:
            if cfg.get(key) is not None:
                self.add_module(key.lower(), build_bev_maker(cfg[key], info, role=key.lower()))
                names.append(key.lower())
        if cfg.get("TEACHER") is not None:
            self.add_module("teacher", build_teacher(cfg["TEACHER"], info))
            names.append("teacher")
        if cfg.get("VFE") is not None:
            self.add_module("vfe", build_vfe(cfg["VFE"], info))
            names.append("vfe")
        if cfg.get("MAP_TO_BEV") is not None:
            self.add_module("map_to_bev", build_map_to_bev(cfg["MAP_TO_BEV"], info))
            names.append("map_to_bev")
            num_bev_features = int(cfg["MAP_TO_BEV"]["NUM_BEV_FEATURES"])
        if cfg.get("BACKBONE_2D") is not None:
            backbone = build_backbone_2d(cfg["BACKBONE_2D"], num_bev_features, bf16=bf16)
            self.add_module("backbone_2d", backbone)
            names.append("backbone_2d")
            num_bev_features = backbone.num_bev_features
        if cfg.get("CORRECTOR") is not None:
            self.add_module("corrector", build_corrector(cfg["CORRECTOR"], info, num_bev_features))
            names.append("corrector")
        if cfg.get("V2X_MID_FUSION") is not None:
            self.add_module("v2x_mid_fusion",
                            build_v2x_fusion(cfg["V2X_MID_FUSION"], info, num_bev_features))
            names.append("v2x_mid_fusion")
        if cfg.get("DENSE_HEAD") is not None:
            self.add_module("dense_head", build_dense_head(cfg["DENSE_HEAD"], info,
                                                           num_bev_features, self.num_class,
                                                           bf16=bf16))
            names.append("dense_head")
        return names
