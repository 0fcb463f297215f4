"""Config-driven construction of the detector.

Counterpart of ``pcp_tpu/models/detectors/detector_template.py``. The MODEL
config names the sub-modules; each is registered under its pcdet name so
that the state dict carries pcdet's keys, and the forward threads a batch
dict through them in the JAX package's order: DiscoNet's frozen BEV makers
(``bev_maker_rsu``, ``bev_maker_car``, ``bev_maker_early``), the
distillation ``teacher``, ``vfe``, the sparse ``backbone_3d`` (SECOND),
``map_to_bev``, ``backbone_2d``, the ``corrector`` (HunterJr or the oracle),
DiscoNet's ``v2x_mid_fusion``, the ``dense_head``, and the two-stage
models' ``point_head`` and ``roi_head`` (PointRCNN's behind its point
backbone, PointNet2MSG, which reads the raw points where no VFE precedes it;
PV-RCNN's behind the PFE, whose keypoint features they read: the point head
those before the fusion under ``USE_POINT_FEATURES_BEFORE_FUSION``). Where
an ROI head follows, the dense head decodes its boxes in training too. The
width the 2D backbone reads is ``MAP_TO_BEV.NUM_BEV_FEATURES`` (for ``HeightCompression``
the 3D backbone's 128 channels times its 2 z slices). The corrector's width
is the JAX package's rule: the backbone's upsampled or last filters, and
for a backbone that names neither (the SCConv backbones) the scatter's
width, so that behind ``SCConvBackbone2dStride4`` HunterJr maps 384 channels
to 64 and the head reads 64. ``MODEL.OracleCorrector`` (the nuScenes oracle
config) is read by no module of the JAX package, and by none here. Any other
MODEL key raises naming its ROADMAP item. ``MODEL.BF16`` and the backbone's
``FOLD_BN`` and ``W_PACK`` are refused on a model with a sparse 3D backbone
or an anchor head (ROADMAP A11.1b).
"""
import dataclasses
from typing import Tuple

from torch import nn

# MODEL keys the port builds, in forward order
MAKER_KEYS = ("BEV_MAKER_RSU", "BEV_MAKER_CAR", "BEV_MAKER_EARLY")
MODULE_KEYS = (tuple((key, key.lower()) for key in MAKER_KEYS)
               + (("TEACHER", "teacher"), ("VFE", "vfe"), ("BACKBONE_3D", "backbone_3d"),
                  ("MAP_TO_BEV", "map_to_bev"), ("PFE", "pfe"),
                  ("BACKBONE_2D", "backbone_2d"), ("CORRECTOR", "corrector"),
                  ("V2X_MID_FUSION", "v2x_mid_fusion"), ("DENSE_HEAD", "dense_head"),
                  ("POINT_HEAD", "point_head"), ("ROI_HEAD", "roi_head")))
# MODEL keys that configure no module
PLAIN_KEYS = ("NAME", "POST_PROCESSING", "BF16", "OracleCorrector")


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
        from ..backbones_3d import build_backbone_3d
        from ..backbones_3d.pfe import build_pfe
        from ..bev_layers import build_bev_maker, build_corrector, build_teacher, build_v2x_fusion
        from ..dense_heads import build_dense_head
        from ..dense_heads.point_head import build_point_head
        from ..map_to_bev import build_map_to_bev
        from ..roi_heads import build_roi_head
        from ..vfe import build_vfe

        cfg, info = self.model_cfg, self.dataset_info
        known = {key for key, _ in MODULE_KEYS} | set(PLAIN_KEYS)
        extra = sorted(k for k, v in cfg.items() if v is not None and k not in known)
        if extra:
            raise NotImplementedError(f"MODEL keys {extra} are not ported yet (ROADMAP A11)")
        # MODEL.BF16: the backbone's and the head's conv stacks serve in bfloat16
        bf16 = bool(cfg.get("BF16", False))
        bb_cfg = cfg.get("BACKBONE_2D") or {}
        modes = [k for k, on in (("MODEL.BF16", bf16), ("FOLD_BN", bb_cfg.get("FOLD_BN", False)),
                                 ("W_PACK", bb_cfg.get("W_PACK", False))) if on]
        head = (cfg.get("DENSE_HEAD") or {}).get("NAME")
        if modes and (cfg.get("BACKBONE_3D") is not None or head == "AnchorHeadSingle"):
            raise NotImplementedError(f"{', '.join(modes)} on the SECOND and anchor-head models "
                                      "is not ported yet (ROADMAP A11.1b)")

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
        num_point_features = info.num_point_features
        if cfg.get("BACKBONE_3D") is not None:
            if cfg.get("VFE") is not None:
                num_point_features = self.vfe.num_point_features
            self.add_module("backbone_3d", build_backbone_3d(cfg["BACKBONE_3D"],
                                                             num_point_features))
            names.append("backbone_3d")
            num_point_features = getattr(self.backbone_3d, "num_point_features",
                                         num_point_features)
        if cfg.get("MAP_TO_BEV") is not None:
            self.add_module("map_to_bev", build_map_to_bev(cfg["MAP_TO_BEV"], info))
            names.append("map_to_bev")
            num_bev_features = int(cfg["MAP_TO_BEV"]["NUM_BEV_FEATURES"])
        if cfg.get("PFE") is not None:
            levels = self.backbone_3d.level_channels if "backbone_3d" in names else {}
            self.add_module("pfe", build_pfe(cfg["PFE"], info, num_bev_features,
                                             info.num_point_features, levels))
            names.append("pfe")
            num_point_features = self.pfe.num_point_features
        corrector_width = num_bev_features
        if cfg.get("BACKBONE_2D") is not None:
            bcfg = cfg["BACKBONE_2D"]
            backbone = build_backbone_2d(bcfg, num_bev_features, bf16=bf16)
            self.add_module("backbone_2d", backbone)
            names.append("backbone_2d")
            num_bev_features = backbone.num_bev_features
            ups, filters = list(bcfg.get("NUM_UPSAMPLE_FILTERS", [])), list(bcfg.get("NUM_FILTERS", []))
            corrector_width = sum(ups) if ups else (filters[-1] if filters else corrector_width)
        if cfg.get("CORRECTOR") is not None:
            self.add_module("corrector", build_corrector(cfg["CORRECTOR"], info, corrector_width,
                                                         input_channels=num_bev_features))
            names.append("corrector")
            num_bev_features = corrector_width
        if cfg.get("V2X_MID_FUSION") is not None:
            self.add_module("v2x_mid_fusion",
                            build_v2x_fusion(cfg["V2X_MID_FUSION"], info, num_bev_features))
            names.append("v2x_mid_fusion")
        if cfg.get("DENSE_HEAD") is not None:
            self.add_module("dense_head", build_dense_head(
                cfg["DENSE_HEAD"], info, num_bev_features, self.num_class, bf16=bf16,
                predict_boxes_when_training=cfg.get("ROI_HEAD") is not None))
            names.append("dense_head")
        if cfg.get("POINT_HEAD") is not None:
            width = num_point_features
            if cfg["POINT_HEAD"].get("USE_POINT_FEATURES_BEFORE_FUSION", False):
                width = self.pfe.num_point_features_before_fusion
            self.add_module("point_head", build_point_head(
                cfg["POINT_HEAD"], width, self.num_class,
                predict_boxes_when_training=cfg.get("ROI_HEAD") is not None))
            names.append("point_head")
        if cfg.get("ROI_HEAD") is not None:
            self.add_module("roi_head", build_roi_head(cfg["ROI_HEAD"], self.num_class,
                                                       num_point_features))
            names.append("roi_head")
        return names
