"""Teacher: a frozen oracle-corrected single-agent network whose BEV
(``teacher_spatial_features_2d``) the HunterJr corrector's distillation
diagnostic reads.

Counterpart of ``pcp_tpu/models/bev_layers/teacher.py``: oracle corrector
-> VFE -> scatter -> backbone, run only while the detector trains, frozen
as the BEV makers are (``bev_maker.FrozenModule``; the optimizer leaves out
every name holding ``teacher``).
"""
import torch

from ..backbones_2d import build_backbone_2d
from ..map_to_bev import build_map_to_bev
from ..vfe import build_vfe
from .bev_maker import FrozenModule
from .oracle_corrector import OracleCorrector


class Teacher(FrozenModule):
    def __init__(self, model_cfg, info):
        super().__init__()
        self.oracle = OracleCorrector(model_cfg.get("CORRECTOR", {}), info)
        self.vfe = build_vfe(model_cfg["VFE"], info)
        self.map_to_bev = build_map_to_bev(model_cfg["MAP_TO_BEV"], info)
        self.backbone_2d = build_backbone_2d(model_cfg["BACKBONE_2D"],
                                             int(model_cfg["MAP_TO_BEV"]["NUM_BEV_FEATURES"]))
        self.freeze()

    def forward(self, batch):
        out = dict(batch)
        if not self.detector_training:  # the teacher only feeds the distillation diagnostic
            return out
        d = {k: batch[k] for k in ("points", "points_mask", "instances_tf") if k in batch}
        with torch.no_grad():
            d = self.backbone_2d(self.map_to_bev(self.vfe(self.oracle(d))))
        out["teacher_spatial_features_2d"] = d["spatial_features_2d"]
        return out
