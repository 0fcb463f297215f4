"""BEVMaker: a frozen single-agent network inside the DiscoNet model.

Counterpart of ``pcp_tpu/models/bev_layers/bev_maker.py``. Each maker is
the VFE -> scatter -> backbone of a trained single-agent detector (its
weights come from that detector's checkpoint,
``train/checkpoint.py::overlay_bev_maker_weights``). The RSU maker runs
agent 0 and the car maker agents 2-5: each branch reads the same padded
(B, N) merged cloud with the mask ``points_mask & (agent_idx == a)`` and
its xyz moved from the ego frame into the agent's
(``se3_from_ego_arr[:, a]``), and adds ``batch['bev_img'][a]``. The early
maker runs the whole merged cloud, only while the detector trains, for
``bev_img_early``, the distillation target.

Frozen means: the maker's modules stay in eval mode whatever the detector's
mode (``train`` is overridden; the detector's mode is kept in
``detector_training``), it runs under ``torch.no_grad()``, its parameters
do not require gradients, the optimizer leaves out every name holding
``bev_maker`` and BN recalibration leaves its statistics alone (no forward
updates them).
"""
import torch
from torch import nn

from ..backbones_2d import build_backbone_2d
from ..map_to_bev import build_map_to_bev
from ..vfe import build_vfe

AGENTS = {"rsu": (0,), "car": (2, 3, 4, 5)}


class FrozenModule(nn.Module):
    """A sub-network that always runs in eval mode and takes no gradient."""

    def __init__(self):
        super().__init__()
        self.detector_training = False

    def freeze(self):
        for p in self.parameters():
            p.requires_grad_(False)
        return self.train(False)

    def train(self, mode=True):
        self.detector_training = bool(mode)
        return super().train(False)


class BEVMaker(FrozenModule):
    def __init__(self, model_cfg, info, role):
        super().__init__()
        self.role = role  # 'bev_maker_rsu' | 'bev_maker_car' | 'bev_maker_early'
        self.maker_type = model_cfg.get("MAKER_TYPE", role.split("_")[-1])
        self.vfe = build_vfe(model_cfg["VFE"], info)
        self.map_to_bev = build_map_to_bev(model_cfg["MAP_TO_BEV"], info)
        self.backbone_2d = build_backbone_2d(model_cfg["BACKBONE_2D"],
                                             int(model_cfg["MAP_TO_BEV"]["NUM_BEV_FEATURES"]))
        self.freeze()

    @torch.no_grad()
    def run_branch(self, points, mask):
        d = {"points": points, "points_mask": mask}
        return self.backbone_2d(self.map_to_bev(self.vfe(d)))["spatial_features_2d"]

    def forward(self, batch):
        out = dict(batch)
        points, pmask = batch["points"], batch["points_mask"]  # (B, N, 6): x,y,z,i,t,agent_idx
        if self.maker_type == "early":
            if self.detector_training:  # the teacher BEV feeds only the distillation loss
                out["bev_img_early"] = self.run_branch(points, pmask)
            return out
        agent_idx = points[..., -1].to(torch.int32)
        se3_from_ego = batch["se3_from_ego_arr"]  # (B, 6, 4, 4): agent <- ego
        bev_img = dict(out.get("bev_img", {}))
        for a in AGENTS[self.maker_type]:
            tf = se3_from_ego[:, a]
            xyz = torch.einsum("bij,bnj->bni", tf[:, :3, :3], points[..., 0:3]) + tf[:, None, :3, 3]
            bev_img[a] = self.run_branch(torch.cat([xyz, points[..., 3:]], dim=-1),
                                         pmask & (agent_idx == a))
        out["bev_img"] = bev_img
        return out
