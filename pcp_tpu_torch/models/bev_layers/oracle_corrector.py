"""Oracle corrector: moves each foreground point of an earlier sweep onto
its instance's current pose with the ground-truth ``instances_tf``.

Counterpart of ``pcp_tpu/models/bev_layers/oracle_corrector.py``, the ideal
corrector that the distillation teacher runs before its VFE. A point's
instance and sweep are read from its feature columns
(``META_POINTS_FEAT_LOCATION_INSTANCE_IDX``, default -1, and ``..._SWEEP_IDX``,
default -2); its transform is gathered from the flattened (B*Ni*S, 4, 4)
``instances_tf`` at ``(b * Ni + max(inst, 0)) * S + clip(sweep, 0, S - 1)``,
clipped into range, as the JAX package gathers it. Points that are not
foreground (instance outside [0, Ni), or padding) keep their xyz.
"""
import torch
from torch import nn


class OracleCorrector(nn.Module):
    def __init__(self, model_cfg, info=None, num_bev_features=0, input_channels=None):
        # num_bev_features and input_channels: HunterJr's, unused here
        super().__init__()
        self.sweep_col = int(model_cfg.get("META_POINTS_FEAT_LOCATION_SWEEP_IDX", -2))
        self.inst_col = int(model_cfg.get("META_POINTS_FEAT_LOCATION_INSTANCE_IDX", -1))

    def forward(self, batch):
        out = dict(batch)
        if "instances_tf" not in batch:
            return out
        points, tf = batch["points"], batch["instances_tf"]  # (B, N, C), (B, Ni, S, 4, 4)
        b, n = points.shape[0], points.shape[1]
        ni, s = tf.shape[1], tf.shape[2]
        inst = points[..., self.inst_col].to(torch.int32)
        sweep = points[..., self.sweep_col].to(torch.int32).clamp(0, s - 1)
        is_fg = (inst > -1) & (inst < ni) & batch["points_mask"]
        flat_tf = tf.reshape(b * ni * s, 4, 4)
        base = torch.arange(b, device=points.device, dtype=torch.int32)[:, None] * ni
        lid = ((base + inst.clamp(min=0)) * s + sweep).reshape(-1).clamp(0, b * ni * s - 1)
        ptf = flat_tf[lid.long()].reshape(b, n, 4, 4)
        xyz = points[..., 0:3]
        new_xyz = torch.einsum("bnij,bnj->bni", ptf[..., :3, :3], xyz) + ptf[..., :3, 3]
        xyz = torch.where(is_fg[..., None], new_xyz, xyz)
        out["points"] = torch.cat([xyz, points[..., 3:]], dim=-1)
        return out
