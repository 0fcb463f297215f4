from .pointnet2_backbone import PointNet2MSG
from .spconv_backbone import VoxelBackBone8x, VoxelResBackBone8x

__all__ = {"VoxelBackBone8x": VoxelBackBone8x, "VoxelResBackBone8x": VoxelResBackBone8x,
           "PointNet2MSG": PointNet2MSG}

# the JAX package's other 3D backbones and the ROADMAP item that holds each
NOT_PORTED = {"UNetV2": "A11.6", "PillarBackBone8x": "A11.6",
              "PillarRes18BackBone8x": "A11.6", "VoxelBackBone8xFocal": "A11.6"}


def build_backbone_3d(cfg, num_point_features):
    if cfg["NAME"] not in __all__:
        raise NotImplementedError(f"BACKBONE_3D {cfg['NAME']!r} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED.get(cfg['NAME'], 'A11')})")
    return __all__[cfg["NAME"]](model_cfg=cfg, num_point_features=num_point_features)
