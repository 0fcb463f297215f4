from .voxel_set_abstraction import VoxelSetAbstraction

__all__ = {"VoxelSetAbstraction": VoxelSetAbstraction}


def build_pfe(cfg, info, num_bev_features, num_rawpoint_features, level_channels):
    """The point feature extractor ``cfg`` names (PV-RCNN's VSA).
    ``level_channels`` maps each of the 3D backbone's levels (``x_conv1``
    ... ``x_conv4``) to its width."""
    if cfg["NAME"] not in __all__:
        raise NotImplementedError(f"PFE {cfg['NAME']!r} is not ported yet (ROADMAP A11.6)")
    return __all__[cfg["NAME"]](model_cfg=cfg, voxel_size=info.voxel_size,
                                point_cloud_range=info.point_cloud_range,
                                num_bev_features=num_bev_features,
                                num_rawpoint_features=num_rawpoint_features,
                                level_channels=level_channels)
