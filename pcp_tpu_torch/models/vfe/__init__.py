from .dynamic_mean_vfe import DynamicMeanVFE
from .dynamic_pillar_vfe import DynamicPillarVFE

# PillarVFE and MeanVFE (hard voxelization in the reference) resolve to the
# dynamic implementations, as in pcp_tpu/models/vfe/__init__.py.
__all__ = {
    "DynPillarVFE": DynamicPillarVFE,
    "DynamicPillarVFE": DynamicPillarVFE,
    "PillarVFE": DynamicPillarVFE,
    "DynMeanVFE": DynamicMeanVFE,
    "DynamicMeanVFE": DynamicMeanVFE,
    "MeanVFE": DynamicMeanVFE,
}


def build_vfe(vfe_cfg, info):
    if vfe_cfg["NAME"] not in __all__:
        raise NotImplementedError(f"VFE {vfe_cfg['NAME']!r} is not ported yet (ROADMAP A11.6)")
    return __all__[vfe_cfg["NAME"]](
        model_cfg=vfe_cfg,
        num_point_features=info.num_point_features,
        voxel_size=info.voxel_size,
        grid_size=info.grid_size,
        point_cloud_range=info.point_cloud_range,
    )
