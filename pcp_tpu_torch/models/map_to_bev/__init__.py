from .height_compression import HeightCompression
from .pointpillar_scatter import PointPillarScatter

__all__ = {"HeightCompression": HeightCompression, "PointPillarScatter": PointPillarScatter}


def build_map_to_bev(cfg, info):
    if cfg["NAME"] not in __all__:
        raise NotImplementedError(f"MAP_TO_BEV {cfg['NAME']!r} is not ported yet (ROADMAP A11.6)")
    return __all__[cfg["NAME"]](model_cfg=cfg, grid_size=info.grid_size)
