from .anchor_head_single import AnchorHeadSingle
from .center_head import CenterHead

__all__ = {"AnchorHeadSingle": AnchorHeadSingle, "CenterHead": CenterHead}

# the JAX package's other dense heads and the ROADMAP item that holds each
NOT_PORTED = {"AnchorHeadMulti": "A11.4", "PointHeadSimple": "A11.6",
              "PointIntraPartOffsetHead": "A11.6"}


def build_dense_head(cfg, info, input_channels, num_class, bf16=False):
    if cfg["NAME"] not in __all__:
        raise NotImplementedError(f"DENSE_HEAD {cfg['NAME']!r} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED.get(cfg['NAME'], 'A11')})")
    return __all__[cfg["NAME"]](
        model_cfg=cfg,
        input_channels=input_channels,
        num_class=num_class,
        class_names=info.class_names,
        grid_size=info.grid_size,
        point_cloud_range=info.point_cloud_range,
        voxel_size=info.voxel_size,
        bf16=bf16,
    )
