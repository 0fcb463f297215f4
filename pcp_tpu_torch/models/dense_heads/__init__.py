from .anchor_head_single import AnchorHeadSingle
from .center_head import CenterHead

__all__ = {"AnchorHeadSingle": AnchorHeadSingle, "CenterHead": CenterHead}

# the JAX package's other dense heads and the ROADMAP item that holds each
NOT_PORTED = {"AnchorHeadMulti": "A11.4", "PointIntraPartOffsetHead": "A11.6"}


def build_dense_head(cfg, info, input_channels, num_class, bf16=False,
                     predict_boxes_when_training=False):
    """The dense head ``cfg`` names; ``predict_boxes_when_training`` (an ROI
    head follows) makes the anchor head decode its boxes in training too."""
    if cfg["NAME"] not in __all__:
        raise NotImplementedError(f"DENSE_HEAD {cfg['NAME']!r} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED.get(cfg['NAME'], 'A11')})")
    extra = ({"predict_boxes_when_training": predict_boxes_when_training}
             if cfg["NAME"] == "AnchorHeadSingle" else {})
    return __all__[cfg["NAME"]](
        model_cfg=cfg,
        input_channels=input_channels,
        num_class=num_class,
        class_names=info.class_names,
        grid_size=info.grid_size,
        point_cloud_range=info.point_cloud_range,
        voxel_size=info.voxel_size,
        bf16=bf16,
        **extra,
    )
