from .center_head import CenterHead

__all__ = {"CenterHead": CenterHead}


def build_dense_head(cfg, info, input_channels, num_class, bf16=False):
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
