from .base_bev_backbone import BaseBEVBackbone

__all__ = {"BaseBEVBackbone": BaseBEVBackbone}


def build_backbone_2d(cfg, input_channels, bf16=False):
    return __all__[cfg["NAME"]](model_cfg=cfg, input_channels=input_channels, bf16=bf16)
