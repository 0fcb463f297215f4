from .base_bev_backbone import BaseBEVBackbone
from .sc_conv_backbone import SCConvBackbone2dStride1, SCConvBackbone2dStride4

__all__ = {"BaseBEVBackbone": BaseBEVBackbone,
           "SCConvBackbone2dStride1": SCConvBackbone2dStride1,
           "SCConvBackbone2dStride4": SCConvBackbone2dStride4}


def build_backbone_2d(cfg, input_channels, bf16=False):
    return __all__[cfg["NAME"]](model_cfg=cfg, input_channels=input_channels, bf16=bf16)
