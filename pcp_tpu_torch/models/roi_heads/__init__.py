from .pointrcnn_head import PointRCNNHead
from .pvrcnn_head import PVRCNNHead

__all__ = {"PointRCNNHead": PointRCNNHead, "PVRCNNHead": PVRCNNHead}

# the JAX package's other ROI heads and the ROADMAP item that holds each
NOT_PORTED = {"MPPNetHead": "A11.6", "PartA2FCHead": "A11.6", "SECONDHead": "A11.6",
              "VoxelRCNNHead": "A11.6"}


def build_roi_head(cfg, num_class, input_channels):
    """The ROI head ``cfg`` names; ``CLASS_AGNOSTIC`` makes it one class."""
    if cfg["NAME"] not in __all__:
        raise NotImplementedError(f"ROI_HEAD {cfg['NAME']!r} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED.get(cfg['NAME'], 'A11')})")
    if bool(cfg.get("CLASS_AGNOSTIC", False)):
        num_class = 1
    return __all__[cfg["NAME"]](model_cfg=cfg, num_class=num_class, input_channels=input_channels)
