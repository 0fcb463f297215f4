from .centerpoint import CenterPoint
from .detector_template import DatasetInfo, Detector3DTemplate
from .obj_discoverer import ObjectDiscoverer
from .pointpillar import PointPillar, SECONDNet
from .pointrcnn import PointRCNN
from .pv_rcnn_plusplus import PVRCNNPlusPlus
from .pvrcnn import PVRCNN
from .v2x_late_fusion import V2XLateFusion

__all__ = {"CenterPoint": CenterPoint, "ObjectDiscoverer": ObjectDiscoverer,
           "PointPillar": PointPillar, "PointRCNN": PointRCNN, "PVRCNN": PVRCNN,
           "PVRCNNPlusPlus": PVRCNNPlusPlus, "SECONDNet": SECONDNet,
           "V2XLateFusion": V2XLateFusion}

# the JAX package's other detectors and the ROADMAP item that holds each
NOT_PORTED = {"PillarNet": "A11.6", "CaDDN": "A11.6", "MPPNet": "A11.6", "MPPNetE2E": "A11.6",
              "PartA2": "A11.6", "PartA2Net": "A11.6", "SECONDNetIoU": "A11.6", "VoxelRCNN": "A11.6"}


def build_detector(model_cfg, num_class, dataset_info):
    try:
        cls = __all__[model_cfg["NAME"]]
    except KeyError:
        item = NOT_PORTED.get(model_cfg["NAME"], "A11")
        raise NotImplementedError(
            f"detector {model_cfg['NAME']!r} is not ported yet (ROADMAP {item})") from None
    return cls(model_cfg=model_cfg, num_class=num_class, dataset_info=dataset_info)
