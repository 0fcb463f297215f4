from .centerpoint import CenterPoint
from .detector_template import DatasetInfo, Detector3DTemplate
from .v2x_late_fusion import V2XLateFusion

__all__ = {"CenterPoint": CenterPoint, "V2XLateFusion": V2XLateFusion}


def build_detector(model_cfg, num_class, dataset_info):
    try:
        cls = __all__[model_cfg["NAME"]]
    except KeyError:
        raise NotImplementedError(
            f"detector {model_cfg['NAME']!r} is not ported yet (ROADMAP A11)") from None
    return cls(model_cfg=model_cfg, num_class=num_class, dataset_info=dataset_info)
