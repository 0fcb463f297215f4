"""Model registry and builder: counterpart of ``pcp_tpu/models/__init__.py``."""
import torch

from .detectors import build_detector
from .detectors.detector_template import DatasetInfo


def build_network(model_cfg, num_class, dataset_info: DatasetInfo, device="cuda"):
    """Build the detector on ``device`` in eval mode. ``device="cuda"`` (the
    default) raises where no CUDA device is present; pass ``device="cpu"``
    for the plain versions of the kernels. A host model (``is_host_model``:
    late fusion) has no parameters and runs on the host whatever
    ``device`` says."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_network(device='cuda'): no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    model = build_detector(model_cfg, num_class, dataset_info)
    if getattr(model, "is_host_model", False):
        return model
    return model.to(device).eval()
