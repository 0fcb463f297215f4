"""The plain nuScenes dataset of the "pointpillar_jr" configs: counterpart
of ``pcp_tpu/datasets/nuscenes``."""
from .nuscenes_dataset import NuScenesDataset
