"""Host-side data of the port: counterpart of ``pcp_tpu/datasets``.

The registry holds the V2X-Sim RSU and car datasets, the ego's lately,
early, late and mid (DiscoNet) fusion datasets, the plain nuScenes dataset,
KITTI and the self-labelled custom dataset.
"""
from .custom.custom_dataset import CustomDataset
from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .loader import DataLoader
from .nuscenes.nuscenes_dataset import NuScenesDataset
from .v2x_sim.v2x_sim_dataset_car import V2XSimDataset_CAR
from .v2x_sim.v2x_sim_dataset_ego import V2XSimDataset_EGO
from .v2x_sim.v2x_sim_dataset_ego_disco import V2XSimDataset_EGO_DISCO
from .v2x_sim.v2x_sim_dataset_ego_early import V2XSimDataset_EGO_EARLY
from .v2x_sim.v2x_sim_dataset_ego_late import V2XSimDataset_EGO_LATE
from .v2x_sim.v2x_sim_dataset_rsu import V2XSimDataset_RSU

__all__ = {
    "DatasetTemplate": DatasetTemplate,
    "V2XSimDataset_RSU": V2XSimDataset_RSU,
    "V2XSimDataset_CAR": V2XSimDataset_CAR,
    "V2XSimDataset_EGO": V2XSimDataset_EGO,
    "V2XSimDataset_EGO_EARLY": V2XSimDataset_EGO_EARLY,
    "V2XSimDataset_EGO_LATE": V2XSimDataset_EGO_LATE,
    "V2XSimDataset_EGO_DISCO": V2XSimDataset_EGO_DISCO,
    "NuScenesDataset": NuScenesDataset,
    "KittiDataset": KittiDataset,
    "CustomDataset": CustomDataset,
}


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, workers=4,
                     seed=None, logger=None, training=True, pin_memory=False, source=None):
    """(dataset, loader, None): the config's dataset and a loader over it,
    shuffled and dropping the last short batch in training. ``seed`` fixes
    the order and every item's draws; ``batch_size`` is the global batch, of
    which the loader gives each rank of the process group its share
    (``loader.py``). ``source`` (a V2X-Sim RSU or car dataset's) replaces
    the one the config names."""
    name = dataset_cfg["DATASET"]
    extra = {} if source is None else {"source": source}
    dataset = __all__[name](dataset_cfg=dataset_cfg, class_names=class_names,
                            root_path=root_path, training=training, logger=logger, **extra)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=training, seed=seed,
                        drop_last=training, num_workers=workers, pin_memory=pin_memory)
    return dataset, loader, None
