"""Config-driven augmentation queue: counterpart of
``pcp_tpu/datasets/augmentor/data_augmentor.py``.

Each ``AUG_CONFIG_LIST`` entry not in ``DISABLE_AUG_LIST`` becomes a step
applied in order, drawing from the sample's ``np.random.RandomState``. The
V2X configs use the world flip, rotation and scaling, the nuScenes configs
also the world translation, the KITTI configs ``gt_sampling``
(``database_sampler.py``) before the world steps; the local, frustum and
pyramid augmentations raise, naming ROADMAP A11.5.
"""
from functools import partial

import numpy as np

from . import augmentor_utils

NOT_PORTED = ("random_local_translation", "random_local_rotation",
              "random_local_scaling", "random_world_frustum_dropout",
              "random_local_frustum_dropout", "random_local_pyramid_aug")


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        aug_config_list = (augmentor_configs if isinstance(augmentor_configs, list)
                           else augmentor_configs["AUG_CONFIG_LIST"])
        disabled = [] if isinstance(augmentor_configs, list) else augmentor_configs["DISABLE_AUG_LIST"]
        self.data_augmentor_queue = []
        for cur_cfg in aug_config_list:
            if cur_cfg["NAME"] in disabled:
                continue
            if cur_cfg["NAME"] in NOT_PORTED:
                raise NotImplementedError(
                    f"DATA_AUGMENTOR {cur_cfg['NAME']} is not ported yet (ROADMAP A11.5)")
            self.data_augmentor_queue.append(getattr(self, cur_cfg["NAME"])(config=cur_cfg))

    def random_world_flip(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        for cur_axis in config["ALONG_AXIS_LIST"]:
            assert cur_axis in ["x", "y"]
            flip = getattr(augmentor_utils, "random_flip_along_%s" % cur_axis)
            data_dict["flip_%s" % cur_axis] = flip(data_dict, rng)
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple, np.ndarray)):
            rot_range = [-rot_range, rot_range]
        data_dict["noise_rot"] = augmentor_utils.global_rotation(data_dict, rot_range, rng)
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        data_dict["noise_scale"] = augmentor_utils.global_scaling(
            data_dict, config["WORLD_SCALE_RANGE"], rng)
        return data_dict

    def random_world_translation(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        augmentor_utils.global_translation(data_dict, config["NOISE_TRANSLATE_STD"], rng)
        return data_dict

    def gt_sampling(self, config=None):
        from .database_sampler import DataBaseSampler

        return DataBaseSampler(root_path=self.root_path, sampler_cfg=config,
                               class_names=self.class_names, logger=self.logger)

    def forward(self, data_dict, rng):
        for cur_augmentor in self.data_augmentor_queue:
            data_dict = cur_augmentor(data_dict=data_dict, rng=rng)
        if "gt_boxes" in data_dict:
            data_dict["gt_boxes"][:, 6] = np.arctan2(np.sin(data_dict["gt_boxes"][:, 6]),
                                                     np.cos(data_dict["gt_boxes"][:, 6]))
        return data_dict
