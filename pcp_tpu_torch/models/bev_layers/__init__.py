"""BEV-level modules: counterpart of ``pcp_tpu/models/bev_layers``. The
HunterJr corrector (serving and training), the oracle corrector, the
distillation teacher, and DiscoNet's frozen BEV makers and mid fusion."""


def build_corrector(cfg, info, num_bev_features, input_channels=None):
    from .hunter_jr import HunterJr
    from .oracle_corrector import OracleCorrector

    registry = {"HunterJr": HunterJr, "OracleCorrector": OracleCorrector}
    return registry[cfg["NAME"]](model_cfg=cfg, info=info, num_bev_features=num_bev_features,
                                 input_channels=input_channels)


def build_bev_maker(cfg, info, role):
    from .bev_maker import BEVMaker

    return BEVMaker(model_cfg=cfg, info=info, role=role)


def build_teacher(cfg, info):
    from .teacher import Teacher

    return Teacher(model_cfg=cfg, info=info)


def build_v2x_fusion(cfg, info, num_bev_features):
    from .v2x_fusion_disco import V2XMidFusionDisco

    registry = {"DISCO": V2XMidFusionDisco, "V2XMidFusionDisco": V2XMidFusionDisco}
    return registry[cfg["NAME"]](model_cfg=cfg, info=info, num_bev_features=num_bev_features)
