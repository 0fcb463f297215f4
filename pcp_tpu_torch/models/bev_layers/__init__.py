"""BEV-level modules: counterpart of ``pcp_tpu/models/bev_layers``. Only the
HunterJr corrector is ported (serving and training, ROADMAP A7 and A7b); the
DiscoNet modules and the oracle corrector come with ROADMAP A9."""


def build_corrector(cfg, info, num_bev_features):
    from .hunter_jr import HunterJr

    if cfg["NAME"] != "HunterJr":
        raise NotImplementedError(f"corrector {cfg['NAME']!r} is not ported yet (ROADMAP A9)")
    return HunterJr(model_cfg=cfg, info=info, num_bev_features=num_bev_features)
