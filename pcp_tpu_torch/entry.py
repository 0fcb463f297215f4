"""Entry point of the port: counterpart of ``__graft_entry__._build``.

    cfg, info, model = build("tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_ego.yaml")
    with torch.inference_mode():
        boxes = model({"points": points, "points_mask": mask})["final_box_dicts"]

``points`` is (B, N, C) float32 and ``points_mask`` (B, N) bool, on the
model's device. The senders (``CFG_CAR``, ``CFG_RSU``: CenterPoint with the
HunterJr corrector, 7-feature points) also return ``points_cls_prob`` and
``points_flow3d``, which ``train/eval_utils.py::make_exchange_writer``
broadcasts through ``exchange/database.py``. DiscoNet (``CFG_DISCO``: mid
fusion with frozen per-agent BEV makers) takes 6-feature merged clouds
whose last column is the agent, with ``se3_from_ego_arr`` (B, 6, 4, 4) and
``agent_present`` (B, 6). The model is in eval mode with
initial weights; load trained ones with ``model.load_state_dict`` (see
``utils/jax_weights.py``).
"""
from pathlib import Path

from .config import ROOT_DIR, CfgDict, cfg_from_yaml_file
from .models import DatasetInfo, build_network

CFG_EGO = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_ego.yaml"
CFG_CAR = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml"
CFG_RSU = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_rsu.yaml"
CFG_DISCO = "tools/cfgs/v2x_sim_models/v2x_pointpillar_disco.yaml"


def build(cfg_path=CFG_EGO, device="cuda", pre_reduce=None):
    """Returns (cfg, info, model) for the YAML config at ``cfg_path``, with the
    model on ``device`` (default "cuda": raises where there is no GPU). A
    relative path that does not exist is taken from the repository root.
    ``pre_reduce`` (True, "fused" or "onehot"), if given, replaces the
    config's ``MODEL.VFE.PRE_REDUCE`` and so selects the VFE's scatter kernel."""
    path = Path(cfg_path)
    if not path.is_absolute() and not path.exists():
        path = ROOT_DIR / path
    cfg = cfg_from_yaml_file(path, CfgDict())
    if pre_reduce is not None:
        cfg.MODEL["VFE"]["PRE_REDUCE"] = pre_reduce
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset_info=info,
                          device=device)
    return cfg, info, model
