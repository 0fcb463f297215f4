"""The port stands alone: no JAX, no flax/optax/orbax, nothing of pcp_tpu.

Checked two ways: a fresh interpreter imports the package, builds the ego
and car models on the CPU, puts the car in training mode, builds DiscoNet
(its frozen makers stay in eval mode when it trains), imports the bench, the
exchange's modules, the data pipeline (the early, late and DiscoNet
datasets too), late fusion, the teacher and the oracle corrector, the CLIs and the workspace scripts, reads a dataset item through the native host kernels
(built into the port's own ``native/build/``), builds KITTI infos and the gt
database on a fake tree (``tests/torch_fake_kitti.py``; its PNGs read
without PIL), PointRCNN in training mode and a KITTI training item with
gt_sampling, the custom dataset's infos, PV-RCNN in training mode (its
voxel set abstraction, point head and ROI head) and PV-RCNN++ (SPC
sampling, VectorPool); and a scan of every import
statement in the package (``pcp_tpu_torch/bench.py`` included), in the
measurement scripts under tools_torch/ and in chip_smoke.py. The entry
points default to the GPU and raise without one.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pcp_tpu")
# absent on the card's machine: the map rasters are numpy alone
MAP_FREE = ("cv2", "matplotlib", "nuscenes")
# absent there too: KITTI's image shapes come from the PNG header
IMAGE_FREE = ("PIL",)
SOURCES = sorted(str(p.relative_to(REPO)) for p in (REPO / "pcp_tpu_torch").rglob("*.py"))
SOURCES += sorted(str(p.relative_to(REPO)) for p in (REPO / "tools_torch").glob("*.py"))
SOURCES.append("chip_smoke.py")


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys\n"
        "from pcp_tpu_torch.entry import CFG_CAR, build\n"
        "cfg, info, model = build(device='cpu')\n"
        "cfg, info, model = build(CFG_CAR, device='cpu')\n"
        "model.train()\n"
        "import pcp_tpu_torch.bench, pcp_tpu_torch.models.loss_fnc.lovasz\n"
        "import pcp_tpu_torch.exchange, pcp_tpu_torch.train.eval_utils\n"
        "import pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_ego\n"
        "import pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_ego_early\n"
        "import pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_ego_late\n"
        "import pcp_tpu_torch.models.detectors.v2x_late_fusion, pcp_tpu_torch.utils.nms_np\n"
        "import pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_ego_disco\n"
        "import pcp_tpu_torch.models.bev_layers.teacher, pcp_tpu_torch.models.bev_layers.oracle_corrector\n"
        "from pcp_tpu_torch.entry import CFG_DISCO\n"
        "cfg, info, model = build(CFG_DISCO, device='cpu')\n"
        "model.train()\n"
        "assert not model.bev_maker_car.training and model.v2x_mid_fusion.training\n"
        "import pcp_tpu_torch.tools.train, pcp_tpu_torch.tools.test\n"
        "import pcp_tpu_torch.workspace.v2x_gen_exchange_database\n"
        "import pcp_tpu_torch.workspace.collect_results\n"
        "import pcp_tpu_torch.datasets.nuscenes.nuscenes_dataset\n"
        "import pcp_tpu_torch.datasets.nuscenes.info_builder, pcp_tpu_torch.datasets.nuscenes.temporal_utils\n"
        "cfg, info, model = build('tools/cfgs/nuscenes_models/pointpillar_jr_corr_withmap.yaml', device='cpu')\n"
        "from pcp_tpu_torch import native\n"
        "from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file\n"
        "from pcp_tpu_torch.datasets import build_dataloader\n"
        "cfg = cfg_from_yaml_file('tools/cfgs/dataset_configs/v2x_sim_dataset_rsu.yaml', CfgDict())\n"
        "cfg.update(USE_SYNTHETIC_DATA=True, SYNTHETIC={'NUM_SCENES': 1, 'KEYFRAMES_PER_SCENE': 1})\n"
        "ds, _, _ = build_dataloader(cfg, ['car'], batch_size=1, training=False, workers=0)\n"
        "ds[0]\n"
        "assert native._LIB is not None and native.library_path().parent == native.BUILD_DIR\n"
        "assert native.BUILD_DIR.parts[-3:] == ('pcp_tpu_torch', 'native', 'build'), native.BUILD_DIR\n"
        "import tempfile, pathlib\n"
        "sys.path.insert(0, 'tests')\n"
        "from torch_fake_kitti import make_kitti_tree, make_custom_tree\n"
        "from pcp_tpu_torch.datasets.kitti import kitti_dataset\n"
        "from pcp_tpu_torch.datasets.custom.custom_dataset import create_custom_infos\n"
        "from pcp_tpu_torch.entry import CFG_POINTRCNN\n"
        "import pcp_tpu_torch.tools.create_integrated_database\n"
        "root = make_kitti_tree(pathlib.Path(tempfile.mkdtemp()) / 'kitti')\n"
        "kitti_dataset.main(['create_kitti_infos', 'tools/cfgs/dataset_configs/kitti_dataset.yaml',\n"
        "                    '--data_path', str(root)])\n"
        "cfg, info, model = build(CFG_POINTRCNN, device='cpu', set_cfgs=['DATA_CONFIG.DATA_PATH', str(root)])\n"
        "model.train()\n"
        "ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=1, training=True,\n"
        "                           workers=0)\n"
        "assert ds[0]['points'].shape == (16384, 4)\n"
        "ccfg = cfg_from_yaml_file('tools/cfgs/custom_models/second.yaml', CfgDict())\n"
        "croot = make_custom_tree(pathlib.Path(tempfile.mkdtemp()) / 'custom')\n"
        "create_custom_infos(ccfg.DATA_CONFIG, ccfg.CLASS_NAMES, croot, croot)\n"
        "from pcp_tpu_torch.entry import CFG_PVRCNN, PVRCNN_PLUSPLUS, PVRCNN_Z_RANGE\n"
        "cfg, info, model = build(CFG_PVRCNN, device='cpu', set_cfgs=PVRCNN_Z_RANGE)\n"
        "model.train()\n"
        "assert model.module_names[3] == 'pfe' and model.pfe.num_point_features_before_fusion == 544\n"
        "cfg, info, model = build(CFG_PVRCNN, device='cpu', set_cfgs=PVRCNN_Z_RANGE + PVRCNN_PLUSPLUS)\n"
        "assert type(model).__name__ == 'PVRCNNPlusPlus' and model.pfe.sample_method == 'SPC'\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + MAP_FREE + IMAGE_FREE!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("source", SOURCES)
def test_no_forbidden_import(source):
    tree = ast.parse((REPO / source).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{source}:{node.lineno} imports {name}"


def test_entry_defaults_to_gpu_and_raises_without_one():
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    argv = ["--cfg_file", "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_ego.yaml"]
    for cli in (train_cli, test_cli):
        assert cli.parse_args(argv).device == "cuda"


def test_iou_head_branch_raises_naming_a11():
    """The head's ``iou`` branch and its calibration target, refused naming
    A11 until they were ported, now build: the ego with the branch added
    assigns targets that end in the IoU column, 2 IoU - 1 of each valid gt
    (held against the JAX package in ``test_torch_jr.py``)."""
    from pcp_tpu_torch.entry import CFG_EGO
    from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
    from pcp_tpu_torch.models import DatasetInfo, build_network

    cfg = cfg_from_yaml_file(REPO / CFG_EGO, CfgDict())
    cfg.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT["iou"] = {"out_channels": 1, "num_conv": 2}
    cfg.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_ORDER.append("iou")
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    head = build_network(cfg.MODEL, num_class=1, dataset_info=info, device="cpu").dense_head
    cap = int(cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS)
    gt = torch.zeros((1, cap, 8))
    gt[0, 0] = torch.tensor([-50.0, -50.0, -1.0, 4.0, 2.0, 1.6, 0.3, 1.0])
    preds = [{k: torch.zeros((1, c, 16, 16)) for k, c in
              (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2), ("iou", 1))}]
    target = head.assign_targets(gt, feat_w=16, feat_h=16, pred_dicts=preds)[0]
    assert target["target_boxes"].shape == (1, cap, 9) and target["mask"][0, 0]
    assert -1.0 <= target["target_boxes"][0, 0, -1].item() <= 1.0
