"""The port's CLIs on the CPU (``--device cpu``), on the reduced car sender
of ``test_torch_eval.REDUCED`` and its tiny synthetic world.

* ``tools/train.py`` writes a checkpoint an epoch, and a rerun resumes from
  the newest one and trains only the remaining epochs; its log gives each
  epoch's mean of every loss term and of the gradient norm before the clip,
  and its history file each step's; ``--tf32 off`` turns TF32 off;
* ``tools/test.py`` writes ``metrics.json`` with the JAX package's keys;
  ``get_no_evaluated_ckpt`` polls in epoch order and ``repeat_eval_ckpt``
  evaluates each checkpoint once;
* the exchange generator's CLI writes the files the ego dataset then reads.
"""
import json

import numpy as np
import pytest
import torch

from pcp_tpu_torch.tools import test as test_cli
from pcp_tpu_torch.tools import train as train_cli
from test_torch_eval import REDUCED

CFG_CAR = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml"
# the numeric keys of the JAX package's metrics.json for the car sender
# (tools/test.py: the recall, the nuScenes-protocol results, the timing)
JAX_KEYS = {"recall/rcnn_0.3", "recall/rcnn_0.5", "recall/rcnn_0.7", "car_AP",
            "car_AP_dist_0.5", "car_AP_dist_1.0", "car_AP_dist_2.0", "car_AP_dist_4.0",
            "car_ATE", "car_ASE", "car_AOE", "mAP", "NDS", "sec_per_example"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _common(root):
    return ["--cfg_file", CFG_CAR, "--batch_size", "2", "--workers", "0", "--device", "cpu",
            "--extra_tag", "cli", "--output_root", str(root)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reduced car trained for 2 epochs, then resumed to 3."""
    root = tmp_path_factory.mktemp("out")
    argv = _common(root) + ["--num_epochs_to_eval", "0", "--precise_bn", "1", "--seed", "1"]
    first = train_cli.main(argv + ["--epochs", "2", "--set", *REDUCED])
    second = train_cli.main(argv + ["--epochs", "3", "--set", *REDUCED])
    return root / "cfgs/v2x_sim_models/v2x_pointpillar_basic_car/cli", first, second


def test_train_cli_writes_checkpoints_and_resumes(trained):
    out, first, second = trained
    ckpts = sorted(p.name for p in (out / "ckpt").glob("checkpoint_epoch_*.pth"))
    assert ckpts == ["checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth", "checkpoint_epoch_3.pth"]
    assert first["epochs"] == 2 and second["epochs"] == 1
    per_epoch = first["steps"] // 2
    assert per_epoch > 0 and second["steps"] == per_epoch
    assert np.isfinite(first["losses"] + second["losses"]).all()
    assert first["data_ms_median"] >= 0 and first["step_ms_median"] > 0
    ckpt = torch.load(out / "ckpt/checkpoint_epoch_3.pth", weights_only=True)
    assert ckpt["epoch"] == 3 and ckpt["step"] == 3 * per_epoch
    logs = sorted(out.glob("log_train_*.txt"))
    assert any("resumed from" in p.read_text() for p in logs)


def test_train_cli_logs_each_term_and_the_gradient_norm(trained):
    out, first, second = trained
    hist = [h for p in sorted(out.glob("train_history_*.json")) for h in json.loads(p.read_text())]
    assert len(hist) == first["steps"] + second["steps"]
    assert {"rpn_loss", "corrector_loss", "l_points_cls", "l_recon", "grad_norm"} <= set(hist[0]["tb"])
    assert all(h["tb"]["grad_norm"] > 0 for h in hist)
    line = next(ln for p in out.glob("log_train_*.txt") for ln in p.read_text().splitlines()
                if "epoch 0 done" in ln)
    for key in ("l_points_cls", "grad_norm"):
        mean = np.mean([h["tb"][key] for h in hist if h["epoch"] == 0])
        assert f"{key} {mean:.4f}" in line, (key, line)


def test_tf32_switch():
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    argv = ["--cfg_file", CFG_CAR]
    assert train_cli.parse_args(argv).tf32 == test_cli.parse_args(argv).tf32 == "on"
    try:
        train_cli.apply_tf32("on")
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
        train_cli.apply_tf32("off")
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_test_cli_writes_metrics_with_jax_keys(trained):
    out, _, _ = trained
    result = test_cli.main(_common(out.parents[3]) + [
        "--ckpt", str(out / "ckpt/checkpoint_epoch_3.pth"), "--eval_tag", "val", "--infer_time",
        "--set", *REDUCED])
    metrics = json.loads((out / "eval/val/metrics.json").read_text())
    assert set(metrics) - {"infer_time_ms_per_batch"} == JAX_KEYS
    assert metrics["mAP"] == result["mAP"]
    assert all(np.isfinite(v) for v in metrics.values())


def test_get_no_evaluated_ckpt_polls_in_order(tmp_path):
    for e in (3, 1, 2, 9):
        (tmp_path / f"checkpoint_epoch_{e}.pth").touch()
    record = tmp_path / "eval_list_val.txt"
    record.write_text("1\n")
    assert test_cli.get_no_evaluated_ckpt(tmp_path, record, 0)[0] == "2"
    assert test_cli.get_no_evaluated_ckpt(tmp_path, record, 5)[0] == "9"
    record.write_text("1\n2\n3\n9\n")
    assert test_cli.get_no_evaluated_ckpt(tmp_path, record, 0) == (-1, None)


def test_repeat_eval_ckpt_evaluates_each_once(trained):
    out, _, _ = trained
    test_cli.main(_common(out.parents[3]) + [
        "--eval_all", "--ckpt_dir", str(out / "ckpt"), "--start_epoch", "2",
        "--max_waiting_mins", "0", "--eval_tag", "all", "--set", *REDUCED])
    eval_dir = out / "eval/all/eval_all"
    assert (eval_dir / "eval_list_val.txt").read_text().split() == ["2", "3"]
    for e in (2, 3):
        assert (eval_dir / f"epoch_{e}/metrics.json").exists()


def test_exchange_generator_cli_feeds_the_ego(tmp_path):
    """A full-width car (seeded, its heatmap bias raised so that boxes pass
    the score threshold) on a 25.6 m range broadcasts through the CLI; the
    ego dataset reads MoDAR rows of the car lidars from those files."""
    from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.models import DatasetInfo, build_network
    from pcp_tpu_torch.train.train_state import init_weights
    from pcp_tpu_torch.workspace import v2x_gen_exchange_database as genx

    syn = {"NUM_SCENES": 3, "KEYFRAMES_PER_SCENE": 2, "NUM_CARS": 10, "NUM_PEDS": 2,
           "WORLD": "urban", "NUM_PARKED": 4}
    pc_range = [-25.6, -25.6, -8.0, 25.6, 25.6, 0.0]
    cfg = cfg_from_yaml_file(genx.AGENT_CFGS["car"], CfgDict())
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = pc_range
    model = build_network(cfg.MODEL, 1, DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, ["car"]),
                          device="cpu")
    init_weights(model, 0)
    sd = model.state_dict()
    sd["dense_head.heads_list.0.hm.1.bias"] += 3.0
    torch.save({"model_state": sd}, tmp_path / "car.pth")
    exch = tmp_path / "exchange"
    written = genx.main(["--agent", "car", "--ckpt", str(tmp_path / "car.pth"), "--synthetic",
                         "--device", "cpu", "--workers", "0", "--out_dir", str(exch), "--set",
                         "MAX_POINTS_PER_SAMPLE", "4096", "SYNTHETIC", repr(syn),
                         "POINT_CLOUD_RANGE", repr(pc_range), "MINI_TRAINVAL_STRIDE", "1"])
    assert written == {"train": 20, "test": 10}
    assert len(list(exch.glob("*_boxflow.npz"))) == 30

    ego_cfg = cfg_from_yaml_file("tools/cfgs/dataset_configs/v2x_sim_dataset_ego.yaml", CfgDict())
    ego_cfg.update({"USE_SYNTHETIC_DATA": True, "MAX_POINTS_PER_SAMPLE": 8192, "SYNTHETIC": syn,
                    "EXCHANGE_NOW": True, "EXCHANGE_DATABASE_DIRECTORY": str(exch)})
    ds, _, _ = build_dataloader(ego_cfg, ["car"], batch_size=1, training=False, workers=0)
    for i in range(len(ds)):
        meta = ds[i]["metadata"]
        assert meta["exchange"][0][1] == 0  # the RSU broadcast nothing
        assert sum(meta["exchange"][lid][1] for lid in (2, 3, 4, 5)) > 0
