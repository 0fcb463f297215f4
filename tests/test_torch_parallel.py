"""Data parallelism of the port (``pcp_tpu_torch/parallel``) on the CPU.

Two ranks spawned over gloo against one process, on the small ego of
tests/torch_port_helpers.py and its b2 training batch, rank r taking cloud
r (``shard_batch``), weights from ``create_train_state``'s seed and the ego
config's adam_onecycle. The N-rank step must be the one-process step on the
same global batch (tolerances measured on this CPU, then set with margin):

* the loss and each term (rtol 1e-5; seen 1.6e-6);
* every BN running statistic, of the VFE's masked BNs and the backbone's
  and head's (atol 1e-6; seen 1.2e-7);
* every parameter after the Adam step (atol 1e-6, a fiftieth of the step's
  learning rate; seen 2.8e-7: Adam's first step divides the gradient by its
  own size, so an entry with a small gradient carries its rounding into
  the step), except the conv biases in front of a BN: their gradient is 0
  in exact arithmetic, so the sign of its rounding decides their first
  Adam step, which is held to twice the step's learning rate (seen 8.0e-5
  against 1.02e-4);
* the two ranks' parameters equal each other exactly;
* the same step in float64 to 1e-12 (the conv biases in front of a BN
  still to twice the learning rate).

Also in the ranks: ``merge_results_dist`` puts the ranks' results in the
global order, ``reduce_dict`` and ``average_reduce_value`` average over
them, and a sender takes a multi-rank step, which it once refused
(tests/test_torch_parallel_senders.py holds that step to one process). In one
process: the collectives are no-ops, and the loader's rank split of each
global batch is the one-process batch. Two ranks of the train CLI
(``--launcher pytorch``) give equal global losses, rank 0 alone writes, and
the evaluation merges every test sample. The ranks' code lives in
tests/torch_dp_ranks.py, which imports no JAX. ``dryrun_multichip`` (the
full-grid gate over two gloo ranks, 26 s alone on this CPU, which would take
the two new files past their time in the tier-1 run) is marked slow;
chip_smoke.py runs it on the card.
"""
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pcp_tpu_torch.datasets.loader import DataLoader
from pcp_tpu_torch.parallel import (all_reduce_gradients, all_reduce_sum, average_reduce_value,
                                    get_dist_info, merge_results_dist, reduce_dict)
from pcp_tpu_torch.train.train_state import biases_before_bn
from torch_dp_ranks import WORLD, build, cli_rank, one_step, spawn_ranks, step_rank
from torch_port_helpers import (CAR_CFG, CAR_FEATURES, MODEL_CFG, OPTIM, info_kwargs,
                                make_train_batch, torch_batch)

SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _model(cfg=MODEL_CFG):
    return build(cfg, info_kwargs())


def _one_step(batch, dtype=torch.float32):
    return one_step(MODEL_CFG, info_kwargs(), OPTIM, SEED, batch, dtype)


@pytest.fixture(scope="module")
def runs():
    batch = torch_batch(*make_train_batch(np.random.default_rng(SEED)))
    single = _one_step(batch)
    single_f64 = _one_step(batch, torch.float64)
    from test_torch_parallel_senders import sweep_batch

    car_batch = sweep_batch(np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(step_rank, (tmp, batch, MODEL_CFG, CAR_CFG, car_batch, info_kwargs(),
                                info_kwargs(CAR_FEATURES), OPTIM, SEED))
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return single, ranks, single_f64


def test_global_loss_equals_one_process(runs):
    (loss, tb, _, _), ranks, _ = runs
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=1e-5)
        assert r["tb"].keys() == tb.keys()
        for k, v in tb.items():
            assert r["tb"][k] == pytest.approx(v, rel=1e-5), k


def test_running_statistics_equal_one_process(runs):
    (_, _, sd, _), ranks, _ = runs
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert any(k.startswith("vfe.") for k in stats) and any(k.startswith("dense_head.") for k in stats)
    for k in stats:
        torch.testing.assert_close(ranks[0]["state"][k], sd[k], atol=1e-6, rtol=0, msg=k)
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
    for k in (k for k in sd if k.endswith("num_batches_tracked")):
        assert int(ranks[0]["state"][k]) == int(sd[k]) == 1, k


def test_parameters_after_the_step_equal_one_process(runs):
    (_, _, sd, lr), ranks, _ = runs
    zero_grad = biases_before_bn(_model())
    assert zero_grad  # the ego head's USE_BIAS_BEFORE_NORM
    params = {k for k, _ in _model().named_parameters()}
    for k in params:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
        atol = 2 * lr if k in zero_grad else 1e-6
        torch.testing.assert_close(ranks[0]["state"][k], sd[k], atol=atol, rtol=0, msg=k)


def test_float64_step_equals_one_process(runs):
    """In float64 no rounding reaches a kink: the loss, every statistic and
    every parameter after the step agree to 1e-12 (the conv biases in front
    of a BN to twice the learning rate, as in float32)."""
    _, ranks, (loss, tb, sd, lr) = runs
    zero_grad = biases_before_bn(_model())
    got_loss, got_tb, got, _ = ranks[0]["f64"]
    assert got_loss == pytest.approx(loss, rel=1e-12)
    for k, v in tb.items():
        assert got_tb[k] == pytest.approx(v, rel=1e-12), k
    for k, v in sd.items():
        atol = 2 * lr if k in zero_grad else 1e-12
        torch.testing.assert_close(got[k], v, atol=atol, rtol=0, msg=k)


def test_merge_results_in_global_order(runs):
    _, ranks, _ = runs
    want = [f"b{k}r{r}i{i}" for k in range(3) for r in range(WORLD) for i in range(2)][:10]
    for r in ranks:
        assert r["merged"] == want


def test_reductions_over_ranks(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert r["reduced"] == {"a": 0.5, "b": 1.0}
        assert r["summed"] == {"a": 1.0}
        assert r["average"] == 5.0
        assert r["all_reduce_sum"] == 3.0


def test_senders_refuse_a_multi_rank_step(runs):
    """The refusal is gone: the car takes a two-rank step, with the same
    finite global loss on both ranks."""
    _, ranks, _ = runs
    for r in ranks:
        assert r["refused"] is None and np.isfinite(r["car_loss"])
    assert ranks[0]["car_loss"] == ranks[1]["car_loss"]


def test_collectives_are_no_ops_in_one_process():
    assert get_dist_info() == (0, 1)
    t = torch.arange(3.0)
    assert all_reduce_sum(t) is t
    assert merge_results_dist([1, 2, 3], total_size=2) == [1, 2]
    assert reduce_dict({"x": 2.0}) == {"x": 2.0} and average_reduce_value(4) == 4.0
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    all_reduce_gradients([p])
    assert torch.equal(p.grad, torch.full((2,), 3.0))


class _Numbers:
    """A dataset whose item records its index and a draw of its generator."""

    def __len__(self):
        return 11

    def get_item(self, index, rng):
        return {"points": np.array([index, rng.uniform()], np.float32)}

    def collate_batch(self, items):
        return {"points": np.stack([i["points"] for i in items])}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rank_split_is_the_one_process_batch(drop_last):
    """Global batches of 4 over 2 ranks, two epochs: the ranks' batches,
    concatenated, are the one-process batches; without ``drop_last`` the last
    global batch is filled with the order's first items."""
    ds = _Numbers()
    one = DataLoader(ds, 4, shuffle=True, seed=3, drop_last=drop_last, num_workers=0,
                     rank=0, world_size=1)
    ranks = [DataLoader(ds, 4, shuffle=True, seed=3, drop_last=drop_last, num_workers=0,
                        rank=r, world_size=WORLD) for r in range(WORLD)]
    for epoch in (0, 1):
        for loader in [one] + ranks:
            loader.set_epoch(epoch)
        want = [b["points"] for b in one]
        got = [torch.cat([part["points"] for part in parts]) for parts in zip(*ranks)]
        assert len(got) == len(want) == len(ranks[0]) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            assert torch.equal(g[:len(w)], w)
        if not drop_last:  # 11 items: the last global batch's fourth is the order's first
            assert torch.equal(got[-1][3], want[0][0])


CFG_EGO = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_ego.yaml"


def _ego_cli_argv(root):
    """The train CLI on the ego reduced as tests/test_torch_eval.py reduces
    the car (the corrector's keys aside), fed the oracle boxflow: one epoch
    of a global batch of 2, then an evaluation of its checkpoint."""
    from test_torch_eval import REDUCED

    reduced = [v for i in range(0, len(REDUCED), 2) if "CORRECTOR" not in REDUCED[i]
               for v in REDUCED[i:i + 2]]
    return ["--cfg_file", CFG_EGO, "--batch_size", "2", "--workers", "0", "--device", "cpu",
            "--extra_tag", "dp", "--output_root", str(root), "--epochs", "1", "--seed", "3",
            "--precise_bn", "0", "--num_epochs_to_eval", "1", "--set", *reduced,
            "DATA_CONFIG.EXCHANGE_ORACLE", "True", "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1"]


def test_train_cli_launcher_pytorch(tmp_path):
    """Two ranks of the train CLI: the same global losses on both, one
    checkpoint and one log and evaluation written (by rank 0), and the
    evaluation over every test sample (the ranks' predictions merged)."""
    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.tools import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(cli_rank, (tmp, _ego_cli_argv(tmp_path)))
        ranks = [torch.load(Path(tmp) / f"cli{r}.pt", weights_only=False) for r in range(WORLD)]
    assert ranks[0]["steps"] == ranks[1]["steps"] > 0
    assert ranks[0]["losses"] == ranks[1]["losses"] and np.isfinite(ranks[0]["losses"]).all()
    out = tmp_path / "cfgs/v2x_sim_models/v2x_pointpillar_basic_ego/dp"
    assert [p.name for p in (out / "ckpt").glob("checkpoint_epoch_*.pth")] == [
        "checkpoint_epoch_1.pth"]
    logs = list(out.glob("log_train_*.txt"))
    assert len(logs) == 1 and len(list((out / "eval").rglob("metrics.json"))) == 1
    cfg, _ = train_cli.load_cfg(train_cli.parse_args(_ego_cli_argv(tmp_path)))
    test_set = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2, workers=0,
                                training=False)[0]
    assert f"eval: {len(test_set)} samples" in logs[0].read_text()


def test_dryrun_multichip_needs_its_cards():
    """By default the gate runs over NCCL with a card a rank; without the
    cards it raises rather than move to the CPU."""
    from pcp_tpu_torch.entry import dryrun_multichip

    if torch.cuda.device_count() >= WORLD:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        dryrun_multichip(WORLD)


@pytest.mark.slow
def test_dryrun_multichip_on_the_cpu():
    from pcp_tpu_torch.entry import dryrun_multichip

    summary = dryrun_multichip(WORLD, backend="gloo", device="cpu")
    assert summary["grid"] == [512, 512] and summary["merged_eval"] == WORLD
    assert summary["losses"][-1] < summary["losses"][0]
