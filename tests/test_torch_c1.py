"""ROADMAP C1 (the car sender's synvf row): the probe that compares one
training step of both packages, at small width.

The full-width probe (``tests/torch_c1_probe.py step``) found the port's
car step equal to the JAX package's jitted ``make_train_step`` on the
synvf batches (loss terms within 4e-5, the gradient norm within the CPU's
own spread, every gradient leaf as close to a float64 reference as the
JAX package's own). This test holds the same comparison at the small car
of ``test_torch_sender_train.py`` (seeded weights, random BN affine
parameters and statistics, a sweep batch with foreground, no corrector
decision near its boundary) through the probe's own helpers: an
adam_onecycle state mid-schedule (count 635 of 925) with seeded moments
carried to JAX by ``jax_moments`` (second moments of 1e-4 to 1e-3, so that
the update is the moments' more than the float32 rounding of this step's
gradient); the JAX package's jitted ``make_train_step`` against the port's
``take_train_step``:

* the loss and every tb term within rtol 1e-4;
* every parameter and running statistic after the step within 1e-6 of the
  JAX one (seen 2.4e-7), against updates of 7e-5 to 4e-4: a schedule read
  one step off moves the largest update by about 2e-6.
"""
import jax
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.train import build_optimizer as jax_build_optimizer
from pcp_tpu.train.train_state import TrainState as JaxTrainState
from pcp_tpu.train.train_state import make_train_step as jax_make_train_step
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.train.train_state import take_train_step
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables
from test_torch_sender_train import _car_case, _torch_batch
from torch_c1_probe import jax_moments, with_fields
from torch_port_helpers import CAR_FEATURES, OPTIM, info_kwargs

ITERS, EPOCHS, STEP = 37, 25, 17 * 37 + 6  # the synvf car's schedule; epoch 17, batch 6


@pytest.fixture(scope="module")
def both_steps():
    cfg, tmodel, variables, jb = _car_case(False)
    rng = np.random.default_rng(17)
    named = dict(tmodel.named_parameters())
    mu = {n: torch.from_numpy(rng.normal(0, 1e-2, p.shape).astype(np.float32)) for n, p in named.items()}
    nu = {n: m * m + torch.from_numpy(rng.uniform(1e-4, 1e-3, m.shape).astype(np.float32))
          for n, m in mu.items()}
    moments = {"mu": mu, "nu": nu}

    jmodel = build_jax(CfgDict(cfg), num_class=1, dataset_info=JaxInfo(**info_kwargs(CAR_FEATURES)))
    tx, _ = jax_build_optimizer(CfgDict(OPTIM), ITERS, EPOCHS)
    params = variables["params"]
    jmu, jnu = jax_moments(moments, tmodel.state_dict(), cfg)
    opt_state = with_fields(tx.init(params), count=np.int32(STEP), mu=jmu, nu=jnu)
    jstate = JaxTrainState(params=params, batch_stats=variables["batch_stats"], opt_state=opt_state,
                           step=STEP, rng=jax.random.PRNGKey(0))
    batch = dict(jb, batch_size=jb["points"].shape[0])
    new_state, jloss, jtb = jax_make_train_step(jmodel, tx, donate=False)(jstate, batch)
    jafter = state_dict_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, new_state.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)}, cfg)

    optimizer, _ = build_optimizer(TorchCfgDict(OPTIM), tmodel, ITERS, EPOCHS)
    optimizer.param_groups[0]["count"] = STEP
    for name, param in named.items():
        optimizer.state[param] = {"mu": mu[name].clone(), "nu": nu[name].clone()}
    before = {n: p.detach().clone() for n, p in named.items()}
    out = take_train_step(tmodel, optimizer, _torch_batch(jb))
    return {"jax": (float(jloss), {k: float(v) for k, v in jtb.items()}, jafter),
            "port": (out["loss"].item(), {k: v.item() for k, v in out["tb_dict"].items()},
                     tmodel.state_dict()),
            "before": before, "count": optimizer.param_groups[0]["count"]}


def test_car_step_loss_terms_match_jitted_jax(both_steps):
    jloss, jtb, _ = both_steps["jax"]
    tloss, ttb, _ = both_steps["port"]
    assert tloss == pytest.approx(jloss, rel=1e-4)
    assert set(ttb) == set(jtb) and "corrector_loss" in ttb
    for key, value in jtb.items():
        assert ttb[key] == pytest.approx(value, rel=1e-4, abs=1e-7), key
    assert both_steps["count"] == STEP + 1


def test_car_step_parameters_match_jitted_jax(both_steps):
    _, _, want = both_steps["jax"]
    _, _, got = both_steps["port"]
    checked = 0
    for name, value in got.items():
        if not value.is_floating_point():
            continue
        err = (value - want[name]).abs().max().item()
        assert err <= 1e-6, (name, err)
        checked += 1
    # the step moved every parameter by far more than the tolerance
    smallest = min((got[n] - p).abs().max().item() for n, p in both_steps["before"].items())
    assert checked > 150 and smallest > 5e-5
