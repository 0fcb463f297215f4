"""The port's BN conventions, schedules and optimizers against the JAX package.

* ``MaskedBatchNorm`` and the flax-convention ``BatchNorm2d`` after one
  training forward on 16 rows at momentum 0.5: output (atol 1e-5: flax takes
  the variance as E[x^2] - E[x]^2), running mean and variance (rtol 1e-5).
  With 16 rows the unbiased variance is 16/15 of the biased one, so at this
  momentum the wrong bias moves the running variance by about 3%, far
  outside the tolerance; each test checks that too.
* The one-cycle LR and beta1 at the steps of ``tests/test_train.py``
  (rtol 5e-4 against the JAX package's float32 schedule; the port's is
  float64 and equals the reference formula to 1e-12).
* Ten updates of ``adam_onecycle``, ``adam`` and ``sgd`` against the optax
  transforms of ``pcp_tpu/train/optimization.py`` from the same numpy
  gradients, with clipping off, on and not reached, and on and reached
  (rtol 1e-5, atol 1e-7).
"""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models.model_utils.norm import MaskedBatchNorm as JaxMaskedBN
from pcp_tpu.train.optimization import build_optimizer as jax_build_optimizer
from pcp_tpu.train.optimization import one_cycle_fns as jax_one_cycle
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.models.model_utils.norm import BatchNorm2d, MaskedBatchNorm
from pcp_tpu_torch.train.optimization import build_optimizer, clip_by_global_norm_, one_cycle_fns


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

ROWS, C, MOMENTUM = 16, 4, 0.5


def _rows(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, size=(ROWS, C)).astype(np.float32)
    mask = rng.uniform(size=ROWS) > 0.3
    stats = (rng.normal(0, 0.5, C).astype(np.float32), rng.uniform(0.5, 2.0, C).astype(np.float32))
    affine = (rng.uniform(0.8, 1.2, C).astype(np.float32), rng.normal(0, 0.1, C).astype(np.float32))
    return x, mask, stats, affine


def _load(bn, stats, affine):
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(stats[1]))
        bn.weight.copy_(torch.from_numpy(affine[0]))
        bn.bias.copy_(torch.from_numpy(affine[1]))
    return bn.train()


def _variables(stats, affine):
    return {"params": {"scale": jnp.asarray(affine[0]), "bias": jnp.asarray(affine[1])},
            "batch_stats": {"mean": jnp.asarray(stats[0]), "var": jnp.asarray(stats[1])}}


def _hold_running_var(got, want, other):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.abs(other - want).max() > 100 * 1e-5 * np.abs(want).max()  # the wrong bias fails


def test_masked_batch_norm_matches():
    x, mask, stats, affine = _rows(0)
    n = mask.sum()
    y, upd = JaxMaskedBN(momentum=MOMENTUM, epsilon=1e-3).apply(
        _variables(stats, affine), jnp.asarray(x), mask=jnp.asarray(mask),
        use_running_average=False, mutable=["batch_stats"])
    bn = _load(MaskedBatchNorm(C, eps=1e-3, momentum=MOMENTUM), stats, affine)
    out = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5)
    biased = (1 - MOMENTUM) * stats[1] + MOMENTUM * x[mask].var(0)
    _hold_running_var(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), biased)
    assert n < ROWS  # the mask took rows out


class _FlaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.BatchNorm(use_running_average=False, momentum=1 - MOMENTUM, epsilon=1e-5)(x)


def test_flax_convention_batch_norm_matches():
    x, _, stats, affine = _rows(1)
    variables = {"params": {"BatchNorm_0": _variables(stats, affine)["params"]},
                 "batch_stats": {"BatchNorm_0": _variables(stats, affine)["batch_stats"]}}
    y, upd = _FlaxBN().apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = _load(BatchNorm2d(C, eps=1e-5, momentum=MOMENTUM), stats, affine)
    out = bn(torch.from_numpy(x)[..., None, None])[..., 0, 0]  # (16, 4) as (16, 4, 1, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=0)
    want = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]), rtol=1e-5)
    unbiased = (1 - MOMENTUM) * stats[1] + MOMENTUM * x.var(0, ddof=1)  # torch's own BatchNorm2d
    _hold_running_var(bn.running_var.numpy(), np.asarray(want["var"]), unbiased)
    plain = _load(torch.nn.BatchNorm2d(C, eps=1e-5, momentum=MOMENTUM), stats, affine)
    plain(torch.from_numpy(x)[..., None, None])
    np.testing.assert_allclose(plain.running_var.numpy(), unbiased, rtol=1e-5)


def test_one_cycle_matches():
    total, lr_max, moms, div, pct = 1000, 3e-3, (0.95, 0.85), 10.0, 0.4
    jlr, jmom = jax_one_cycle(total, lr_max, moms, div, pct)
    lr, mom = one_cycle_fns(total, lr_max, moms, div, pct)
    a1 = int(total * pct)

    def ref(start, end, pct):
        return end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)

    for step in [0, 1, 100, a1 - 1, a1, a1 + 1, 500, 999]:
        assert lr(step) == pytest.approx(float(jlr(step)), rel=5e-4), step
        assert mom(step) == pytest.approx(float(jmom(step)), rel=5e-4), step
        if step < a1:
            want = ref(lr_max / div, lr_max, step / a1), ref(moms[0], moms[1], step / a1)
        else:
            want = (ref(lr_max, lr_max / div / 1e4, (step - a1) / (total - a1)),
                    ref(moms[1], moms[0], (step - a1) / (total - a1)))
        assert (lr(step), mom(step)) == pytest.approx(want, rel=1e-12), step


SHAPES = {"w": (6, 5), "b": (5,), "k": (3, 3, 2, 4)}
OPTIMS = {
    "adam_onecycle": {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
                      "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10},
    "adam": {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.01, "DECAY_STEP_LIST": [1, 2],
             "LR_DECAY": 0.1, "LR_CLIP": 1e-7},
    "sgd": {"OPTIMIZER": "sgd", "LR": 0.003, "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9,
            "DECAY_STEP_LIST": [1, 2], "LR_DECAY": 0.1, "LR_CLIP": 1e-7},
}


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("clip", [0, 100, 0.5], ids=["clip_off", "clip_not_reached", "clip_reached"])
@pytest.mark.parametrize("name", list(OPTIMS))
def test_ten_updates_match_optax(name, clip):
    """Ten steps over 4 iterations an epoch (the step decays at 4 and 8),
    gradients from numpy, whose global norms lie between 0.5 and 100."""
    rng = np.random.default_rng(5)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(10)]
    cfg = dict(OPTIMS[name], GRAD_NORM_CLIP=clip)
    tx, _ = jax_build_optimizer(CfgDict(cfg), total_iters_each_epoch=4, total_epochs=3)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    module = _Params(params)
    optimizer, _ = build_optimizer(TorchCfgDict(cfg), module, total_iters_each_epoch=4, total_epochs=3)
    for g in grads:
        assert 0.5 < np.sqrt(sum((v ** 2).sum() for v in g.values())) < 100
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert optimizer.param_groups[0]["count"] == 10


def test_clip_uses_optax_formula():
    """At or above the clip a gradient is scaled by clip / norm exactly
    (``clip_grad_norm_`` would give clip / (norm + 1e-6)); under it, left as
    it is."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = clip_by_global_norm_(g, 5.0)
    assert norm.item() == 5.0 and g[0].tolist() == [3.0, 4.0]
    clip_by_global_norm_(g, 2.5)
    assert g[0].tolist() == [1.5, 2.0]
    h = [torch.tensor([6.0, 8.0])]
    clip_by_global_norm_(h, 11.0)
    assert h[0].tolist() == [6.0, 8.0]
