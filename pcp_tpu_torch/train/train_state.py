"""Train state and step factories: counterpart of ``pcp_tpu/train/train_state.py``.

The JAX package's ``TrainState`` holds params, batch stats, optimizer state
and step as a pytree; here the model holds the parameters and running
statistics, the optimizer its state and the step count (``count`` of its
param group), and :class:`TrainState` bundles the two. A train step is:
zero the gradients, forward in training mode (loss and running-statistics
update), backward, then the optimizer step, which clips by global norm,
updates and counts the step. Under a process group of more than one rank
(``parallel/``) the step is the one-process step over the global batch:
batch statistics and loss normalisers are global (``norm.py``,
``centernet_losses.py``), each rank's loss is its share of the global loss,
the gradients are summed over the ranks before the optimizer, and the loss
and terms the step returns are the global ones. Only the ego trains so;
the senders and DiscoNet raise (ROADMAP A10b).

    cfg, info, model = build(CFG_EGO, device="cuda")
    optimizer, lr_fn = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch, epochs)
    state = create_train_state(model, optimizer, seed=0)
    train_step = make_train_step(model, optimizer)
    loss, tb_dict = train_step(batch)
"""
import dataclasses

import torch
from torch import nn

from ..models.model_utils.norm import MaskedBatchNorm
from ..parallel.collective import all_reduce_gradients, all_reduce_sum, get_dist_info

# flax's lecun_normal: a normal truncated at +-2 std, scaled back to unit
# variance by this factor (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def step(self):
        """Steps taken: the optimizer's count."""
        return int(self.optimizer.param_groups[0]["count"])


def _lecun_normal_(weight, fan_in, generator):
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    w = torch.empty(weight.shape, dtype=weight.dtype)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    weight.copy_(w)


@torch.no_grad()
def init_weights(model, seed):
    """Initial weights as the JAX package's modules draw them: flax's default
    ``lecun_normal`` (fan-in) for Dense, Conv and ConvTranspose kernels, zero
    biases except the hm output's -2.19, BN scale 1 and bias 0, running mean
    0 and variance 1. Drawn in module order on the CPU from a generator
    seeded by ``seed``, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # flax's fan-in: kernel taps times input channels; a torch
            # ConvTranspose2d weight is (in, out, kh, kw)
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            _lecun_normal_(w, fan_in, gen)
            if m.bias is not None:
                m.bias.fill_(-2.19 if name.split(".")[-2:-1] == ["hm"] else 0.0)
        elif isinstance(m, (nn.BatchNorm2d, MaskedBatchNorm)):
            m.reset_parameters()


def create_train_state(model, optimizer, seed):
    """Initialise ``model``'s weights from ``seed`` (:func:`init_weights`),
    clear ``optimizer``'s state and count, and put the model in training
    mode."""
    init_weights(model, seed)
    optimizer.state.clear()
    for group in optimizer.param_groups:
        group["count"] = 0
    model.train()
    return TrainState(model, optimizer)


def take_train_step(model, optimizer, batch):
    """One train step of ``model`` on ``batch`` (this rank's share of the
    global batch under a process group): zero the gradients, forward in
    training mode, backward, sum the gradients over the ranks, optimizer
    step. Returns the forward's outputs (this rank's loss share)."""
    if get_dist_info()[1] > 1 and any(hasattr(model, k) for k in ("corrector", "v2x_mid_fusion")):
        raise NotImplementedError("data-parallel training of the senders and DiscoNet is not "
                                  "ported yet (ROADMAP A10b)")
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(batch)
    out["loss"].backward()
    all_reduce_gradients(model.parameters())
    optimizer.step()
    return out


def make_train_step(model, optimizer):
    """``train_step(batch) -> (loss, tb_dict)``, tensors on the model's
    device, the global batch's; the host does not wait for the card."""

    def train_step(batch):
        out = take_train_step(model, optimizer, batch)
        keys = list(out["tb_dict"])
        shares = torch.stack([out["loss"].detach()] + [out["tb_dict"][k].detach() for k in keys])
        total = all_reduce_sum(shares)
        return total[0], dict(zip(keys, total[1:]))

    return train_step


def biases_before_bn(model):
    """Names of the conv biases that a BN follows: their gradient is 0 in
    exact arithmetic."""
    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, nn.Sequential):
            kids = list(m.named_children())
            for (name, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(a, nn.Conv2d) and a.bias is not None and isinstance(b, nn.BatchNorm2d):
                    names.add(f"{prefix}.{name}.bias")
    return names


def make_eval_step(model):
    """``eval_step(batch) -> final_box_dicts``, in eval mode, no gradients."""

    def eval_step(batch):
        model.eval()
        with torch.inference_mode():
            return model(batch)["final_box_dicts"]

    return eval_step
