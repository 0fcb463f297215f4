"""BatchNorm running-statistics recalibration (SWA-style ``update_bn``).

Counterpart of ``pcp_tpu/train/bn_recal.py``: the running statistics become
the plain average of per-batch statistics over a loader. The JAX package
recovers each batch's statistics algebraically from the stored values; here
every BN runs at momentum 1, so after a training-mode forward its running
statistics *are* the batch's, in its own convention: the biased variance for
the flax-convention ``BatchNorm2d``, the unbiased one for
``MaskedBatchNorm``. A BN that no forward reaches keeps its values.
"""
import torch
from torch.nn.modules.batchnorm import _BatchNorm


@torch.no_grad()
def recalibrate_batch_stats(model, loader, to_device, max_batches=None, logger=None):
    """Replace the running statistics of every BN of ``model`` with their
    average over the batches of ``loader`` (at most ``max_batches``).
    ``to_device`` maps a loader batch to what the model takes. The model's
    training flag, momenta and weights are left as they were. Returns the
    number of batches averaged."""
    norms = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    momenta = [m.momentum for m in norms]
    sums = [[torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var), 0] for m in norms]
    was_training = model.training
    model.train()
    count = 0
    try:
        for m in norms:
            m.momentum = 1.0
        for batch in loader:
            if max_batches is not None and count >= max_batches:
                break
            before = [int(m.num_batches_tracked) for m in norms]
            model(to_device(batch))
            for m, s, b in zip(norms, sums, before):
                if int(m.num_batches_tracked) != b:
                    s[0] += m.running_mean
                    s[1] += m.running_var
                    s[2] += 1
            count += 1
    finally:
        for m, momentum in zip(norms, momenta):
            m.momentum = momentum
        model.train(was_training)
    for m, (mean, var, n) in zip(norms, sums):
        if n:
            m.running_mean.copy_(mean / n)
            m.running_var.copy_(var / n)
    if logger is not None:
        logger.info(f"BN recalibration: averaged statistics over {count} batches")
    return count
