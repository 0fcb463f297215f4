"""BatchNorm running-statistics recalibration (SWA-style ``update_bn``).

Counterpart of ``pcp_tpu/train/bn_recal.py``: the running statistics become
the average over a loader of each batch's statistics. Every BN update is
``new = r * old + (1 - r) * batch`` (r = 1 - momentum); the JAX package
recovers a batch's statistics from a forward that starts at zero
statistics, dividing by the ``1 - r^k`` that the forward's k updates leave
(it reads r^k off a second forward that starts at ones). A BN that one
forward reaches k times thus contributes ``sum_j (1 - r) r^(k-j) s_j /
(1 - r^k)``, its k calls' statistics weighted as its updates weigh them;
DiscoNet's shared compressor and pixel weightor are reached six times a
forward. Here each batch starts every BN in training mode from zero
running statistics, runs at the BN's own momentum, and divides by
``1 - (1 - momentum)^k``, k being the forward's increase of
``num_batches_tracked``. Setting every momentum to 1, as this module once
did, keeps only the last of the k calls' statistics, which for k = 1 is the
same. Each BN keeps its own convention (the biased variance for the
flax-convention ``BatchNorm2d``, the unbiased one for ``MaskedBatchNorm``).
A BN that no forward updates (one behind an untaken branch, or a frozen
module that stays in eval mode: DiscoNet's BEV makers, the teacher) keeps
its values, as the JAX package keeps the leaves a training-mode apply never
updates.
"""
import torch
from torch.nn.modules.batchnorm import _BatchNorm


@torch.no_grad()
def recalibrate_batch_stats(model, loader, to_device, max_batches=None, logger=None):
    """Replace the running statistics of every BN of ``model`` that a
    training-mode forward updates with their average over the batches of
    ``loader`` (at most ``max_batches``). ``to_device`` maps a loader batch
    to what the model takes. The model's training flag, momenta, weights and
    batch counters are left as they were. Returns the number of batches
    averaged."""
    norms = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    kept = [(m.running_mean.clone(), m.running_var.clone(), m.num_batches_tracked.clone())
            for m in norms]
    sums = [[torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var), 0] for m in norms]
    was_training = model.training
    model.train()
    live = [m.training for m in norms]  # frozen modules stay in eval mode
    count = 0
    try:
        for batch in loader:
            if max_batches is not None and count >= max_batches:
                break
            for m, on in zip(norms, live):
                if on:
                    m.running_mean.zero_()
                    m.running_var.zero_()
            before = [int(m.num_batches_tracked) for m in norms]
            model(to_device(batch))
            for m, s, b in zip(norms, sums, before):
                k = int(m.num_batches_tracked) - b
                if k:
                    share = 1.0 - (1.0 - m.momentum) ** k
                    s[0] += m.running_mean / share
                    s[1] += m.running_var / share
                    s[2] += 1
            count += 1
    finally:  # a failed pass changes nothing
        model.train(was_training)
        for m, (mean, var, tracked) in zip(norms, kept):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
            m.num_batches_tracked.copy_(tracked)
    for m, (mean, var, n) in zip(norms, sums):
        if n:
            m.running_mean.copy_(mean / n)
            m.running_var.copy_(var / n)
    if logger is not None:
        logger.info(f"BN recalibration: averaged statistics over {count} batches")
    return count
