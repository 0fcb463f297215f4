"""Masked Lovász-softmax plus inverse-frequency cross-entropy.

Counterpart of ``pcp_tpu/models/loss_fnc/lovasz.py`` (the reference's
``CELovaszLoss``): the HunterJr point head's segmentation loss. A validity
mask keeps padding rows out of the class statistics and the Lovász
gradient. Errors are ranked by a stable descending sort, as ``jnp.argsort``
ranks them: equal errors keep index order, which decides where the gradient
goes. Every division is by a float32 tensor.

Under a process group of more than one rank both terms are the global
batch's (``parallel/collective.py``'s rule): the class counts and the CE
normaliser are summed over the ranks, each rank's CE its rows' share; the
Lovász term ranks the errors of every rank's rows, gathered in the global
order, decides which classes are present over them, and enters each rank's
loss at ``1 / world``.
"""
import torch

from ...parallel.collective import all_gather, all_reduce_sum, whole_share

_EPS = 1e-5


def _lovasz_grad_masked(gt_sorted, valid_sorted):
    """Gradient of the Lovász extension with respect to the sorted errors,
    counting only valid entries toward intersection and union."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(valid_sorted - gt_sorted, 0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=_EPS)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax(probs, labels, valid):
    """probs (N, C) class probabilities, labels (N,) int, valid (N,) bool ->
    the mean over present classes of the Lovász hinge on their errors (this
    rank's share of the global batch's)."""
    probs, labels, valid = all_gather(probs, labels, valid)
    valid_f = valid.to(probs.dtype)
    losses, present = [], []
    for cls in range(probs.shape[1]):
        fg = ((labels == cls) & valid).to(probs.dtype)
        class_present = fg.sum() > 0
        errors = torch.abs(fg - probs[:, cls]) * valid_f
        order = torch.sort(-errors, stable=True).indices
        grad = _lovasz_grad_masked(fg[order], valid_f[order])
        losses.append(torch.where(class_present, torch.dot(errors[order], grad),
                                  errors.new_zeros(())))
        present.append(class_present)
    present = torch.stack(present).to(probs.dtype)
    return whole_share(torch.stack(losses).sum() / torch.clamp(present.sum(), min=1.0))


def ce_lovasz_loss(logits, labels, valid, num_classes, max_weight=50.0):
    """Cross-entropy weighted by the square root of each class's inverse
    frequency among the valid rows (clipped at ``max_weight``), plus
    Lovász-softmax. logits (N, C), labels (N,) int, valid (N,) bool."""
    valid_f = valid.to(logits.dtype)
    counts = all_reduce_sum(torch.stack([((labels == c) & valid).to(logits.dtype).sum()
                                         for c in range(num_classes)])) + _EPS
    weights = torch.clamp(torch.sqrt(counts.sum() / counts), 0.0, max_weight)

    labels_c = torch.clamp(labels, 0, num_classes - 1).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels_c[:, None])[:, 0]
    w = weights[labels_c] * valid_f
    loss_ce = (nll * w).sum() / torch.clamp(all_reduce_sum(w.sum()), min=_EPS)
    return loss_ce + lovasz_softmax(torch.softmax(logits, dim=-1), labels_c, valid)
