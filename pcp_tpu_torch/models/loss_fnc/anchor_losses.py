"""Anchor-head losses: counterpart of ``pcp_tpu/models/loss_fnc/anchor_losses.py``
(pcdet's ``loss_utils.py``): the sigmoid focal loss, the weighted smooth-L1
with code weights and the weighted cross-entropy, each unreduced, with the
JAX package's arithmetic."""
import torch


def sigmoid_bce_with_logits(logits, target):
    """``max(x, 0) - x * z + log1p(exp(-|x|))``."""
    return torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))


def sigmoid_focal_cls_loss(logits, target, weights, alpha=0.25, gamma=2.0):
    """(B, A, C) logits and one-hot target, (B, A) weights -> (B, A, C)."""
    pred_sigmoid = torch.sigmoid(logits)
    alpha_weight = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - pred_sigmoid) + (1.0 - target) * pred_sigmoid
    loss = alpha_weight * torch.pow(pt, gamma) * sigmoid_bce_with_logits(logits, target)
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def weighted_smooth_l1(pred, target, weights=None, beta=1.0 / 9.0, code_weights=None):
    """(B, A, D) pred and target, (B, A) weights -> (B, A, D); a NaN target
    takes the prediction's value."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * diff.new_tensor([float(w) for w in code_weights])
    n = torch.abs(diff)
    loss = n if beta < 1e-5 else torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits, one_hot_target, weights):
    """(B, A, C) logits and one-hot target, (B, A) weights -> (B, A)."""
    return -(one_hot_target * torch.log_softmax(logits, dim=-1)).sum(-1) * weights
