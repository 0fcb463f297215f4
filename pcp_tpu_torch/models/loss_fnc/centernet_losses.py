"""CenterNet losses: counterpart of ``pcp_tpu/models/loss_fnc/centernet_losses.py``
(the reference's ``neg_loss_cornernet`` and ``_reg_loss``).

Under a process group of more than one rank the normalisers (the number of
positive cells, the number of valid objects) are the global batch's, and
each rank's result is its share of the global loss: the shares sum to the
loss of the whole batch, as the JAX package's step over a sharded batch
computes it."""
import torch

from ...parallel.collective import all_reduce_sum


def focal_loss_centernet(pred, gt):
    """CornerNet's modified focal loss. ``pred``: sigmoided and clipped
    heatmap, ``gt``: gaussian targets, both (B, H, W, C); a cell is positive
    where ``gt == 1``. Returns a scalar: ``-neg`` without positives, else
    ``-(pos + neg) / num_pos``."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = (torch.log(pred) * torch.pow(1.0 - pred, 2) * pos).sum()
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights * neg).sum()
    num_pos = all_reduce_sum(pos.sum())
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_loss_centernet(pred, mask, target):
    """Masked L1 per channel. ``pred`` and ``target`` (B, M, D) at the gt
    centres, ``mask`` (B, M); NaN targets are left out. Returns (D,), divided
    by ``max(num valid, 1)``."""
    num = all_reduce_sum(mask.to(pred.dtype).sum())
    m = mask.to(pred.dtype)[..., None] * (~torch.isnan(target)).to(pred.dtype)
    target = torch.nan_to_num(target)
    loss = torch.abs(pred * m - target * m).sum(dim=(0, 1))
    return loss / torch.clamp(num, min=1.0)
