"""HunterJr support ops.

Counterpart of ``pcp_tpu/models/bev_layers/hunter_toolbox.py``: bilinear
sampling of the BEV image at point positions, mean-scatter of point features
back to the BEV, the MLP stacks of the point and object heads, and for
training the unnormalised quaternion to rotation matrix and the hard-mined
regression loss.

The BEV image is taken channels-last, (B, H, W, C), as the JAX package takes
it: a corner gather then reads rows of C contiguous floats.
"""
import torch
from torch import nn

from ...parallel.collective import all_gather, all_reduce_sum, whole_share
from ..model_utils.norm import MaskedBatchNorm


def bilinear_interpolate_bev(bev_img, points_xy, pc_range, pixel_size):
    """Sample per-point features from a BEV image, batched.

    Args:
        bev_img: (B, H, W, C); points_xy: (B, N, 2) metric xy;
        pc_range: float32 tensor (>= 2,); pixel_size: float32 tensor (2,) =
        voxel_size * stride. Both are tensors: CUDA divides by a Python
        number as a multiply by its reciprocal, which moves points on pixel
        borders.
    Returns:
        feats (B, N, C), bev_coord (B, N, 2) float pixel coords (x, y).
    """
    b, h, w, c = bev_img.shape
    coord = (points_xy - pc_range[:2]) / pixel_size
    x, y = coord[..., 0], coord[..., 1]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)

    flat = bev_img.reshape(b * h * w, c)
    base = torch.arange(b, device=bev_img.device)[:, None] * (h * w)

    def gather(yy, xx):
        return flat.index_select(0, (base + yy * w + xx).reshape(-1)).reshape(b, -1, c)

    x0f, x1f = x0.to(x.dtype), x1.to(x.dtype)
    y0f, y1f = y0.to(y.dtype), y1.to(y.dtype)
    wa = ((x1f - x) * (y1f - y))[..., None]
    wb = ((x1f - x) * (y - y0f))[..., None]
    wc = ((x - x0f) * (y1f - y))[..., None]
    wd = ((x - x0f) * (y - y0f))[..., None]
    out = gather(y0, x0) * wa
    out += gather(y1, x0) * wb
    out += gather(y0, x1) * wc
    out += gather(y1, x1) * wd
    return out, coord


def bev_scatter(bev_coord, feats, valid, h, w):
    """Mean-scatter point features into a dense BEV image.

    Args:
        bev_coord: (B, N, 2) float pixel coords (x, y); feats: (B, N, C);
        valid: (B, N) bool.
    Returns:
        (B, H, W, C).
    Only strictly interior coords count (``x > 0``, as the JAX package and
    the reference keep them); a kept coord is truncated to its pixel.
    Dropped rows go to one extra row of the sums, which is cut off.
    """
    b, n, c = feats.shape
    x, y = bev_coord[..., 0], bev_coord[..., 1]
    ok = valid & (x > 0) & (x < w) & (y > 0) & (y < h)
    xi = torch.clamp(torch.where(ok, x, 0.0).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.where(ok, y, 0.0).to(torch.int64), 0, h - 1)
    pid = yi * w + xi + torch.arange(b, device=feats.device)[:, None] * (h * w)
    pid = torch.where(ok, pid, b * h * w).reshape(-1)

    fsum = feats.new_zeros((b * h * w + 1, c)).index_add_(0, pid, feats.reshape(b * n, c))
    cnt = feats.new_zeros((b * h * w + 1,)).index_add_(0, pid, ok.reshape(-1).to(feats.dtype))
    mean = fsum[:-1] / torch.clamp(cnt[:-1], min=1.0)[:, None]
    return mean.reshape(b, h, w, c)


class MLP(nn.Sequential):
    """Linear stacks as pcdet's ``nn_make_mlp`` lays them out: hidden and
    non-head layers are Linear (no bias), ``MaskedBatchNorm`` (eps 1e-3,
    momentum 0.01) and ReLU, so Linear k sits at index 3k and its BN at
    3k+1; a head ends in a biased Linear."""

    def __init__(self, in_channels, out_channels, hidden_channels=(), is_head=True):
        layers = []
        dims = list(hidden_channels) + [out_channels]
        for i, d in enumerate(dims):
            if i == len(dims) - 1 and is_head:
                layers.append(nn.Linear(in_channels, d, bias=True))
            else:
                layers += [nn.Linear(in_channels, d, bias=False),
                           MaskedBatchNorm(d, eps=1e-3, momentum=0.01), nn.ReLU()]
            in_channels = d
        super().__init__(*layers)

    def forward(self, x, valid=None):
        for layer in self:
            x = layer(x, valid) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x


def quat2mat(quat):
    """(..., 4) quaternion [x, y, z, w] -> (..., 3, 3) rotation matrix, NOT
    normalised first: the reference does not normalise, and training follows
    it."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = torch.stack([w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
                        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
                        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2], dim=-1)
    return rows.reshape(quat.shape[:-1] + (3, 3))


def hard_mining_regression_loss(loss_all, mask_positive, valid, neg_to_pos_ratio=1,
                                num_negative_when_no_positive=100):
    """Mean loss of the valid positives plus the mean of the
    ``num_pos * neg_to_pos_ratio`` largest losses of the valid negatives
    (``num_negative_when_no_positive`` of them, alone, when there is no
    positive), with the JAX package's static shapes: the negatives are ranked
    by a stable descending sort (equal losses keep index order, which decides
    where the gradient goes) and the count becomes a rank mask. Counts stay on
    the device; every division is by a float32 tensor.

    Under a process group of more than one rank the counts, ``k`` and the
    positives' mean are the global batch's (this rank's positives over the
    global count), and the negatives are ranked over every rank's rows in
    the global order, the top-k mean entering each rank's loss at
    ``1 / world`` (``parallel/collective.py``'s rule)."""
    zero = loss_all.new_zeros(())
    loss_all = torch.where(valid, loss_all, zero)
    pos = mask_positive & valid
    neg = ~mask_positive & valid
    num_pos = all_reduce_sum(pos.sum())
    num_neg = all_reduce_sum(neg.sum())
    loss_pos_mean = torch.where(pos, loss_all, zero).sum() / num_pos.clamp(min=1).to(loss_all.dtype)

    neg_losses = all_gather(torch.where(neg, loss_all, loss_all.new_full((), float("-inf"))))
    order = torch.sort(-neg_losses, stable=True).indices
    ranked = neg_losses[order]
    ranked = torch.where(torch.isfinite(ranked), ranked, zero)
    ranks = torch.arange(neg_losses.shape[0], device=loss_all.device)
    k = torch.where(num_pos > 0, torch.minimum(num_pos * neg_to_pos_ratio, num_neg),
                    num_neg.clamp(max=num_negative_when_no_positive))
    top_neg_mean = whole_share(torch.where(ranks < k, ranked, zero).sum()
                               / k.clamp(min=1).to(loss_all.dtype))
    with_pos = loss_pos_mean + torch.where(num_neg > 0, top_neg_mean, zero)
    return torch.where(num_pos > 0, with_pos, top_neg_mean)
