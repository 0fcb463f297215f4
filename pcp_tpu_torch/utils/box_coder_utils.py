"""Residual box coders of the anchor heads, the ROI heads and the point head.

Counterpart of ``ResidualCoder``, ``PreviousResidualDecoder`` and
``PointResidualCoder`` in ``pcp_tpu/utils/box_coder_utils.py`` (pcdet's ``box_coder_utils.py``), with
the same arithmetic in the same order: an anchor's residual is its centre
offset over the anchor's BEV diagonal (z over its height), the log of the
size ratio and the heading difference (or, with ``encode_angle_by_sincos``,
the differences of cos and sin). Boxes and anchors are (..., 7 + C) in pcdet's
``[x, y, z, dx, dy, dz, heading, ...]``; sizes are floored at 1e-5 on copies.
"""
import torch


class ResidualCoder:
    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if self.encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """boxes, anchors: (..., 7 + C) -> (..., code_size)."""
        anchors_dim = torch.clamp(anchors[..., 3:6], min=1e-5)
        boxes_dim = torch.clamp(boxes[..., 3:6], min=1e-5)
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors_dim.unbind(-1)
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = boxes_dim.unbind(-1)
        ra, rg = anchors[..., 6], boxes[..., 6]

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        cols = [(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        if self.encode_angle_by_sincos:
            cols += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            cols.append(rg - ra)
        cols += [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        return torch.stack(cols, dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings: (..., code_size), anchors: (..., 7 + C) -> (..., 7 + C)."""
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        ra = anchors[..., 6]
        xt, yt, zt = box_encodings[..., 0], box_encodings[..., 1], box_encodings[..., 2]
        dxt, dyt, dzt = box_encodings[..., 3], box_encodings[..., 4], box_encodings[..., 5]

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        cols = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        if self.encode_angle_by_sincos:
            cols.append(torch.atan2(box_encodings[..., 7] + torch.sin(ra),
                                    box_encodings[..., 6] + torch.cos(ra)))
            extra_start = 8
        else:
            cols.append(box_encodings[..., 6] + ra)
            extra_start = 7
        # pcdet's zip: extra channels only where both sides have them
        n_extra = min(anchors.shape[-1] - 7, box_encodings.shape[-1] - extra_start)
        cols += [box_encodings[..., extra_start + i] + anchors[..., 7 + i] for i in range(n_extra)]
        return torch.stack(cols, dim=-1)


class PreviousResidualDecoder:
    """The legacy decoder whose size residuals come in (w, l, h) order."""

    def __init__(self, code_size=7, **kwargs):
        self.code_size = code_size

    @staticmethod
    def decode(box_encodings, anchors):
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        ra = anchors[..., 6]
        xt, yt, zt = box_encodings[..., 0], box_encodings[..., 1], box_encodings[..., 2]
        wt, lt, ht = box_encodings[..., 3], box_encodings[..., 4], box_encodings[..., 5]

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        cols = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                torch.exp(lt) * dxa, torch.exp(wt) * dya, torch.exp(ht) * dza,
                box_encodings[..., 6] + ra]
        cols += [box_encodings[..., 7 + i] + anchors[..., 7 + i] for i in range(anchors.shape[-1] - 7)]
        return torch.stack(cols, dim=-1)


class PointResidualCoder:
    """Point-relative residuals with per-class mean sizes (PointRCNN's point
    head): the centre offset over the class's mean BEV diagonal (z over its
    height), the log of the size ratio, and cos and sin of the heading
    (code_size 8 + extras). The mean sizes stay float32 in every dtype, as
    the JAX package holds them."""

    def __init__(self, code_size=8, use_mean_size=True, **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if self.use_mean_size:
            self.mean_size = [[float(v) for v in row] for row in kwargs["mean_size"]]
            assert min(min(row) for row in self.mean_size) > 0

    def _anchor(self, classes, device):
        mean = torch.tensor(self.mean_size, dtype=torch.float32, device=device)
        return mean[torch.clamp(classes.long() - 1, min=0)].unbind(-1)

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (..., 7 + C), points (..., 3), gt_classes (...) 1-based."""
        dxg, dyg, dzg = torch.clamp(gt_boxes[..., 3:6], min=1e-5).unbind(-1)
        xg, yg, zg, rg = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2], gt_boxes[..., 6]
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._anchor(gt_classes, gt_boxes.device)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            cols = [(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                    torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            cols = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg)]
        cols += [torch.cos(rg), torch.sin(rg)]
        cols += [gt_boxes[..., 7 + i] for i in range(gt_boxes.shape[-1] - 7)]
        return torch.stack(cols, dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """box_encodings (..., 8 + C), points (..., 3), pred_classes 1-based."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = box_encodings[..., :8].unbind(-1)
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._anchor(pred_classes, box_encodings.device)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            cols = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                    torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            cols = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        cols.append(torch.atan2(sint, cost))
        cols += [box_encodings[..., 8 + i] for i in range(box_encodings.shape[-1] - 8)]
        return torch.stack(cols, dim=-1)
