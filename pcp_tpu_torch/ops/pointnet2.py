"""PointNet++ primitives in torch: counterpart of ``pcp_tpu/ops/pointnet2.py``.

Farthest point sampling, ball query, grouping and 3-NN interpolation over
one padded layout, ``(B, N, ...)`` with validity masks and channel-last
features, with the JAX package's index rules, held exactly:

* FPS starts at index 0 and takes the first index of the largest distance;
  a masked point is never taken while a valid one remains;
* ball query keeps the first ``nsample`` in-radius points in index order and
  fills the remaining slots with the first; an empty ball gives zeros;
* three_nn takes the three nearest by squared distance, ties to the lower
  index (``lax.top_k``), and returns Euclidean distances;
* ``norm3`` is ``jnp.linalg.norm`` over 3 coordinates (VectorPool's and
  SPC sampling's distances).

Squared distances are ``|a|^2 + |b|^2 - 2 a.b``, the JAX package's form
with the rounding of its jitted code on the CPU (XLA fuses every sum of
products over the 3 coordinates into fused multiply-adds), written as
elementwise products and emulated fused multiply-adds in a fixed order (no
matmul, no reduction), so that the CPU and the card compute the same bits as
the JAX package's jitted model. Plain torch ops on whatever device the tensors lie on: the JAX
package reaches no Pallas kernel here. FPS runs ``npoint`` sequential steps
of a few batched ops each, for the whole batch at once.
"""
import torch


def fma(x, y, z):
    """``x * y + z`` rounded once in float32: the product of two float32
    values is exact in float64, and so, but for a double rounding about once
    in 2^29, is the sum. In float64, plain ops."""
    if x.dtype == y.dtype == z.dtype == torch.float32:
        return (x.double() * y.double() + z.double()).float()
    return x * y + z


def _dot3(a, b):
    """Sum over the last axis of 3, as XLA's fused multiply-reduce on the
    CPU: ``fma(a2, b2, fma(a1, b1, a0 * b0))``."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def norm3(v):
    """Euclidean norm over the last axis of 3, as the JAX package's jitted
    ``jnp.linalg.norm`` on the CPU rounds it in float32: the correctly
    rounded square root of the fused sum of squares (``_dot3``)."""
    if v.dtype != torch.float32:
        return torch.sqrt(_dot3(v, v))
    return torch.sqrt(_dot3(v, v).double()).float()


def _dot3_pairs(a, b):
    """``_dot3(a[..., :, None, :], b[..., None, :, :])``, (B, M, N) float32 for
    float32 a (B, M, 3) and b (B, N, 3), with one float64 buffer: the
    product of two float32 values is exact in float64, so ``addcmul_`` there
    is ``fma``'s single rounding."""
    ad, bd = a.double(), b.double()
    t = a[..., :, None, 0] * b[..., None, :, 0]
    acc = t.double()
    for i in (1, 2):
        acc.addcmul_(ad[..., :, None, i], bd[..., None, :, i])
        t.copy_(acc)
        if i == 1:
            acc.copy_(t)
    return t


def square_distance(a, b, a_mask=None, b_mask=None, fill=float("inf")):
    """Pairwise squared L2 distances (B, M, N) between a (B, M, 3) and b
    (B, N, 3), in float32 whatever their dtype (as the JAX package), clamped
    at 0; masked rows and columns hold ``fill``. Every sum of products is
    XLA's fused one (``_dot3``): a point coinciding with a centroid keeps the
    same rounding residue in both packages (its distance, the square root of
    that residue, weighs in three_nn). The (B, M, N) work runs in place, and
    the distances carry no gradient (pcdet's ball query and three-NN have
    none)."""
    a, b = a.detach().float(), b.detach().float()
    d2 = _dot3(a, a)[..., :, None] + _dot3(b, b)[..., None, :]
    d2.sub_(_dot3_pairs(a, b).mul_(2.0)).clamp_(min=0.0)
    if b_mask is not None:
        d2.masked_fill_(~b_mask[..., None, :], fill)
    if a_mask is not None:
        d2.masked_fill_(~a_mask[..., :, None], fill)
    return d2


def farthest_point_sample(xyz, npoint, mask=None):
    """xyz (B, N, 3) -> idx (B, npoint) int64, starting at index 0; in
    float32 whatever the dtype of ``xyz``, as the JAX package. Indices carry
    no gradient."""
    xyz = xyz.detach().float()
    b, n, _ = xyz.shape
    # a masked point's running distance stays -1, under every valid one's
    mind2 = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    if mask is not None:
        mind2.masked_fill_(~mask, -1.0)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    last = idx[:, 0]
    rows = torch.arange(b, device=xyz.device)
    for k in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        dd = d.double()
        t = d[..., 0] * d[..., 0]
        t = torch.addcmul(t.double(), dd[..., 1], dd[..., 1]).float()
        t = torch.addcmul(t.double(), dd[..., 2], dd[..., 2]).float()
        torch.minimum(mind2, t, out=mind2)
        last = torch.argmax(mind2, dim=-1)
        idx[:, k] = last
    return idx


def ball_query(radius, nsample, xyz, new_xyz, mask=None, new_mask=None, d2=None):
    """The first ``nsample`` points of ``xyz`` within ``radius`` of each
    query of ``new_xyz`` (B, M, 3), in index order, the first repeated into
    the free slots. ``d2`` may hand in ``square_distance(new_xyz, xyz,
    new_mask, mask)``, which depends on neither radius nor nsample.

    Returns idx (B, M, nsample) int64 (zeros for an empty ball) and empty
    (B, M) bool."""
    if d2 is None:
        d2 = square_distance(new_xyz, xyz, a_mask=new_mask, b_mask=mask)
    inside = d2 < radius * radius
    b, m, n = inside.shape
    # the in-radius pairs in (query, index) order, each one's rank in its ball
    query, point = inside.reshape(b * m, n).nonzero(as_tuple=True)
    counts = torch.bincount(query, minlength=b * m)
    rank = torch.arange(query.shape[0], device=query.device) - (torch.cumsum(counts, 0) - counts)[query]
    first = torch.zeros(b * m, dtype=torch.int64, device=query.device)
    first[query[rank == 0]] = point[rank == 0]
    out = first[:, None].expand(b * m, nsample).clone()
    keep = rank < nsample
    out[query[keep], rank[keep]] = point[keep]
    return out.reshape(b, m, nsample), (counts == 0).reshape(b, m)


def gather_points(points, idx):
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx[..., None].expand(*idx.shape, points.shape[-1]))


def group_points(points, idx):
    """points (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    return gather_points(points, idx.reshape(b, m * s)).reshape(b, m, s, points.shape[-1])


def three_nn(unknown, known, known_mask=None):
    """Euclidean distances (B, N, 3) and indices (B, N, 3) int64 of the three
    nearest valid ``known`` points of each ``unknown`` point, nearest first,
    ties to the lower index."""
    d2 = square_distance(unknown, known, b_mask=known_mask)
    taken = torch.zeros_like(d2, dtype=torch.bool)
    dists, idxs = [], []
    for _ in range(3):
        cand = torch.where(taken, float("inf"), d2)
        best = cand.min(dim=-1, keepdim=True).values
        i = torch.argmax(((cand == best) & ~taken).to(torch.uint8), dim=-1, keepdim=True)
        taken.scatter_(-1, i, True)
        idxs.append(i)
        dists.append(torch.gather(d2, -1, i))
    # a float64 square root rounds to the correctly rounded float32 one,
    # which torch's vectorised float32 square root on the CPU is not always
    d = torch.sqrt(torch.clamp(torch.cat(dists, -1), min=0.0).double()).float()
    return d, torch.cat(idxs, -1)


def three_interpolate(features, idx, weight):
    """features (B, M, C), idx and weight (B, N, 3) -> (B, N, C)."""
    g = group_points(features, idx)
    w = weight[..., None].to(torch.promote_types(features.dtype, weight.dtype))
    return fma(g[..., 2, :].to(w.dtype), w[..., 2, :],
               fma(g[..., 1, :].to(w.dtype), w[..., 1, :], g[..., 0, :] * w[..., 0, :]))
