"""Sparse 3D convolution under fixed voxel budgets.

Counterpart of ``pcp_tpu/ops/sparse3d.py``, which the JAX package computes in
XLA as gathers and einsums (no Pallas kernel), so these are torch ops
(ROADMAP North star). A sparse tensor is (ids, feats): ids (B, V) int64 flat
voxel ids ``(z * ny + y) * nx + x``, sorted ascending in each sample, the
unused budget slots holding ``limit = nz * ny * nx``; feats (B, V, C).

* A neighbour lookup is an exact search of the sorted table
  (``torch.searchsorted``), where the JAX package sorts table and queries
  together: both give a query's table position, or -1 where its id is not
  active.
* A convolution gathers each output site's K inputs (a zero row where one
  is absent) into (B, V, K * Cin) and multiplies by the (K * Cin, Cout)
  kernel once. It gathers and never scatters, so its forward is
  deterministic on the card and agrees with the CPU to float32 rounding;
  the K terms are summed inside one GEMM where the JAX package adds K
  einsums, which differs by rounding alone.
* Kernel offsets run z outer, then y, then x (``kernel_offsets``), for the
  submanifold and the strided convolutions alike.

``inverse_conv_apply`` (UNetV2's) waits for ROADMAP A11.6.
"""
import numpy as np
import torch


def encode_ids(z, y, x, dims):
    nz, ny, nx = dims
    return (z * ny + y) * nx + x


def decode_ids(ids, dims):
    nz, ny, nx = dims
    z = ids // (ny * nx)
    rem = ids % (ny * nx)
    return z, rem // nx, rem % nx


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def build_gather_map(table_ids, query_ids, limit):
    """Positions of each query id in the sorted table, -1 where it is absent.

    Args:
        table_ids: (B, V) sorted, unused slots == limit.
        query_ids: (B, Q) any order, unused == limit.
    Returns:
        (B, Q) int64 positions into V.
    """
    v = table_ids.shape[1]
    pos = torch.searchsorted(table_ids.contiguous(), query_ids.contiguous())
    hit = torch.gather(table_ids, 1, pos.clamp(max=v - 1))
    found = (pos < v) & (hit == query_ids) & (query_ids < limit)
    return torch.where(found, pos, -1)


def compact_unique(ids, budget, limit):
    """(B, M) ids in any order (unused == limit) -> (B, budget) sorted unique
    ids, the tail filled with limit; uniques beyond the budget are dropped."""
    s = torch.sort(ids, dim=1)[0]
    prev = torch.cat([s.new_full((s.shape[0], 1), -1), s[:, :-1]], dim=1)
    is_first = (s != prev) & (s < limit)
    m = s.shape[1]
    key = torch.where(is_first, torch.arange(m, device=ids.device), m)
    order = torch.sort(key, dim=1, stable=True)[1][:, :budget]
    return torch.gather(torch.where(is_first, s, limit), 1, order)


def kernel_offsets(kernel_size):
    """(K, 3) z, y, x offsets of a kernel about its centre, z outer."""
    kz, ky, kx = _triple(kernel_size)
    return np.asarray([(dz - kz // 2, dy - ky // 2, dx - kx // 2)
                       for dz in range(kz) for dy in range(ky) for dx in range(kx)], dtype=np.int64)


def neighbor_map_subm(ids, offsets, dims):
    """Neighbour positions of a submanifold conv, whose output sites are its
    input sites: (B, V) sorted ids, (K, 3) offsets -> (B, K, V), -1 where
    absent."""
    nz, ny, nx = dims
    limit = nz * ny * nx
    b, v = ids.shape
    z, y, x = decode_ids(torch.clamp(ids, max=limit - 1), dims)
    off = torch.as_tensor(offsets, device=ids.device)
    qz = z[:, None, :] + off[None, :, 0, None]
    qy = y[:, None, :] + off[None, :, 1, None]
    qx = x[:, None, :] + off[None, :, 2, None]
    ok = ((ids < limit)[:, None, :] & (qz >= 0) & (qz < nz) & (qy >= 0) & (qy < ny)
          & (qx >= 0) & (qx < nx))
    qid = torch.where(ok, encode_ids(qz, qy, qx, dims), limit)
    return build_gather_map(ids, qid.reshape(b, -1), limit).reshape(b, -1, v)


def gather_conv(feats, nmap, weights):
    """sum_k feats[nmap[:, k]] @ weights[k]: feats (B, V, Cin), nmap (B, K,
    Vo) positions into V (-1 absent), weights (K, Cin, Cout) -> (B, Vo,
    Cout)."""
    b, v, cin = feats.shape
    k, vo = nmap.shape[1], nmap.shape[2]
    padded = torch.cat([feats, feats.new_zeros(b, 1, cin)], dim=1)  # row V: the absent input
    idx = torch.where(nmap >= 0, nmap, v).transpose(1, 2).reshape(b, vo * k)
    gathered = torch.gather(padded, 1, idx[..., None].expand(-1, -1, cin))
    return gathered.reshape(b, vo, k * cin) @ weights.reshape(k * cin, -1)


def subm_conv_apply(feats, nmap, weights):
    """A submanifold conv given its neighbour map: (B, V, Cin), (B, K, V),
    (K, Cin, Cout) -> (B, V, Cout)."""
    return gather_conv(feats, nmap, weights)


def strided_output_ids(ids, dims, out_dims, kernel_size, stride, padding, budget):
    """Active output sites of a strided sparse conv: every output position
    whose kernel footprint covers an active input (spconv's rule). Returns
    (B, budget) sorted unique ids, unused == the output limit."""
    kz, ky, kx = _triple(kernel_size)
    stride, padding = _triple(stride), _triple(padding)
    limit_in = dims[0] * dims[1] * dims[2]
    oz_n, oy_n, ox_n = out_dims
    limit_out = oz_n * oy_n * ox_n
    z, y, x = decode_ids(torch.clamp(ids, max=limit_in - 1), dims)
    valid = ids < limit_in
    cands = []
    for dz in range(kz):
        for dy in range(ky):
            for dx in range(kx):
                # o * s + d - p == i  <=>  o == (i + p - d) / s
                num_z, num_y, num_x = z + padding[0] - dz, y + padding[1] - dy, x + padding[2] - dx
                oz = torch.div(num_z, stride[0], rounding_mode="floor")
                oy = torch.div(num_y, stride[1], rounding_mode="floor")
                ox = torch.div(num_x, stride[2], rounding_mode="floor")
                ok = (valid & (oz * stride[0] == num_z) & (oy * stride[1] == num_y)
                      & (ox * stride[2] == num_x) & (oz >= 0) & (oz < oz_n) & (oy >= 0)
                      & (oy < oy_n) & (ox >= 0) & (ox < ox_n))
                cands.append(torch.where(ok, (oz * oy_n + oy) * ox_n + ox, limit_out))
    return compact_unique(torch.cat(cands, dim=1), budget, limit_out)


def strided_neighbor_map(in_ids, out_ids, dims, out_dims, kernel_size, stride, padding):
    """(B, K, Vo) position of each output site's input at each kernel
    offset, -1 where that input is not active."""
    kz, ky, kx = _triple(kernel_size)
    stride, padding = _triple(stride), _triple(padding)
    nz, ny, nx = dims
    limit_in = nz * ny * nx
    limit_out = out_dims[0] * out_dims[1] * out_dims[2]
    oz, oy, ox = decode_ids(out_ids, out_dims)
    out_valid = out_ids < limit_out
    maps = []
    for dz in range(kz):
        for dy in range(ky):
            for dx in range(kx):
                iz = oz * stride[0] + dz - padding[0]
                iy = oy * stride[1] + dy - padding[1]
                ix = ox * stride[2] + dx - padding[2]
                ok = (out_valid & (iz >= 0) & (iz < nz) & (iy >= 0) & (iy < ny) & (ix >= 0)
                      & (ix < nx))
                maps.append(torch.where(ok, encode_ids(iz, iy, ix, dims), limit_in))
    qid = torch.stack(maps, dim=1)  # (B, K, Vo)
    b, k, vo = qid.shape
    return build_gather_map(in_ids, qid.reshape(b, k * vo), limit_in).reshape(b, k, vo)


def strided_conv_apply(in_ids, feats, out_ids, dims, out_dims, kernel_size, stride, padding,
                       weights):
    """A strided sparse conv: each output site gathers its contributing
    inputs. weights (K, Cin, Cout) in ``kernel_offsets`` order."""
    nmap = strided_neighbor_map(in_ids, out_ids, dims, out_dims, kernel_size, stride, padding)
    return gather_conv(feats, nmap, weights)


def sparse_to_dense(ids, feats, dims):
    """A sparse tensor as a dense (B, nz, ny, nx, C) grid; each active site
    is written once (the ids are unique), so nothing is summed."""
    nz, ny, nx = dims
    limit = nz * ny * nx
    b, v, c = feats.shape
    flat = torch.where(ids < limit, ids + torch.arange(b, device=ids.device)[:, None] * limit,
                       b * limit)
    dense = feats.new_zeros((b * limit + 1, c))  # row b * limit takes the unused slots
    dense = dense.index_put((flat.reshape(-1),), feats.reshape(-1, c))
    return dense[:-1].reshape(b, nz, ny, nx, c)
