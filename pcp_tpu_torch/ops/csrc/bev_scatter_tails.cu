// Pre-reduced pillar features -> dense BEV grid, one store per segment tail
// (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_make_tails_kernel` in
// pcp_tpu/ops/pallas/bev_scatter.py (reached through
// bev_scatter_max_sorted_prereduced and _bev_scatter_max_tails_impl). Contract:
//   feats (B, N, C) f32, sorted by flat pillar id within each sample; every
//         row already holds its whole segment's max (the caller's segmented
//         max), so only one row of a segment has to be stored;
//   pids  (B, N) int32 in [0, H*W], H*W marks padding and is dropped;
//   tails (B, N) int32, non-zero on the last row of each segment;
//   out   (B, H*W, C) f32, the max per cell, 0 in empty cells.
//
// Design. As in bev_scatter_max.cu a block owns a tile of consecutive cells
// of one sample, finds its point range by two binary searches, zeroes the
// tile in shared memory and writes it out whole, so the caller allocates with
// torch.empty. One tail per segment means one writer per cell: the walk, one
// thread per (row, channel), is a plain predicated store with no atomic.
//
// Bound. Bytes: B*N*(C+2)*4 read, B*H*W*C*4 written; no arithmetic.
#include "bev_tile.cuh"

namespace {

__global__ void bev_scatter_tails_kernel(const float* __restrict__ feats,
                                         const int* __restrict__ pids,
                                         const int* __restrict__ tails,
                                         float* __restrict__ out,
                                         int n, int hw, int c, int tile_cells) {
  extern __shared__ float tile[];  // tile_cells * c
  __shared__ int range[2];

  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * tile_cells;
  const int cells = min(tile_cells, hw - cell0);
  const int* __restrict__ p = pids + (int64_t)b * n;
  const int* __restrict__ t = tails + (int64_t)b * n;

  bev::find_range(p, n, cell0, cells, range);
  bev::fill_zero(tile, cells * c);
  __syncthreads();

  const int64_t e_end = (int64_t)range[1] * c;
  const float* __restrict__ f = feats + (int64_t)b * n * c;
  for (int64_t e = (int64_t)range[0] * c + threadIdx.x; e < e_end; e += blockDim.x) {
    const int64_t i = e / c;
    if (t[i] != 0) {
      const int ch = (int)(e - i * c);
      tile[(p[i] - cell0) * c + ch] = f[e];
    }
  }
  __syncthreads();

  bev::write_tile(out + ((int64_t)b * hw + cell0) * c, tile, cells, c, c);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int bev_scatter_tails_launch(const float* feats, const int* pids, const int* tails,
                                        float* out, int b, int n, int hw, int c,
                                        int tile_cells, void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  const dim3 grid((hw + tile_cells - 1) / tile_cells, b);
  const size_t smem = (size_t)tile_cells * c * sizeof(float);
  bev_scatter_tails_kernel<<<grid, bev::kThreads, smem, (cudaStream_t)stream>>>(
      feats, pids, tails, out, n, hw, c, tile_cells);
  return (int)cudaGetLastError();
}
