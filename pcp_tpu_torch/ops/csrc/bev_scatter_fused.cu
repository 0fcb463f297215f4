// Sorted pillar features -> dense BEV grid, the segmented max inside the
// kernel and one fold per chunk-local tail (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_make_fused_kernel` in
// pcp_tpu/ops/pallas/bev_scatter.py (reached through
// bev_scatter_max_sorted_fused and _bev_scatter_max_fused_impl). Contract:
//   feats (B, N, C) f32, sorted by flat pillar id within each sample, >= 0;
//   pids  (B, N) int32 in [0, H*W], H*W marks padding and is dropped;
//   out   (B, H*W, C) f32, the max per cell, 0 in empty cells.
//
// Design. A block owns a tile of consecutive cells of one sample and finds
// its point range by two binary searches (bev_tile.cuh). It walks the range
// in chunks of `chunk` rows staged in shared memory. Over a chunk it runs
// the segmented running max of bev::sweep_chunk (log2(chunk) steps, two
// buffers taking turns). Then only tail rows fold into the tile by
// read-max-write: a row is a tail if the next row has another pid or if it
// is the chunk's last row, so a segment that crosses chunks gives one
// partial max per chunk. Within a chunk a cell has at most one tail, and a
// barrier separates chunks, so the fold needs no atomic. Pids stay int32 in
// shared memory, so any grid below 2^31 cells is taken.
// The chunk length is the kernel's own; the result does not depend on it.
//
// Bound. Bytes: B*N*(C+1)*4 read, B*H*W*C*4 written; log2(chunk) max
// operations per input element, far below the byte time.
#include "bev_tile.cuh"

namespace {

__global__ void bev_scatter_fused_kernel(const float* __restrict__ feats,
                                         const int* __restrict__ pids,
                                         float* __restrict__ out,
                                         int n, int hw, int c, int tile_cells, int chunk) {
  extern __shared__ float smem[];
  float* tile = smem;                   // tile_cells * c
  float* buf0 = tile + tile_cells * c;  // chunk * c
  float* buf1 = buf0 + chunk * c;       // chunk * c
  int* cid = (int*)(buf1 + chunk * c);  // chunk
  __shared__ int range[2];

  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * tile_cells;
  const int cells = min(tile_cells, hw - cell0);
  const int* __restrict__ p = pids + (int64_t)b * n;
  const float* __restrict__ f = feats + (int64_t)b * n * c;

  bev::find_range(p, n, cell0, cells, range);
  bev::fill_zero(tile, cells * c);
  __syncthreads();

  const int start = range[0], end = range[1];
  for (int c0 = start; c0 < end; c0 += chunk) {
    const int rows = min(chunk, end - c0);
    const float* v = bev::sweep_chunk(f, p, c0, rows, c, cell0, buf0, buf1, cid);
    const int len = rows * c;
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int j = e / c;
      if (j == rows - 1 || cid[j + 1] != cid[j]) {
        const int idx = cid[j] * c + (e - j * c);
        tile[idx] = fmaxf(tile[idx], v[e]);
      }
    }
    __syncthreads();
  }

  bev::write_tile(out + ((int64_t)b * hw + cell0) * c, tile, cells, c, c);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// the first CUDA error (0 on success); it does not synchronise.
extern "C" int bev_scatter_fused_launch(const float* feats, const int* pids, float* out,
                                        int b, int n, int hw, int c, int tile_cells,
                                        int chunk, void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  const dim3 grid((hw + tile_cells - 1) / tile_cells, b);
  const size_t smem = ((size_t)tile_cells * c + 2 * (size_t)chunk * c) * sizeof(float)
                      + (size_t)chunk * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bev_scatter_fused_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bev_scatter_fused_kernel<<<grid, bev::kThreads, smem, (cudaStream_t)stream>>>(
      feats, pids, out, n, hw, c, tile_cells, chunk);
  return (int)cudaGetLastError();
}
