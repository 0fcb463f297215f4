// Sorted pillar features -> dense BEV grid, each run's max kept in a
// register and stored once (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_make_runs_kernel` in
// pcp_tpu/ops/pallas/bev_scatter.py (reached through
// _bev_scatter_max_runs_impl). Contract:
//   feats (B, N, C) f32, sorted by flat pillar id within each sample, >= 0;
//   pids  (B, N) int32 in [0, H*W], H*W marks padding and is dropped;
//   out   (B, H*W, C) f32, the max per cell, 0 in empty cells.
//
// Design. The sort makes each pillar's points one contiguous run. A block
// owns a tile of consecutive cells of one sample and finds its point range
// by two binary searches (bev_tile.cuh). Its threads form groups of
// min(C, 256) channel lanes; the range is cut into one part per group, and
// every cut is moved forward to the next run start (one more binary search),
// so a run belongs to exactly one group. A thread walks its part for its
// channel with the current run's max in a register and stores it into the
// zeroed shared-memory tile when the pid changes: one plain store per run,
// no read-modify-write per point. The part's last run is flushed with a max,
// as the TPU kernel flushes its last run.
//
// Bound. Bytes: B*N*(C+1)*4 read, B*H*W*C*4 written; one max per input
// element, far below the byte time.
#include "bev_tile.cuh"

namespace {

// The first run start at or after x in [start, end).
__device__ __forceinline__ int run_start(const int* __restrict__ p, int n, int start, int end,
                                         int x) {
  if (x <= start) return start;
  if (x >= end) return end;
  if (p[x] != p[x - 1]) return x;
  return min(end, bev::lower_bound(p, n, p[x] + 1));
}

__global__ void bev_scatter_runs_kernel(const float* __restrict__ feats,
                                        const int* __restrict__ pids,
                                        float* __restrict__ out,
                                        int n, int hw, int c, int tile_cells) {
  extern __shared__ float tile[];  // tile_cells * c
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
  const int lanes = min(c, (int)blockDim.x);
  const int groups = blockDim.x / lanes;
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x - g * lanes;
  if (g < groups && start < end) {
    const int64_t len = end - start;
    const int lo = run_start(p, n, start, end, start + (int)(len * g / groups));
    const int hi = run_start(p, n, start, end, start + (int)(len * (g + 1) / groups));
    for (int ch = lane; ch < c; ch += lanes) {
      int cur = -1;
      float acc = 0.0f;
      for (int i = lo; i < hi; ++i) {
        const int cell = p[i] - cell0;
        const float v = f[(int64_t)i * c + ch];
        if (cell != cur) {
          if (cur >= 0) tile[cur * c + ch] = acc;  // the finished run's only store
          cur = cell;
          acc = v;
        } else {
          acc = fmaxf(acc, v);
        }
      }
      if (cur >= 0) tile[cur * c + ch] = fmaxf(tile[cur * c + ch], acc);
    }
  }
  __syncthreads();

  bev::write_tile(out + ((int64_t)b * hw + cell0) * c, tile, cells, c, c);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int bev_scatter_runs_launch(const float* feats, const int* pids, float* out,
                                       int b, int n, int hw, int c, int tile_cells,
                                       void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  const dim3 grid((hw + tile_cells - 1) / tile_cells, b);
  const size_t smem = (size_t)tile_cells * c * sizeof(float);
  bev_scatter_runs_kernel<<<grid, bev::kThreads, smem, (cudaStream_t)stream>>>(
      feats, pids, out, n, hw, c, tile_cells);
  return (int)cudaGetLastError();
}
