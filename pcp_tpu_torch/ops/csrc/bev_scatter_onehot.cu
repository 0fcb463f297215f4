// Sorted pillar features -> dense BEV grid, placement as a one-hot matrix
// product on the tensor cores (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_make_onehot_kernel` in
// pcp_tpu/ops/pallas/bev_scatter.py (reached through
// bev_scatter_max_sorted_onehot and _bev_scatter_max_onehot_impl). Contract:
//   feats (B, N, C) f32, sorted by flat pillar id within each sample, >= 0;
//   pids  (B, N) int32 in [0, H*W], H*W marks padding and is dropped;
//   out   (B, H*W, C) f32, the max per cell to 2^-23 relative (exact for
//         normal floats: the three bf16 parts hold all 24 mantissa bits),
//         0 in empty cells.
//
// Design. A block owns a tile of `tile_cells` (a multiple of 16) consecutive
// cells of one sample and finds its point range by two binary searches
// (bev_tile.cuh). It walks the range in chunks of `chunk` (a multiple of 16)
// rows. Per chunk:
//   1. bev::sweep_chunk leaves each cell's chunk-local max in the last row
//      of its run (the tail; the chunk's last row is a tail too);
//   2. tail rows are split into three bf16 parts, hi = bf16(v),
//      mid = bf16(v - hi), lo = bf16(v - hi - mid), laid side by side as a
//      (chunk x 3*Cp) matrix; other rows are 0. Cp is C rounded up to 16;
//   3. a (tile_cells x chunk) one-hot matrix holds 1 where row j is the tail
//      of cell i: at most one 1 per row and per column;
//   4. warps multiply one-hot @ [hi|mid|lo] with nvcuda::wmma 16x16x16 bf16
//      fragments and f32 accumulators. A product of 1 and a bf16 value and a
//      sum of zeros are exact, so each accumulator holds one part. The
//      three accumulators are added as (hi + mid) + lo and max-ed into the
//      tile's fragment in shared memory. A warp owns its (16 cells x 16
//      channels) fragments, so no two warps touch the same tile entry.
// Segments that cross chunks give one partial max per chunk, combined by the
// max. Pids stay int32, so any grid below 2^31 cells is taken.
//
// Bound. Bytes: B*N*(C+1)*4 read, B*H*W*C*4 written. The product does
// 2 * tile_cells * 3*Cp operations per staged row on the tensor cores (bf16
// rate), which at the main path's shapes is below the byte time.
#include <cuda_bf16.h>
#include <mma.h>

#include "bev_tile.cuh"

namespace {

using namespace nvcuda;

__global__ void bev_scatter_onehot_kernel(const float* __restrict__ feats,
                                          const int* __restrict__ pids,
                                          float* __restrict__ out,
                                          int n, int hw, int c, int cp, int tile_cells,
                                          int chunk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // every region's size is a multiple of 32 bytes but the last three, which
  // wmma does not read
  float* tile = reinterpret_cast<float*>(smem_raw);                        // tile_cells * cp
  __nv_bfloat16* parts = reinterpret_cast<__nv_bfloat16*>(tile + tile_cells * cp);  // chunk * 3cp
  __nv_bfloat16* onehot = parts + chunk * 3 * cp;                          // tile_cells * chunk
  float* buf0 = reinterpret_cast<float*>(onehot + tile_cells * chunk);     // chunk * c
  float* buf1 = buf0 + chunk * c;                                          // chunk * c
  int* cid = reinterpret_cast<int*>(buf1 + chunk * c);                     // chunk
  int* loc = cid + chunk;                                                  // chunk
  __shared__ int range[2];

  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * tile_cells;
  const int cells = min(tile_cells, hw - cell0);
  const int* __restrict__ p = pids + (int64_t)b * n;
  const float* __restrict__ f = feats + (int64_t)b * n * c;

  bev::find_range(p, n, cell0, cells, range);
  bev::fill_zero(tile, tile_cells * cp);
  __syncthreads();

  const int start = range[0], end = range[1];
  const int warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const int m_tiles = tile_cells / 16, n_tiles = cp / 16;
  const int ld_parts = 3 * cp;

  for (int c0 = start; c0 < end; c0 += chunk) {
    const int rows = min(chunk, end - c0);
    const float* v = bev::sweep_chunk(f, p, c0, rows, c, cell0, buf0, buf1, cid);

    // the tail's cell for tail rows, -1 for every other row of the chunk
    for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
      const bool tail = j < rows && (j == rows - 1 || cid[j + 1] != cid[j]);
      loc[j] = tail ? cid[j] : -1;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < chunk * cp; e += blockDim.x) {
      const int j = e / cp;
      const int ch = e - j * cp;
      const float val = (loc[j] >= 0 && ch < c) ? v[j * c + ch] : 0.0f;
      const __nv_bfloat16 hi = __float2bfloat16_rn(val);
      const float r1 = val - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
      __nv_bfloat16* row = parts + j * ld_parts + ch;
      row[0] = hi;
      row[cp] = mid;
      row[2 * cp] = lo;
    }
    for (int e = threadIdx.x; e < tile_cells * chunk; e += blockDim.x) {
      const int cell = e / chunk;
      const int j = e - cell * chunk;
      onehot[e] = __float2bfloat16_rn(loc[j] == cell ? 1.0f : 0.0f);
    }
    __syncthreads();

    const int k_steps = (rows + 15) / 16;
    for (int pair = warp; pair < m_tiles * n_tiles; pair += num_warps) {
      const int mt = pair / n_tiles;
      const int nt = pair - mt * n_tiles;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_hi, acc_mid, acc_lo, cur;
      wmma::fill_fragment(acc_hi, 0.0f);
      wmma::fill_fragment(acc_mid, 0.0f);
      wmma::fill_fragment(acc_lo, 0.0f);
      for (int k = 0; k < k_steps; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b_hi, b_mid, b_lo;
        wmma::load_matrix_sync(a, onehot + mt * 16 * chunk + k * 16, chunk);
        const __nv_bfloat16* bk = parts + k * 16 * ld_parts + nt * 16;
        wmma::load_matrix_sync(b_hi, bk, ld_parts);
        wmma::load_matrix_sync(b_mid, bk + cp, ld_parts);
        wmma::load_matrix_sync(b_lo, bk + 2 * cp, ld_parts);
        wmma::mma_sync(acc_hi, a, b_hi, acc_hi);
        wmma::mma_sync(acc_mid, a, b_mid, acc_mid);
        wmma::mma_sync(acc_lo, a, b_lo, acc_lo);
      }
      float* t = tile + mt * 16 * cp + nt * 16;
      wmma::load_matrix_sync(cur, t, cp, wmma::mem_row_major);
      for (int i = 0; i < cur.num_elements; ++i)
        cur.x[i] = fmaxf(cur.x[i], (acc_hi.x[i] + acc_mid.x[i]) + acc_lo.x[i]);
      wmma::store_matrix_sync(t, cur, cp, wmma::mem_row_major);
    }
    __syncthreads();
  }

  bev::write_tile(out + ((int64_t)b * hw + cell0) * c, tile, cells, c, cp);
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_cells` and `chunk` are
// multiples of 16. Launches on `stream` and returns the first CUDA error
// (0 on success); it does not synchronise.
extern "C" int bev_scatter_onehot_launch(const float* feats, const int* pids, float* out,
                                         int b, int n, int hw, int c, int tile_cells,
                                         int chunk, void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  if (tile_cells <= 0 || chunk <= 0 || tile_cells % 16 || chunk % 16)
    return (int)cudaErrorInvalidValue;
  const int cp = (c + 15) / 16 * 16;
  const dim3 grid((hw + tile_cells - 1) / tile_cells, b);
  const size_t smem = (size_t)tile_cells * cp * sizeof(float)
                      + ((size_t)chunk * 3 * cp + (size_t)tile_cells * chunk) * sizeof(__nv_bfloat16)
                      + 2 * (size_t)chunk * c * sizeof(float) + 2 * (size_t)chunk * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bev_scatter_onehot_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bev_scatter_onehot_kernel<<<grid, bev::kThreads, smem, (cudaStream_t)stream>>>(
      feats, pids, out, n, hw, c, cp, tile_cells, chunk);
  return (int)cudaGetLastError();
}
