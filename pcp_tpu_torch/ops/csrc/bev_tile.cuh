// What the BEV scatter-max variants share: a block owns a tile of consecutive
// flat cells of one sample, finds its own point range in the sample's sorted
// pids, builds the tile in shared memory and writes it out whole, once.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bev {

constexpr int kThreads = 256;

// First index in p[0, n) whose value is >= key (p is sorted ascending).
__device__ __forceinline__ int lower_bound(const int* __restrict__ p, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (p[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Threads 0 and 1 search the tile's point range [range[0], range[1]); the
// caller reads it after its next __syncthreads(). Padding rows (pid == H*W)
// lie past every tile's upper bound.
__device__ __forceinline__ void find_range(const int* __restrict__ p, int n, int cell0,
                                           int cells, int* range) {
  if (threadIdx.x == 0) range[0] = lower_bound(p, n, cell0);
  if (threadIdx.x == 1) range[1] = lower_bound(p, n, cell0 + cells);
}

__device__ __forceinline__ void fill_zero(float* tile, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) tile[i] = 0.0f;
}

// Coalesced write of `cells` rows of c channels from a tile whose rows are
// `stride` floats apart.
__device__ __forceinline__ void write_tile(float* __restrict__ o, const float* tile,
                                           int cells, int c, int stride) {
  const int len = cells * c;
  if (stride == c) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) o[i] = tile[i];
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int cell = i / c;
      o[i] = tile[cell * stride + (i - cell * c)];
    }
  }
}

// Segmented running max over one chunk of a tile's point range. Every thread
// of the block calls it. Rows [c0, c0 + rows) of the sample (features f, c
// channels; sorted pids p) are staged into buf0 and their cells (pid - cell0)
// into cid; then log2(rows) sweep steps leave in every row the max over the
// rows of its own cell at or before it in the chunk, so the last row of each
// cell's run holds the run's max. A step reads what the step before wrote,
// so the two buffers take turns with a barrier between steps. Returns the
// buffer that holds the result; the block is synchronised on return.
__device__ __forceinline__ float* sweep_chunk(const float* __restrict__ f,
                                              const int* __restrict__ p, int c0, int rows,
                                              int c, int cell0, float* buf0, float* buf1,
                                              int* cid) {
  const int len = rows * c;
  const float* __restrict__ src_rows = f + (int64_t)c0 * c;
  for (int j = threadIdx.x; j < rows; j += blockDim.x) cid[j] = p[c0 + j] - cell0;
  for (int e = threadIdx.x; e < len; e += blockDim.x) buf0[e] = src_rows[e];
  __syncthreads();
  float* src = buf0;
  float* dst = buf1;
  for (int d = 1; d < rows; d <<= 1) {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int j = e / c;
      float v = src[e];
      if (j >= d && cid[j - d] == cid[j]) v = fmaxf(v, src[e - d * c]);
      dst[e] = v;
    }
    __syncthreads();
    float* tmp = src; src = dst; dst = tmp;
  }
  return src;
}

}  // namespace bev
