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

}  // namespace bev
