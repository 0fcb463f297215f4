// What the streaming BEV scatter-max kernels (fused, one-hot) share: a block
// owns a span of consecutive tiles of one sample and one group of channels.
// It searches the sample's sorted pids once, for the span's first row. From
// there the sample's rows stream through a ring of kStages windows of kChunk
// rows in shared memory, fetched with cp.async kStages - 1 windows ahead of
// the one being worked on. Where a window starts does not depend on what an
// earlier window held, so no load waits for another; a tile's end is read
// from the staged pids, and a chunk is what a window holds of one tile.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bev_tile.cuh"

namespace bev {

constexpr int kChunk = 16;           // rows of one window, the most a chunk has
constexpr int kStages = 4;           // windows in the ring
constexpr int kStreamThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most kStages - 2 of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Until none is pending: a block calls it before it ends, so that no copy
// lands in shared memory it no longer owns.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Writes of this thread to shared memory become visible to the asynchronous
// proxy (bulk copies, wgmma operands read from shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The rows of one sample from `row0` on, channels [ch0, ch0 + cw), and the
// ring they are staged in: window w (rows [row0 + w * kChunk, + kChunk)) goes
// to stage w % kStages, its values at val + stage * kChunk * width (row
// stride `width` floats), its pids at pid + stage * kChunk. `vec` says that
// rows may be copied 16 bytes at a time (c, ch0, cw and width multiples of
// 4, f and val aligned).
struct Stream {
  const float* __restrict__ f;
  const int* __restrict__ p;
  float* val;
  int* pid;
  int64_t row0;
  int n, hw, c, ch0, cw, width;
  bool vec;
};

// Every thread of the block calls it. Starts the copy of window w and
// commits it as one cp.async group. Rows at or past n get the padding pid hw
// and no values.
__device__ __forceinline__ void fetch_window(const Stream& s, int w) {
  const int t = threadIdx.x;
  const int64_t r = s.row0 + (int64_t)w * kChunk;
  float* val = s.val + (w % kStages) * kChunk * s.width;
  int* pid = s.pid + (w % kStages) * kChunk;
  if (t < kChunk) {
    if (r + t < s.n) cp_async_4(pid + t, s.p + r + t); else pid[t] = s.hw;
  }
  if (s.vec) {
    const int quads = s.cw >> 2;
    for (int u = t; u < kChunk * quads; u += blockDim.x) {
      const int j = u / quads, q = u - j * quads;
      if (r + j < s.n)
        cp_async_16(val + j * s.width + 4 * q, s.f + (r + j) * s.c + s.ch0 + 4 * q);
    }
  } else {
    for (int e = t; e < kChunk * s.cw; e += blockDim.x) {
      const int j = e / s.cw, ch = e - j * s.cw;
      if (r + j < s.n) cp_async_4(val + j * s.width + ch, s.f + (r + j) * s.c + s.ch0 + ch);
    }
  }
  cp_async_commit();
}

// Every thread of the block calls it, first for windows 0 .. kStages - 2.
__device__ __forceinline__ void start_stream(const Stream& s) {
  for (int w = 0; w < kStages - 1; ++w) fetch_window(s, w);
}

// Every thread of the block calls it, for w = 0, 1, 2, ... in turn. Waits
// until window w has arrived for the whole block; by then every thread is
// done with window w - 1, whose stage takes window w + kStages - 1.
__device__ __forceinline__ void await_window(const Stream& s, int w) {
  cp_async_wait_oldest();
  __syncthreads();
  fetch_window(s, w + kStages - 1);
}

// The window a block works on, and how far it has consumed it.
struct Cursor {
  int w = -1;       // the window
  int j0 = kChunk;  // its first row not yet consumed
  const int* pid = nullptr;
  const float* val = nullptr;
};

// Every thread of the block calls it before each step: once the window is
// consumed, the cursor moves to the start of the next one.
__device__ __forceinline__ void advance(const Stream& s, Cursor& at) {
  if (at.j0 < kChunk) return;
  ++at.w;
  await_window(s, at.w);
  at.pid = s.pid + (at.w % kStages) * kChunk;
  at.val = s.val + (at.w % kStages) * kChunk * s.width;
  at.j0 = 0;
}

// Rows [j0, kChunk) of a staged window that lie below cell_end. The pids are
// sorted, so they are the first rows from j0. Every warp computes it for
// itself.
__device__ __forceinline__ int rows_below(const int* pid, int j0, int cell_end) {
  const int lane = threadIdx.x & 31;
  const bool below = lane >= j0 && lane < kChunk && pid[lane] < cell_end;
  return __popc(__ballot_sync(0xffffffffu, below));
}

// Bit j is set if row j of the chunk [j0, j1) of a staged window is a tail:
// the last row of its pid in the chunk. Every warp computes it for itself.
__device__ __forceinline__ uint32_t tail_mask(const int* pid, int j0, int j1) {
  const int lane = threadIdx.x & 31;
  const bool tail = lane >= j0 && lane < j1 && (lane == j1 - 1 || pid[lane + 1] != pid[lane]);
  return __ballot_sync(0xffffffffu, tail);
}

// Every thread of the block calls it. Zeroes channels [ch0, ch0 + cw) of
// cells [cell_a, cell_b) of the sample's grid o (c channels a cell).
__device__ __forceinline__ void zero_cells(float* __restrict__ o, int64_t cell_a, int64_t cell_b,
                                           int c, int ch0, int cw) {
  if (cw == c) {
    float* dst = o + cell_a * c;
    const int64_t len = (cell_b - cell_a) * c;
    // scalar stores up to a 16-byte boundary, then 16 bytes a thread
    int64_t head = ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
    if (head > len) head = len;
    for (int64_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = 0.0f;
    const int64_t quads = (len - head) >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst + head);
    for (int64_t i = threadIdx.x; i < quads; i += blockDim.x)
      dst4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int64_t i = head + 4 * quads + threadIdx.x; i < len; i += blockDim.x) dst[i] = 0.0f;
  } else {
    const int64_t len = (cell_b - cell_a) * cw;
    for (int64_t i = threadIdx.x; i < len; i += blockDim.x) {
      const int64_t cell = i / cw;
      o[(cell_a + cell) * c + ch0 + (i - cell * cw)] = 0.0f;
    }
  }
}

// Every thread of the block calls it where tile `tile` has taken no row yet.
// If the next row, of pid next_pid, lies past the tile, the tile is empty,
// and so is every tile up to that row's or to tile_end: they are written as
// zeros, `tile` moves past them and the function returns true.
__device__ __forceinline__ bool skip_empty_tiles(const Stream& s, float* __restrict__ o,
                                                 int next_pid, int& tile, int tile_end,
                                                 int tile_cells) {
  const int64_t cell0 = (int64_t)tile * tile_cells;
  if (next_pid < min(cell0 + tile_cells, (int64_t)s.hw)) return false;
  const int next = min(tile_end, max(tile + 1, next_pid / tile_cells));
  zero_cells(o, cell0, min((int64_t)next * tile_cells, (int64_t)s.hw), s.c, s.ch0, s.cw);
  tile = next;
  return true;
}

}  // namespace bev
