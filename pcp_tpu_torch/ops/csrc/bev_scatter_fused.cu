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
// Bound. Bytes: B*N*(C+1)*4 read, B*H*W*C*4 written; one max per input
// element, far below the byte time. A kernel of this shape with one block a
// tile is held back on this card not by the bytes but by the chain of
// dependent steps a block runs before its tile leaves: two binary searches
// in device memory, a zero fill, a staged load, sweep steps with a
// block-wide barrier each, and a write that nothing overlaps. This design
// takes the chain apart (below). What is left is the memory system: at the
// main path's shapes the kernel moves its bytes at about three quarters of
// the card's rate, and its time no longer moves with the tile size, the
// windows in flight or the blocks an SM holds (PERF.md, section 6).
//
// Design, against that chain.
//   * A block owns a span of `span_tiles` consecutive tiles of one sample
//     (and one group of at most `gw` channels) and searches the sorted pids
//     once, for the span's first row. From there the rows stream in order
//     through a ring of windows of kChunk rows (bev_stream.cuh), fetched by
//     cp.async three windows ahead of the one being swept. A window's start
//     does not depend on what the window before held, so no load waits for
//     another. A tile's end is read from the staged pids; a chunk is what a
//     window holds of one tile.
//   * The sweep has no barrier. A thread owns one channel, or the cells
//     h, h + nh, ... of one where the block has nh threads a channel, and
//     runs the segmented running max down the chunk's rows in a register;
//     where a row is a tail (the next row has another pid, or it is the
//     chunk's last) the cell's thread folds the value into the tile by
//     read-max-write. An entry of the tile is only ever touched by its
//     thread, which also zeroes it, so the fold needs no atomic and no
//     barrier between chunks. A segment that crosses chunks gives one
//     partial max per chunk.
//   * Tiles are built in a ring of two shared-memory buffers. A finished
//     tile leaves by one asynchronous bulk copy (cp.async.bulk, shared to
//     global) while the block builds the next tile in the other buffer.
//     Runs of empty tiles are written as zeros straight to device memory.
//     Every cell is written exactly once, so the caller allocates with
//     torch.empty.
//   * A block takes one barrier a window, when it has arrived, and one a
//     tile, before the tile's copy starts.
// Where the grid has more channels than `gw`, blockIdx.z picks the group and
// a tile's rows are no longer one run of bytes: it is then written by the
// threads (as it is where addresses are not multiples of 16 bytes).
// Pids stay int32, so any grid below 2^31 cells is taken. The chunk length
// is the kernel's own; the result does not depend on it.
#include "bev_stream.cuh"

namespace {

using bev::kChunk;

__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(bev::smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the bulk copies this thread started have read their source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(bev::kStreamThreads)
bev_scatter_fused_kernel(const float* __restrict__ feats, const int* __restrict__ pids,
                         float* __restrict__ out, int n, int hw, int c, int tile_cells,
                         int span_tiles, int gw, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // gw is a multiple of 4 wherever vec is set, so every region starts on a
  // 16-byte boundary
  float* ring = reinterpret_cast<float*>(smem_raw);       // 2 tiles of tile_cells * gw
  float* stage_val = ring + 2 * tile_cells * gw;          // kStages windows of kChunk * gw
  int* stage_pid = reinterpret_cast<int*>(stage_val + bev::kStages * kChunk * gw);
  __shared__ int first_row;

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * gw;
  const int cw = min(gw, c - ch0);
  const int tiles = (hw + tile_cells - 1) / tile_cells;
  int tile = blockIdx.x * span_tiles;
  const int tile_end = min(tiles, tile + span_tiles);
  float* __restrict__ o = out + (int64_t)b * hw * c;

  if (t == 0) first_row = bev::lower_bound(pids + (int64_t)b * n, n, tile * tile_cells);
  // nh threads share a channel: thread (ch, h) owns the cells h, h + nh, ...
  // of channel ch in both tile buffers, and nobody else touches them
  int nh = 1;  // a power of two
  while (2 * nh * cw <= (int)blockDim.x) nh *= 2;
  const int ch = t % cw, h = t / cw;
  if (h < nh)
    for (int cell = h; cell < tile_cells; cell += nh) ring[cell * cw + ch] = 0.0f;
  __syncthreads();
  const bev::Stream stream = {feats + (int64_t)b * n * c, pids + (int64_t)b * n, stage_val,
                              stage_pid, first_row, n, hw, c, ch0, cw, cw, vec != 0};
  bev::start_stream(stream);

  bev::Cursor at;
  float* cur = ring;   // the buffer the current tile is built in
  float* other = ring + tile_cells * gw;
  bool dirty = false;  // the current tile has taken rows

  while (tile < tile_end) {
    bev::advance(stream, at);
    const int* spid = at.pid;
    const float* sval = at.val;
    const int j0 = at.j0;
    if (!dirty && bev::skip_empty_tiles(stream, o, spid[j0], tile, tile_end, tile_cells)) continue;
    const int cell0 = tile * tile_cells;
    const int cell_end = (int)min((int64_t)cell0 + tile_cells, (int64_t)hw);
    const int j1 = j0 + bev::rows_below(spid, j0, cell_end);
    if (j1 > j0) {
      // the chunk: rows [j0, j1) of the window. Every thread runs the
      // segmented max down its channel and folds the tails of its own cells.
      const uint32_t tails = bev::tail_mask(spid, j0, j1);
      if (h < nh) {
        float run = 0.0f;
        int prev = -1;
        for (int j = j0; j < j1; ++j) {
          const int pid = spid[j];
          const float v = sval[j * cw + ch];
          run = pid == prev ? fmaxf(run, v) : v;
          prev = pid;
          if ((tails >> j & 1) && ((pid - cell0) & (nh - 1)) == h) {
            float* cell = cur + (pid - cell0) * cw + ch;
            *cell = fmaxf(*cell, run);
          }
        }
      }
      dirty = true;
      at.j0 = j1;
      if (j1 == kChunk) continue;  // the tile may go on in the next window
    }

    // the tile is complete: it leaves, and the next one starts in the other buffer
    const int cells = cell_end - cell0;
    float* dst = o + (int64_t)cell0 * c + ch0;
    const uint32_t bytes = (uint32_t)cells * cw * 4;
    const bool bulk = cw == c && ((reinterpret_cast<uintptr_t>(dst) | bytes
                                   | bev::smem_addr(cur)) & 15) == 0;
    if (t == 0) bulk_wait_read();  // a bulk copy out of the other buffer has read it
    if (bulk) {
      bev::fence_proxy_async();
      __syncthreads();
      if (t == 0) bulk_store(dst, cur, bytes);
    } else {
      __syncthreads();
      for (int i = t; i < cells * cw; i += blockDim.x) {
        const int cell = i / cw;
        dst[(int64_t)cell * c + (i - cell * cw)] = cur[i];
      }
    }
    // The other buffer was copied out a tile ago (by the bulk copy waited for
    // above, or by the threads before the barrier above), or never used.
    // Each thread zeroes its own cells, so the next tile's folds need no
    // barrier after it.
    if (h < nh)
      for (int cell = h; cell < tile_cells; cell += nh) other[cell * cw + ch] = 0.0f;
    float* tmp = cur; cur = other; other = tmp;
    dirty = false;
    ++tile;
  }
  bev::cp_async_wait_all();
  if (t == 0) bulk_wait_read();  // shared memory outlives the copies that read it
}

}  // namespace

static size_t fused_smem(int tile_cells, int gw) {
  return ((size_t)2 * tile_cells * gw + (size_t)bev::kStages * kChunk * gw) * sizeof(float)
         + (size_t)bev::kStages * kChunk * sizeof(int);
}

// Resources of the kernel as built, for the build report: registers a thread,
// static shared memory, local (spill) bytes a thread, dynamic shared memory
// at these sizes, resident blocks an SM. Returns the first CUDA error.
extern "C" int bev_scatter_fused_resources(int tile_cells, int gw, int* out5) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bev_scatter_fused_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fused_smem(tile_cells, gw);
  if (smem > 48 * 1024) {  // never lowered: a launch below 48 KB does not set it
    err = cudaFuncSetAttribute(bev_scatter_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bev_scatter_fused_kernel,
                                                      bev::kStreamThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out5[0] = attr.numRegs;
  out5[1] = (int)attr.sharedSizeBytes;
  out5[2] = (int)attr.localSizeBytes;
  out5[3] = (int)smem;
  out5[4] = blocks;
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes. `gw` is the width of a channel
// group (at most 128, the block's threads). Launches on `stream` and returns
// the first CUDA error (0 on success); it does not synchronise.
extern "C" int bev_scatter_fused_launch(const float* feats, const int* pids, float* out,
                                        int b, int n, int hw, int c, int tile_cells,
                                        int span_tiles, int gw, void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  if (tile_cells <= 0 || span_tiles <= 0 || gw <= 0 || gw > bev::kStreamThreads)
    return (int)cudaErrorInvalidValue;
  const int tiles = (hw + tile_cells - 1) / tile_cells;
  const dim3 grid((tiles + span_tiles - 1) / span_tiles, b, (c + gw - 1) / gw);
  const size_t smem = fused_smem(tile_cells, gw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bev_scatter_fused_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = c % 4 == 0 && gw % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  bev_scatter_fused_kernel<<<grid, bev::kStreamThreads, smem, (cudaStream_t)stream>>>(
      feats, pids, out, n, hw, c, tile_cells, span_tiles, gw, vec);
  return (int)cudaGetLastError();
}
