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
// Bound. Bytes: B*N*(C+1)*4 read, B*H*W*C*4 written. The product does
// 2 * 64 * 16 * 3*CB operations per chunk on the tensor cores (bf16 rate), a
// few percent of the byte time at the main path's shapes. A kernel of this
// shape with one block a tile is held back on this card by neither: it is
// the chain of dependent steps a block runs before its tile leaves (searches
// in device memory, a dozen barriers a chunk, operands, one-hot matrix and
// sums passing through shared memory). This design takes the chain apart
// (below). What is left is the memory system, as for the fused kernel, and
// the barrier and the two rounds of products a chunk still costs, which 5
// blocks an SM overlap with each other's stores (PERF.md, section 6).
//
// Design, against that chain. The tile is 64 cells, the M of one warpgroup
// matrix instruction, and the block is one warpgroup.
//   * A block owns a span of `span_tiles` consecutive tiles of one sample
//     (and one group of CB channels) and searches the sorted pids once, for
//     the span's first row. From there the rows stream in order through a
//     ring of windows of 16 rows (bev_stream.cuh), fetched by cp.async three
//     windows ahead of the one being worked on. A window's start does not
//     depend on what the window before held, so no load waits for another.
//     A tile's end is read from the staged pids; a chunk is what a window
//     holds of one tile.
//   * The sweep has no barrier: a thread owns one channel and 8 of the 16
//     rows, and runs the segmented running max down the chunk's rows in a
//     register. Where a row is a tail (the next row has another pid, or it
//     is the chunk's last) the value is split into three bf16 parts,
//     hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); other rows
//     give 0. The thread packs its 8 rows of each part and stores them as
//     one 16-byte row of the B operand [hi|mid|lo] (16 x 3*CB) in shared
//     memory, K-major in 8x8 core matrices, the layout wgmma reads without
//     a swizzle. Two operands take turns, so a chunk costs one barrier.
//   * The one-hot matrix (64 cells x 16 rows, 1 where row j is the tail of
//     cell i) never exists in memory: every thread computes its own part of
//     the A fragment from the staged pids, in registers.
//   * One wgmma m64n32k16 per part and 32 channels, A from registers, B from
//     shared memory, f32 sums in registers. A product of 1 and a bf16 value
//     and a sum of zeros are exact, so each sum holds one part;
//     (hi + mid) + lo and the max into the running tile are elementwise on
//     registers. (With m64n64k16 the three sums and the tile take about 150
//     registers a thread and an SM holds 3 blocks; in slices of 32 channels
//     it is under 100 registers and 5 blocks, and the kernel is a tenth
//     faster, though a chunk of 64 channels then waits for two rounds of
//     products.) The tile lives in registers over all its chunks and leaves
//     once, straight from the registers to device memory in 8-byte stores
//     (a quad of lanes fills a 32-byte sector), which nothing waits for.
//   * A block takes one barrier a window, when it has arrived, and one a
//     chunk, between the B operand's stores and the product. Runs of empty
//     tiles are written as zeros. Every cell is written exactly once, so the
//     caller allocates with torch.empty.
// CB is 32 or 64, fixed at compile time with the tile's registers; wider
// grids go over blockIdx.z in groups of 64 channels, narrower ones mask the
// unused columns. Pids stay int32, so any grid below 2^31 cells is taken.
#include <cuda_bf16.h>

#include "bev_stream.cuh"

namespace {

using bev::kChunk;

constexpr int kTileCells = 64;  // the M of wgmma
constexpr int kN = 32;          // the N of one wgmma

// Shared-memory matrix descriptor without swizzle: 8x8 bf16 core matrices of
// 128 contiguous bytes; `lbo` bytes between core matrices along K, `sbo`
// bytes between core matrices along N.
__device__ __forceinline__ uint64_t matrix_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = bev::smem_addr(ptr);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = a @ b: a (64 x 16 bf16) from registers, b (16 x N bf16, K-major) from
// shared memory, d (64 x N f32) overwritten (scale-d 0). The sums are tied
// to their registers as read-write operands: the instruction writes them
// after it returns, and the compiler must not move them meanwhile.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// The compiler may not move uses of these registers across this point.
template <int LEN>
__device__ __forceinline__ void pin(float (&d)[LEN]) {
#pragma unroll
  for (int i = 0; i < LEN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16 1.0 in the half of a register that holds column j of the A fragment,
// if row j of the chunk is the tail of `cell`.
__device__ __forceinline__ uint32_t onehot_pair(int tail_even, int tail_odd, int cell) {
  return (tail_even == cell ? 0x3F80u : 0u) | (tail_odd == cell ? 0x3F800000u : 0u);
}

template <int CB>
__global__ void __launch_bounds__(bev::kStreamThreads, 5)
bev_scatter_onehot_kernel(const float* __restrict__ feats, const int* __restrict__ pids,
                          float* __restrict__ out, int n, int hw, int c, int span_tiles,
                          int vec) {
  // B operand, two of them taking turns: part p, channel ch is column
  // n = p * CB + ch; column n, row k (k = the window's row) lies at core
  // matrix (n / 8, k / 8), row n % 8, element k % 8.
  constexpr uint32_t kLbo = 128, kSbo = 256, kPartBytes = CB / 8 * kSbo;
  __shared__ __align__(128) unsigned char operand_b[2][3 * kPartBytes];
  __shared__ __align__(16) float stage_val[bev::kStages * kChunk * CB];
  __shared__ int stage_pid[bev::kStages * kChunk];
  __shared__ int first_row;

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * CB;
  const int cw = min(CB, c - ch0);
  const int tiles = (hw + kTileCells - 1) / kTileCells;
  int tile = blockIdx.x * span_tiles;
  const int tile_end = min(tiles, tile + span_tiles);
  float* __restrict__ o = out + (int64_t)b * hw * c;

  // this thread's place in the fragments: rows (cells) row0 and row0 + 8 of
  // the tile; columns 2 * quad + {0, 1} of every group of 8
  const int lane = t & 31;
  const int row0 = 16 * (t >> 5) + (lane >> 2);
  const int quad = lane & 3;
  // and in the sweep: channel ch, rows [8 * half, 8 * half + 8) of the operand
  const int ch = t % CB, half = t / CB;

  float acc[CB / 2];  // the running tile: acc[i] is cell row0 + 8 * ((i / 2) % 2),
                      // channel 8 * (i / 4) + 2 * quad + i % 2
#pragma unroll
  for (int i = 0; i < CB / 2; ++i) acc[i] = 0.0f;

  if (t == 0) first_row = bev::lower_bound(pids + (int64_t)b * n, n, tile * kTileCells);
  __syncthreads();
  const bev::Stream stream = {feats + (int64_t)b * n * c, pids + (int64_t)b * n, stage_val,
                              stage_pid, first_row, n, hw, c, ch0, cw, CB, vec != 0};
  bev::start_stream(stream);

  bev::Cursor at;
  int turn = 0;        // which B operand the next product takes
  bool dirty = false;  // the current tile has taken rows

  while (tile < tile_end) {
    bev::advance(stream, at);
    const int* spid = at.pid;
    const float* sval = at.val;
    const int j0 = at.j0;
    if (!dirty && bev::skip_empty_tiles(stream, o, spid[j0], tile, tile_end, kTileCells)) continue;
    const int cell0 = tile * kTileCells;
    const int cell_end = (int)min((int64_t)cell0 + kTileCells, (int64_t)hw);
    const int j1 = j0 + bev::rows_below(spid, j0, cell_end);
    if (j1 > j0) {
      // the chunk: rows [j0, j1) of the window
      const uint32_t tails = bev::tail_mask(spid, j0, j1);
      unsigned char* operand = operand_b[turn];
      if (half < 2) {
        // Segmented running max down this thread's channel; it splits the
        // tails among its 8 rows of the operand three ways (other rows stay 0).
        uint32_t part[3][4] = {};
        float run = 0.0f;
        int prev = -1;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j >= j0 && j < j1 && j < 8 * half + 8) {
            const int pid = spid[j];
            const float v = ch < cw ? sval[j * CB + ch] : 0.0f;
            run = pid == prev ? fmaxf(run, v) : v;
            prev = pid;
            if ((tails >> j & 1) && j / 8 == half) {
              const __nv_bfloat16 hi = __float2bfloat16_rn(run);
              const float r1 = run - __bfloat162float(hi);
              const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
              const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
              const int shift = 16 * (j % 2);
              part[0][j % 8 / 2] |= (uint32_t)__bfloat16_as_ushort(hi) << shift;
              part[1][j % 8 / 2] |= (uint32_t)__bfloat16_as_ushort(mid) << shift;
              part[2][j % 8 / 2] |= (uint32_t)__bfloat16_as_ushort(lo) << shift;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 3; ++q)
          *reinterpret_cast<uint4*>(operand + q * kPartBytes + (ch / 8) * kSbo + half * kLbo
                                    + (ch % 8) * 16) =
              make_uint4(part[q][0], part[q][1], part[q][2], part[q][3]);
      }

      // this thread's part of the one-hot A fragment, from the staged pids
      uint32_t a[4];
      {
        const int t0 = (tails >> (2 * quad) & 1) ? spid[2 * quad] - cell0 : -1;
        const int t1 = (tails >> (2 * quad + 1) & 1) ? spid[2 * quad + 1] - cell0 : -1;
        const int t8 = (tails >> (2 * quad + 8) & 1) ? spid[2 * quad + 8] - cell0 : -1;
        const int t9 = (tails >> (2 * quad + 9) & 1) ? spid[2 * quad + 9] - cell0 : -1;
        a[0] = onehot_pair(t0, t1, row0);
        a[1] = onehot_pair(t0, t1, row0 + 8);
        a[2] = onehot_pair(t8, t9, row0);
        a[3] = onehot_pair(t8, t9, row0 + 8);
      }

      bev::fence_proxy_async();
      // The B operand is whole. Every warp has also finished the product
      // before the last, which read the operand the next chunk will write.
      __syncthreads();

      // kN channels at a time
#pragma unroll
      for (int slice = 0; slice < CB / kN; ++slice) {
        const unsigned char* b_hi = operand + slice * (kN / 8) * kSbo;
        float hi[kN / 2], mid[kN / 2], lo[kN / 2];
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) hi[i] = mid[i] = lo[i] = 0.0f;
        pin(hi); pin(mid); pin(lo);
        wgmma_fence();
        wgmma_n32(hi, a, matrix_desc(b_hi, kLbo, kSbo));
        wgmma_n32(mid, a, matrix_desc(b_hi + kPartBytes, kLbo, kSbo));
        wgmma_n32(lo, a, matrix_desc(b_hi + 2 * kPartBytes, kLbo, kSbo));
        wgmma_commit_and_wait();
        pin(hi); pin(mid); pin(lo);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i)
          acc[slice * (kN / 2) + i] = fmaxf(acc[slice * (kN / 2) + i], (hi[i] + mid[i]) + lo[i]);
      }

      turn ^= 1;
      dirty = true;
      at.j0 = j1;
      if (j1 == kChunk) continue;  // the tile may go on in the next window
    }

    // the tile is complete: it leaves from the registers
    {
      const bool pairs = (c % 2 == 0) && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
      for (int up = 0; up < 2; ++up) {
        const int cell = cell0 + row0 + 8 * up;
        if (cell < cell_end) {
          float* dst = o + (int64_t)cell * c + ch0;
#pragma unroll
          for (int g = 0; g < CB / 8; ++g) {
            const int col = 8 * g + 2 * quad;
            const float v0 = acc[4 * g + 2 * up], v1 = acc[4 * g + 2 * up + 1];
            if (pairs && col + 1 < cw) {
              *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
            } else {
              if (col < cw) dst[col] = v0;
              if (col + 1 < cw) dst[col + 1] = v1;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) acc[i] = 0.0f;
    }
    dirty = false;
    ++tile;
  }
  bev::cp_async_wait_all();
}

template <int CB>
int resources(int* out5) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bev_scatter_onehot_kernel<CB>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bev_scatter_onehot_kernel<CB>,
                                                      bev::kStreamThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out5[0] = attr.numRegs;
  out5[1] = (int)attr.sharedSizeBytes;
  out5[2] = (int)attr.localSizeBytes;
  out5[3] = 0;
  out5[4] = blocks;
  return (int)cudaGetLastError();
}

}  // namespace

// Resources of the kernel as built for channel groups of `cb`, for the build
// report: registers a thread, static shared memory, local (spill) bytes a
// thread, dynamic shared memory, resident blocks an SM. Returns the first
// CUDA error.
extern "C" int bev_scatter_onehot_resources(int cb, int* out5) {
  if (cb == 32) return resources<32>(out5);
  if (cb == 64) return resources<64>(out5);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point, loaded with ctypes. `cb` is the channel group, 32 or
// 64; the tile is kTileCells cells and a chunk at most kChunk rows, the
// instruction's M and K. Launches on `stream` and returns the first CUDA
// error (0 on success); it does not synchronise.
extern "C" int bev_scatter_onehot_launch(const float* feats, const int* pids, float* out,
                                         int b, int n, int hw, int c, int span_tiles,
                                         int cb, void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  if (span_tiles <= 0 || (cb != 32 && cb != 64)) return (int)cudaErrorInvalidValue;
  const int tiles = (hw + kTileCells - 1) / kTileCells;
  const dim3 grid((tiles + span_tiles - 1) / span_tiles, b, (c + cb - 1) / cb);
  const int vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  if (cb == 32)
    bev_scatter_onehot_kernel<32><<<grid, bev::kStreamThreads, 0, (cudaStream_t)stream>>>(
        feats, pids, out, n, hw, c, span_tiles, vec);
  else
    bev_scatter_onehot_kernel<64><<<grid, bev::kStreamThreads, 0, (cudaStream_t)stream>>>(
        feats, pids, out, n, hw, c, span_tiles, vec);
  return (int)cudaGetLastError();
}
