// Block-sparse tensor-core SpMM: the aggregation U = A^T * H with A held as
// dense 16x16 bf16 tiles of edge counts, contracted on the tensor cores.
//
//   out[d, :] = sum over edges e into d of bf16(count_e) * bf16(h[src_e, :])
//
// in f32 (the products of two bf16 values are exact in f32), [n_dst, D] out,
// zero for a destination with no edge.
//
// Replaces the TPU kernel cognn_tpu/ops/pallas_spmm.py `_merged_kernel`
// (PallasSpmmMerged): runs of 128x128 blocks that share a destination block
// contracted as one K = G*128 matrix-unit dot, with H cast to bf16 in the
// kernel and an f32 accumulator. The merge is what this kernel keeps: one
// warp owns a 16-row destination tile and runs every source tile of that
// destination through `mma.sync.m16n8k16` into the same f32 accumulator,
// then writes its rows once, with no atomics (so every destination row is
// written, and the result does not change from run to run).
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): A is the 16 (destination) x
// 16 (source) tile, row-major, stored destination-major by the builder
// (ops/bcsr.py build_tiles_by_dst), so each thread's four A registers are
// four aligned 32-bit loads. B is the 16 matching source rows of H, 8
// features wide: each thread loads four f32 values from H and rounds them
// to bf16 in registers (H stays f32 in memory, as the TPU kernel's `ht`
// does). The accumulator is 16 rows x 8 features; a warp keeps two, so one
// pass covers 16 features (blockIdx.y walks wider D in steps of 16). A
// ragged D (7, 3) and ragged edges of the graph are masked: source rows past
// n_src load 0, features past D load 0 and are not written, destination
// rows past n_dst are not written. (A tile entry of 0 times a non-finite H
// value would give NaN; H is finite on every path.)
//
// Bound on the H100: bytes, at the fill of these graphs. The tile stream is
// 512 bytes a non-empty tile; on the microbenchmark's banded graph (V =
// 32768, E = 131072, band 2048) 116,060 of them hold 131,007 distinct edges
// (1.13 a tile): 59 MB, against 1.2 MB for the destination CSR of spmm.cu.
// The function itself needs only that CSR, H and out once (5.4 MB at D =
// 16), so the tiles are 11x its compulsory bytes. At 128x128 (the TPU
// layout) they would be 8,448 tiles and 277 MB, at 32x32 170 MB. So on
// sparse graphs this kernel is slower than the CSR kernel by design; it
// pays where tiles are dense (clustered or reordered graphs, wide D).
// Simple first: no TMA, cp.async, shared-memory staging or wgmma yet; the
// tile loop is unrolled so loads of later tiles issue ahead of the mma.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // mma.m16n8k16: M = K = 16
constexpr int kWarp = 32;
constexpr int kWarps = 4;  // destination tiles per block
constexpr int kChunk = 8;  // features per accumulator (mma N)
constexpr int kChunks = 2;  // accumulators per warp
constexpr int kTileWords = kTile * kTile / 2;  // bf16 pairs per tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&acc)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kWarp * kWarps)
tile_mma_spmm_bf16(const int32_t* __restrict__ tptr,
                   const int32_t* __restrict__ tsrc,
                   const uint32_t* __restrict__ tiles,
                   const float* __restrict__ h, float* __restrict__ out,
                   int n_src, int n_dst, int d) {
  const int dtile = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (dtile * kTile >= n_dst) return;  // the whole warp leaves together
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in the group
  const int col0 = blockIdx.y * kChunk * kChunks;
  float acc[kChunks][4] = {};
  const int beg = tptr[dtile];
  const int end = tptr[dtile + 1];
#pragma unroll 4
  for (int k = beg; k < end; ++k) {
    const uint32_t* a = tiles + static_cast<int64_t>(k) * kTileWords;
    // rows g and g+8 (destinations), columns 2t,2t+1 and 2t+8,2t+9 (sources)
    const uint32_t af[4] = {a[g * 8 + t], a[(g + 8) * 8 + t],
                            a[g * 8 + t + 4], a[(g + 8) * 8 + t + 4]};
    // B rows (sources) 2t, 2t+1, 2t+8, 2t+9 of this tile, column g
    const int s0 = tsrc[k] * kTile + 2 * t;
    const int rows[4] = {s0, s0 + 1, s0 + 8, s0 + 9};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = col0 + c * kChunk + g;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = (rows[i] < n_src && col < d)
                   ? h[static_cast<int64_t>(rows[i]) * d + col]
                   : 0.0f;
      }
      const uint32_t bf[2] = {pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])};
      mma_16816(acc[c], af, bf);
    }
  }
  // accumulator: rows g and g+8, columns 2t and 2t+1 of each chunk
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = dtile * kTile + g + (i / 2) * 8;
      const int col = col0 + c * kChunk + 2 * t + i % 2;
      if (row < n_dst && col < d) {
        out[static_cast<int64_t>(row) * d + col] = acc[c][i];
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
// `tiles` holds the bf16 tiles, [n_tiles][16][16] destination-major.
extern "C" int cognn_spmm_tiles_bf16(const int32_t* tptr, const int32_t* tsrc,
                                     const void* tiles, const float* h,
                                     float* out, int n_src, int n_dst, int d,
                                     cudaStream_t stream) {
  const int n_dst_tiles = (n_dst + kTile - 1) / kTile;
  const dim3 grid((n_dst_tiles + kWarps - 1) / kWarps,
                  (d + kChunk * kChunks - 1) / (kChunk * kChunks));
  tile_mma_spmm_bf16<<<grid, kWarp * kWarps, 0, stream>>>(
      tptr, tsrc, static_cast<const uint32_t*>(tiles), h, out, n_src, n_dst,
      d);
  return static_cast<int>(cudaGetLastError());
}
