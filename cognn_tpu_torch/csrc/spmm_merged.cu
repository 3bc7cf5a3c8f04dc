// Block-sparse tensor-core SpMM: the aggregation U = A^T * H with A held as
// 16x16 tiles of edge counts, compressed to their entries, expanded in
// shared memory and contracted on the tensor cores.
//
//   out[d, :] = sum over edges e into d of bf16(count_e) * bf16(h[src_e, :])
//
// in f32 (the products of two bf16 values are exact in f32), [n_dst, D] out,
// zero for a destination with no edge.
//
// Replaces the TPU kernel cognn_tpu/ops/pallas_spmm.py `_merged_kernel`
// (PallasSpmmMerged): runs of 128x128 blocks that share a destination block
// contracted as one K = G*128 matrix-unit dot, with H cast to bf16 in the
// kernel and an f32 accumulator. The merge is what this kernel keeps: all
// source tiles of a 16-row destination tile go through `mma.sync.m16n8k16`
// into the accumulators of one block, whose rows are written once.
//
// What bounds it on the H100: latency and instructions, not bytes. The
// function's compulsory bytes (the CSR of the counts, H and out once) are
// 5.4 MB on the microbenchmark's banded graph (V = 32768, E = 131072, band
// 2048, D = 16), 1.6 us at 3.35 TB/s, but a 16x16 tile there holds 1.13
// edges: the work is ~116,000 tiles of about one edge each. The first
// design streamed each tile as 512 dense bytes (59.9 MB) and gave one warp
// all tiles of a destination tile, a chain of dependent loads per tile
// (31x the bound). This design:
// - stores only the entries (ops/bcsr.py build_tiles_by_dst): per entry
//   its position in its tile and bf16 count in one 32-bit word and its
//   source row in another, sorted by destination tile, source tile,
//   position, and one pointer per destination tile: 1.06 MB on that graph.
//   A tile is a run of entries with one source tile.
// - takes the entries 32 at a time, one a lane: each lane loads its entry
//   and then its source row of H (16 features, bf16 in registers), so a
//   batch costs two dependent loads whatever its tiles, and only the H rows
//   of source columns that hold an entry are read.
// - expands the batch's runs kSlots at a time in shared memory: a lane
//   writes its count into its run's A slot (destination x source) and its
//   H row into the run's B slot (source x feature), `ldmatrix` reads both
//   (B with .trans), two `mma.sync` per tile, then each lane clears what it
//   wrote, so the slots are zeroed once per block, not per tile. A tile
//   split between two batches is contracted in two parts.
// - splits a destination tile's batches over the kWarps warps of its block;
//   the warps write their 16x16 f32 accumulators to shared memory, and each
//   output element is summed over the warps in warp order: no atomics, the
//   same result on every run, and every destination row written (zero when
//   it has no edge).
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): A is the 16 (destination) x
// 16 (source) tile, row-major; B the 16 (source) x 16 (feature) tile, whose
// two 8-feature halves are the B operands of the two 16x8 accumulators of a
// warp, so one block covers 16 features (blockIdx.y walks wider D in steps
// of 16). H stays f32 in memory and is rounded to bf16 in registers, as the
// TPU kernel's `ht`. A ragged D (7, 3) loads 0 past D and writes no column
// past D, nor rows past n_dst.
//
// Not taken: 8-wide destination tiles with H^T as the A operand. With tiles
// stored as entries the tile edge no longer sets the bytes, and 16-row
// destination tiles halve the blocks. cp.async is not used: each lane's
// loads are plain loads issued together.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // mma.m16n8k16: M = K = 16
constexpr int kArea = kTile * kTile;
constexpr int kWarp = 32;
constexpr int kWarps = 4;  // warps sharing one destination tile
constexpr int kSlots = 8;  // tiles a warp expands at once
constexpr int kAcc = 2;  // accumulator sets: tile i of a round goes to i % kAcc
constexpr int kChunk = 8;  // features per accumulator (mma N)
constexpr int kChunks = 2;  // accumulators per warp
constexpr int kCols = kChunk * kChunks;  // features per block
static_assert(kCols == kTile, "a B tile is 16 sources x 16 features");
constexpr unsigned kFull = 0xffffffffu;

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

// The four 8x8 b16 matrices of a 16x16 row-major tile: lanes 8m..8m+7 give
// the rows of matrix m (rows 0-7 / 8-15 for m even / odd, columns 0-7 / 8-15
// for m < 2 / m >= 2). Without .trans that is mma.m16n8k16's A fragment
// order (row-major A); with .trans, the B fragments (k = tile rows, n =
// tile columns) of both 8-column halves.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const uint16_t* row, bool trans) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr));
  }
}

__global__ void __launch_bounds__(kWarp * kWarps)
tile_mma_spmm_bf16(const int32_t* __restrict__ dptr,
                   const uint32_t* __restrict__ entries,
                   const int32_t* __restrict__ esrc,
                   const float* __restrict__ h, float* __restrict__ out,
                   int n_dst, int d) {
  // per warp and slot: an A tile (destination x source) and a B tile
  // (source x feature), bf16, row-major; zero but for what a run writes
  // and clears again
  __shared__ __align__(16) uint16_t aslot[kWarps][kSlots][kArea];
  __shared__ __align__(16) uint16_t bslot[kWarps][kSlots][kArea];
  __shared__ float partial[kWarps][kTile][kCols];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in the group
  const int dtile = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int beg = dptr[dtile];
  const int end = dptr[dtile + 1];
  // this lane's ldmatrix row: matrix lane / 8, row lane % 8 of it
  const int lrow = lane % 8 + (lane / 8) % 2 * 8;
  const int lcol = lane / 16 * 8;
  const bool vec = d % 4 == 0 && col0 + kCols <= d;  // 16-byte H loads
  uint4* zero = reinterpret_cast<uint4*>(&aslot[warp][0][0]);
  uint4* zero_b = reinterpret_cast<uint4*>(&bslot[warp][0][0]);
#pragma unroll
  for (int i = lane; i < kSlots * kArea * 2 / 16; i += kWarp) {
    zero[i] = make_uint4(0, 0, 0, 0);
    zero_b[i] = make_uint4(0, 0, 0, 0);
  }
  __syncwarp();
  float acc[kAcc][kChunks][4] = {};

  for (int e0 = beg + warp * kWarp; e0 < end; e0 += kWarps * kWarp) {
    // one entry a lane, with its source row of H as 16 bf16 features
    const int e = e0 + lane;
    const bool valid = e < end;
    const uint32_t w = valid ? entries[e] : 0u;
    const int s = valid ? esrc[e] : 0;
    uint4 hb[2] = {};
    if (valid) {
      const float* row = h + static_cast<int64_t>(s) * d + col0;
      float v[kCols];
      if (vec) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + c);
          v[c] = x.x, v[c + 1] = x.y, v[c + 2] = x.z, v[c + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = col0 + c < d ? row[c] : 0.0f;
      }
      hb[0] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      hb[1] = make_uint4(pack_bf16(v[8], v[9]), pack_bf16(v[10], v[11]),
                         pack_bf16(v[12], v[13]), pack_bf16(v[14], v[15]));
    }
    // the batch's tiles are its runs of one source tile
    const int key = valid ? s / kTile : -1;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned starts =
        __ballot_sync(kFull, valid && (lane == 0 || key != prev));
    const int run = __popc(starts & ((2u << lane) - 1)) - 1;
    const int runs = __popc(starts);
    uint16_t* a_at = &aslot[warp][0][w & 0xFF];
    uint4* b_at = reinterpret_cast<uint4*>(&bslot[warp][0][s % kTile * kTile]);
    for (int r0 = 0; r0 < runs; r0 += kSlots) {
      const int j = run - r0;
      const bool mine = valid && j >= 0 && j < kSlots;
      if (mine) {  // the count into the A tile, the H row into the B tile
        a_at[j * kArea] = static_cast<uint16_t>(w >> 16);
        b_at[j * kArea / 8] = hb[0];
        b_at[j * kArea / 8 + 1] = hb[1];
      }
      __syncwarp();
      const int m = min(kSlots, runs - r0);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i < m) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, &aslot[warp][i][lrow * kTile + lcol], false);
          ldmatrix_x4(bf, &bslot[warp][i][lrow * kTile + lcol], true);
          // bf: sources 0-7 and 8-15 of features 0-7, then of 8-15
          const uint32_t b0[2] = {bf[0], bf[1]};
          const uint32_t b1[2] = {bf[2], bf[3]};
          mma_16816(acc[i % kAcc][0], af, b0);
          mma_16816(acc[i % kAcc][1], af, b1);
        }
      }
      __syncwarp();
      if (mine) {  // clear what this lane wrote
        a_at[j * kArea] = 0;
        b_at[j * kArea / 8] = make_uint4(0, 0, 0, 0);
        b_at[j * kArea / 8 + 1] = make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
    }
  }
  // accumulator: rows g and g+8, columns 2t and 2t+1 of each chunk
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[0][c][i];
#pragma unroll
      for (int u = 1; u < kAcc; ++u) v += acc[u][c][i];
      partial[warp][g + i / 2 * 8][c * kChunk + 2 * t + i % 2] = v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kCols; i += kWarp * kWarps) {
    const int r = i / kCols;
    const int cc = i % kCols;
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) sum += partial[u][r][cc];  // warp order
    const int row = dtile * kTile + r;
    const int col = col0 + cc;
    if (row < n_dst && col < d) out[static_cast<int64_t>(row) * d + col] = sum;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
// The tiles are ops/bcsr.py's TileMatrix: dptr [n_dst_tiles + 1], entries
// and esrc [nnz].
extern "C" int cognn_spmm_tiles_bf16(const int32_t* dptr, const void* entries,
                                     const int32_t* esrc, const float* h,
                                     float* out, int n_dst, int d,
                                     cudaStream_t stream) {
  const dim3 grid((n_dst + kTile - 1) / kTile, (d + kCols - 1) / kCols);
  tile_mma_spmm_bf16<<<grid, kWarp * kWarps, 0, stream>>>(
      dptr, static_cast<const uint32_t*>(entries), esrc, h, out, n_dst, d);
  return static_cast<int>(cudaGetLastError());
}
