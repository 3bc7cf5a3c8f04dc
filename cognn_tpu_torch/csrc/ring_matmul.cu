// Exact batched integer matmul mod 2^64: C[b] = A[b] * B[b] on row-major
// int64 in two's complement, for ANY 64-bit operands. This is the product
// at the heart of every secret-shared PreScatter matmul: the shares of H and
// W are reconstructed, multiplied exactly in Z_2^64, then truncated and
// re-shared (cognn_tpu_torch/mpc/protocol.py).
//
// Replaces cognn_tpu/ops/intmatmul.py `ring_matmul_small_prepped` (:147,
// 24 int8 MXU dots on byte limbs, valid when both operands fit int32) and
// `ring_matmul` (:58, 36 dots, any operands). cuBLAS has no 64-bit integer
// GEMM, and Hopper has no 64-bit multiplier: a 64-bit multiply-add is three
// 32-bit IMADs, which bound the first design of this kernel (3.3-6.7x above
// that bound at the inference shapes).
//
// The arithmetic, as the JAX package's: with unsigned bytes A = sum_i
// 2^(8i) A_i and B = sum_j 2^(8j) B_j, C = sum_{i+j<=7} 2^(8(i+j)) A_i B_j
// mod 2^64 (the 28 pairs with i+j >= 8 vanish mod 2^64). The 36 byte
// products A_i B_j run on the int8 tensor cores as
// `mma.sync.m16n8k32.row.col.s32.u8.u8.s32`. The products of equal shift
// s = i+j go into one s32 accumulator per shift, flushed into uint64 (<< 8s,
// wrapping add) every kChunkK of K. Exact: a shift sums at most 8 pairs, so
// an accumulator holds at most 8 * 255^2 * 4096 = 2,130,739,200 < 2^31 - 1.
//
// What bounds it on the H100: bytes. The tensor-core work is 36 byte
// products a multiply-add, 2.27 us at 1,979 TOP/s on Cora's layer 0
// ([2,1360,1433] @ [2,1433,16]), against 9.52 us to read A, B and write C
// once at 3.35 TB/s; so mma.sync suffices (a build of this kernel with its
// mma's removed runs in about the same time). The design keeps A's stream
// moving:
// - A is read from device memory once, coalesced: each warp copies its
//   16-row x 32-word K step into a shared-memory ring of kAStages steps
//   with cp.async, 16 bytes a lane where K is even and 8 where it is odd
//   (rows of int64 are then only 8-byte aligned), zero-filled past the
//   ragged edges, while it multiplies the step copied before. Each thread
//   reads its fragment words with 16-byte shared loads and splits them
//   into the 8 limb fragments in registers (__byte_perm), so every A word
//   serves all 36 products.
// - B's 8 limb planes are built once per block for kStageK of K at a time
//   in shared memory (coalesced loads, laid out so that each B fragment
//   register is one conflict-free 32-bit load); the four warps of a block
//   (4 x 16 rows) share them. The next A step is in flight while they are
//   built.
// - Enough blocks, in one wave: a block owns 64 rows x 16 columns of C for
//   one slice of K, kBlocksPerSm blocks fit an SM. Where the row blocks
//   alone leave SMs idle (Cora's layer 0 has 22 a party), the wrapper
//   (ops/intmatmul.py k_slice) splits K into slices as far as all blocks
//   still fit at once, and each block adds its partial C into a zeroed C
//   with 64-bit atomicAdd on unsigned long long: that wraps mod 2^64, so
//   the result is exact and does not depend on the order. With one slice
//   C is stored.
// The stream still runs at ~2 TB/s, not 3.35: a later design would move A
// with TMA into a deeper ring and the products to wgmma.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;  // 16-row tiles of C per block, one a warp
constexpr int kThreads = kWarp * kWarps;
constexpr int kRows = 16;  // mma M
constexpr int kN8 = 8;  // mma N
constexpr int kCols = 2 * kN8;  // columns of C per block
constexpr int kStep = 32;  // mma K, in bytes: one K step
constexpr int kStageK = 128;  // K of B's limb planes staged at once
constexpr int kStepsPerStage = kStageK / kStep;
constexpr int kAStages = 2;  // depth of each warp's A ring
constexpr int kBlocksPerSm = 3;  // BLOCKS_PER_SM of intmatmul.py
constexpr int kChunkK = 4096;  // K between flushes: K_CHUNK of intmatmul.py
constexpr int kLimbs = 8;
constexpr int kARow = kStep + 2;  // words an A row in shared memory: 16-byte
                                  // aligned rows, conflict-free 16-byte reads
constexpr int kBRow = kStageK + 16;  // bytes a B plane column: conflict-free
constexpr int kAWords = kWarps * kAStages * kRows * kARow;
constexpr int kSmemBytes = 8 * kAWords + kLimbs * kCols * kBRow;
constexpr int kBQuads = kCols * kStageK / 4;  // B words of a stage, by 4
constexpr int kBBatch = 4;  // quads a thread loads before it splits them
static_assert(kBQuads % (kBBatch * kThreads) == 0, "whole B batches");
static_assert(kChunkK % kStageK == 0, "flushes fall on stage boundaries");

// Limb fragments of four consecutive words: out[i] holds byte i of w0..w3
// in its bytes 0..3 (w0's in byte 0).
__device__ __forceinline__ void byte_transpose(uint32_t w0, uint32_t w1,
                                               uint32_t w2, uint32_t w3,
                                               uint32_t* out) {
  uint32_t x = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  uint32_t y = __byte_perm(w2, w3, 0x5140);
  out[0] = __byte_perm(x, y, 0x5410);
  out[1] = __byte_perm(x, y, 0x7632);
  x = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  y = __byte_perm(w2, w3, 0x7362);
  out[2] = __byte_perm(x, y, 0x5410);
  out[3] = __byte_perm(x, y, 0x7632);
}

// limb[i] = byte i of each of four uint64 words, for i = 0..7
__device__ __forceinline__ void limbs_of(const uint64_t (&w)[4],
                                         uint32_t (&limb)[kLimbs]) {
  byte_transpose(static_cast<uint32_t>(w[0]), static_cast<uint32_t>(w[1]),
                 static_cast<uint32_t>(w[2]), static_cast<uint32_t>(w[3]),
                 limb);
  byte_transpose(static_cast<uint32_t>(w[0] >> 32),
                 static_cast<uint32_t>(w[1] >> 32),
                 static_cast<uint32_t>(w[2] >> 32),
                 static_cast<uint32_t>(w[3] >> 32), limb + 4);
}

__device__ __forceinline__ void mma_u8(int32_t (&acc)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_8(uint64_t* dst, const uint64_t* src,
                                           bool valid) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_16(uint64_t* dst, const uint64_t* src,
                                            bool valid) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAStages - 2));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ring_matmul_u8_mma(const uint64_t* __restrict__ a,
                   const uint64_t* __restrict__ b, uint64_t* __restrict__ c,
                   int n, int k, int m, int k_slice, int slices) {
  extern __shared__ __align__(16) uint64_t smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in the group
  // this warp's A ring: kAStages steps of kRows x kARow words
  uint64_t* ring = smem + warp * kAStages * kRows * kARow;
  // B limb planes: [limb][column][kBRow bytes], K contiguous
  uint8_t* bplanes = reinterpret_cast<uint8_t*>(smem + kAWords);

  const int64_t batch = blockIdx.z / slices;
  const int kbeg = blockIdx.z % slices * k_slice;
  const int kend = min(k, kbeg + k_slice);
  a += batch * n * static_cast<int64_t>(k);
  b += batch * k * static_cast<int64_t>(m);
  c += batch * n * static_cast<int64_t>(m);
  const int row0 = blockIdx.x * kRows * kWarps + warp * kRows;
  const int col0 = blockIdx.y * kCols;

  int32_t acc[kLimbs][2][4] = {};  // [shift][n8 tile][fragment]
  uint64_t sum[2][4] = {};

  // copy K step `step` of this warp's rows (from K index k0) into the ring,
  // each row one 256-byte segment: with K even every row is 16-byte
  // aligned, and lanes 16h..16h+15 copy 16 bytes each of rows r + h (L2
  // only); with K odd, lane l copies word l of each row
  const bool wide = k % 2 == 0;
  const int rows = n - row0;  // rows of this warp inside A (may be <= 0)
  const int lr = wide ? lane / 16 : 0;  // row of the lane within a pair
  const int lw = wide ? lane % 16 * 2 : lane;  // first word of the lane
  const uint64_t* arow =
      a + static_cast<int64_t>(min(row0 + lr, n - 1)) * k + lw;
  auto copy_step = [&](int k0, int step) {
    uint64_t* dst = ring + step % kAStages * kRows * kARow + lr * kARow + lw;
    const bool kin = k0 + lw < kend;  // (kend is even when K is)
    const uint64_t* src = arow + k0;
    if (wide) {
#pragma unroll
      for (int r = 0; r < kRows; r += 2) {
        const bool ok = kin && r + lr < rows;
        cp_async_16(dst + r * kARow, ok ? src : a, ok);
        src += 2 * static_cast<int64_t>(k);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool ok = kin && r < rows;
        cp_async_8(dst + r * kARow, ok ? src : a, ok);
        src += k;
      }
    }
  };

  for (int kb = kbeg; kb < kend; kb += kStageK) {
    __syncthreads();  // every warp is done with the previous stage
    // the first A steps of the stage go in flight before B's planes are built
    const int steps = min(kStepsPerStage, (kend - kb + kStep - 1) / kStep);
#pragma unroll
    for (int s = 0; s < kAStages - 1; ++s) {
      if (s < steps) copy_step(kb + s * kStep, s);
      cp_async_commit();
    }
    // B limb planes of K [kb, kb + kStageK): 4 consecutive K of a column
    // give one 32-bit word of each plane; neighbouring threads take
    // neighbouring columns (coalesced loads), and a thread loads kBBatch
    // such quads before it splits them, so their loads are in flight together
#pragma unroll
    for (int i0 = 0; i0 < kBQuads; i0 += kBBatch * kThreads) {
      uint64_t w[kBBatch][4];
#pragma unroll
      for (int u = 0; u < kBBatch; ++u) {
        const int i = i0 + u * kThreads + threadIdx.x;
        const int col = i % kCols;
        const int kq = kb + 4 * (i / kCols);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          w[u][x] = kq + x < kend && col0 + col < m
                        ? b[static_cast<int64_t>(kq + x) * m + col0 + col]
                        : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kBBatch; ++u) {
        const int i = i0 + u * kThreads + threadIdx.x;
        const int col = i % kCols;
        const int q = i / kCols;
        uint32_t limb[kLimbs];
        limbs_of(w[u], limb);
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) {
          *reinterpret_cast<uint32_t*>(
              bplanes + (j * kCols + col) * kBRow + 4 * q) = limb[j];
        }
      }
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      cp_async_wait_ring();  // step s has landed (this lane's copies)
      __syncwarp();  // ... and every lane's; step s - 1 is read by all
      if (s + kAStages - 1 < steps) {
        copy_step(kb + (s + kAStages - 1) * kStep, s + kAStages - 1);
      }
      cp_async_commit();

      // A fragments: a0 rows g, K 4t..4t+3; a1 rows g+8; a2 and a3 the same
      // rows at K 16+4t..16+4t+3; each four words, split into 8 limbs
      const uint64_t* as = ring + s % kAStages * kRows * kARow;
      uint32_t al[kLimbs][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const uint64_t* p = as + (g + f % 2 * 8) * kARow + f / 2 * 16 + 4 * t;
        const uint4 lo = *reinterpret_cast<const uint4*>(p);
        const uint4 hi = *reinterpret_cast<const uint4*>(p + 2);
        const uint64_t w[4] = {
            lo.x | static_cast<uint64_t>(lo.y) << 32,
            lo.z | static_cast<uint64_t>(lo.w) << 32,
            hi.x | static_cast<uint64_t>(hi.y) << 32,
            hi.z | static_cast<uint64_t>(hi.w) << 32};
        uint32_t limb[kLimbs];
        limbs_of(w, limb);
#pragma unroll
        for (int i = 0; i < kLimbs; ++i) al[i][f] = limb[i];
      }
      // B fragments: b0 K 4t..4t+3, b1 K 16+4t..16+4t+3, column g
      const int kk = s * kStep + 4 * t;
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) {
        uint32_t bf[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* col = bplanes + (j * kCols + h * kN8 + g) * kBRow;
          bf[h][0] = *reinterpret_cast<const uint32_t*>(col + kk);
          bf[h][1] = *reinterpret_cast<const uint32_t*>(col + kk + 16);
        }
#pragma unroll
        for (int i = 0; i + j < kLimbs; ++i) {
          mma_u8(acc[i + j][0], al[i], bf[0]);
          mma_u8(acc[i + j][1], al[i], bf[1]);
        }
      }
    }

    // flush the shift sums into uint64 every kChunkK of K and at the end
    if ((kb + kStageK - kbeg) % kChunkK == 0 || kb + kStageK >= kend) {
#pragma unroll
      for (int s = 0; s < kLimbs; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum[h][i] += static_cast<uint64_t>(
                             static_cast<uint32_t>(acc[s][h][i])) << (8 * s);
            acc[s][h][i] = 0;
          }
        }
      }
    }
  }

  // accumulator: rows g and g+8, columns 2t and 2t+1 of each n8 tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + i / 2 * 8;
      const int col = col0 + h * kN8 + 2 * t + i % 2;
      if (row < n && col < m) {
        uint64_t* dst = c + static_cast<int64_t>(row) * m + col;
        if (slices > 1) {
          atomicAdd(reinterpret_cast<unsigned long long*>(dst),
                    static_cast<unsigned long long>(sum[h][i]));
        } else {
          *dst = sum[h][i];
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
// `k_slice` (a multiple of 256) is the K of one block; with more than one
// slice, `c` must be zeroed by the caller.
extern "C" int cognn_ring_matmul_i64(const int64_t* a, const int64_t* b,
                                     int64_t* c, int batch, int n, int k,
                                     int m, int k_slice,
                                     cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_matmul_u8_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (k_slice <= 0 || k_slice % kStageK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (k + k_slice - 1) / k_slice;
  const dim3 grid((n + kRows * kWarps - 1) / (kRows * kWarps),
                  (m + kCols - 1) / kCols, batch * slices);
  ring_matmul_u8_mma<<<grid, kThreads, kSmemBytes, stream>>>(
      reinterpret_cast<const uint64_t*>(a), reinterpret_cast<const uint64_t*>(b),
      reinterpret_cast<uint64_t*>(c), n, k, m, k_slice, slices);
  return static_cast<int>(cudaGetLastError());
}
