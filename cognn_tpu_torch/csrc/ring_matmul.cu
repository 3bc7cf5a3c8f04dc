// Exact batched integer matmul mod 2^64: C[b] = A[b] * B[b] on row-major
// int64 in two's complement, for ANY 64-bit operands. This is the product
// at the heart of every secret-shared PreScatter matmul: the shares of H and
// W are reconstructed, multiplied exactly in Z_2^64, then truncated and
// re-shared (cognn_tpu_torch/mpc/protocol.py).
//
// Replaces cognn_tpu/ops/intmatmul.py `ring_matmul_small_prepped` (:147,
// 24 int8 MXU dots on byte limbs, valid when both operands fit int32) and
// `ring_matmul` (:58, 36 dots, any operands). The TPU has no 64-bit integer
// datapath and cuBLAS has no 64-bit integer GEMM, so here the products are
// plain uint64_t multiply-adds, whose wrap-around is exactly the ring's.
//
// Bound on the H100: integer operations. Hopper has no 64-bit multiplier; one
// 64-bit multiply-add needs three 32-bit multiplies (IMAD.WIDE.U32 for lo*lo
// plus the sum, two IMADs for the cross terms into the high word) and one
// add, and the IMAD pipe issues 64 a clock per SM. At the inference path's shapes
// (K = 1433 or 500, M = 16) that is above the byte bound of A, B and C read
// or written once.
//
// Design (simple first): a block of 256 threads owns a 32-row x 16-column
// tile of C and walks K in tiles of 32, staging the A and B tiles in shared
// memory (zero-filled past the ragged edges) so each loaded word serves 16
// (A) or 32 (B) multiply-adds. Each thread keeps two uint64_t sums in
// registers (rows r and r + 16 of its column); no atomics, so the result
// needs no particular order. The grid's y axis walks column tiles (any M) and
// its z axis the batch (parties). Later work: byte limbs on the int8 tensor
// cores through wgmma.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 16;                   // columns of C per block
constexpr int kRowGroups = kThreads / kTileM;  // 16
constexpr int kRowsPerThread = 2;
constexpr int kTileN = kRowGroups * kRowsPerThread;  // 32 rows of C per block
constexpr int kTileK = 32;

__global__ void __launch_bounds__(kThreads)
ring_matmul_u64(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                uint64_t* __restrict__ c, int n, int k, int m) {
  // +1 word of padding: the two row groups of a warp read different banks
  __shared__ uint64_t a_tile[kTileN][kTileK + 1];
  __shared__ uint64_t b_tile[kTileK][kTileM];

  const int64_t batch = blockIdx.z;
  a += batch * n * static_cast<int64_t>(k);
  b += batch * k * static_cast<int64_t>(m);
  c += batch * n * static_cast<int64_t>(m);
  const int row0 = blockIdx.x * kTileN;
  const int col0 = blockIdx.y * kTileM;
  const int tid = threadIdx.x;
  const int tc = tid % kTileM;
  const int tr = tid / kTileM;

  uint64_t acc[kRowsPerThread] = {};
  for (int k0 = 0; k0 < k; k0 += kTileK) {
#pragma unroll
    for (int i = tid; i < kTileN * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int gr = row0 + r, gk = k0 + kk;
      a_tile[r][kk] = (gr < n && gk < k)
                          ? a[static_cast<int64_t>(gr) * k + gk] : 0;
    }
#pragma unroll
    for (int i = tid; i < kTileK * kTileM; i += kThreads) {
      const int kk = i / kTileM, cc = i % kTileM;
      const int gk = k0 + kk, gc = col0 + cc;
      b_tile[kk][cc] = (gk < k && gc < m)
                           ? b[static_cast<int64_t>(gk) * m + gc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const uint64_t bv = b_tile[kk][tc];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        acc[j] += a_tile[tr + j * kRowGroups][kk] * bv;
      }
    }
    __syncthreads();
  }
  const int gc = col0 + tc;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int gr = row0 + tr + j * kRowGroups;
    if (gr < n && gc < m) c[static_cast<int64_t>(gr) * m + gc] = acc[j];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
extern "C" int cognn_ring_matmul_i64(const int64_t* a, const int64_t* b,
                                     int64_t* c, int batch, int n, int k,
                                     int m, cudaStream_t stream) {
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM, batch);
  ring_matmul_u64<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint64_t*>(a), reinterpret_cast<const uint64_t*>(b),
      reinterpret_cast<uint64_t*>(c), n, k, m);
  return static_cast<int>(cudaGetLastError());
}
