// Destination-sorted CSR gather-sum on f32 rows and on int64 ring shares:
// the neighborhood aggregation U = A^T * H of the GAS engines.
//
//   out[d, :] = sum over e in [indptr[d], indptr[d+1]) of counts[e] * h[indices[e], :]
//
// Replaces the TPU kernels cognn_tpu/ops/pallas_spmm.py `_kernel` (one
// 128x128 block per grid step) and `_tiled_kernel` (G blocks per step over
// supertiles). Both compute this function over dense 128x128 blocks of A,
// which on a 0.1%-dense graph are almost all zeros; here A is stored as
// one (source, count) entry per distinct edge.
//
// Bound on the H100: bytes. Each destination row reads its CSR entries
// (8 bytes each) and the D-wide f32 rows of its sources, and writes one
// D-wide row: 2 flops per 4 bytes of H read, far below the card's
// flop/byte balance. The compulsory traffic is the CSR once, H once and
// out once.
//
// Design: one warp per destination row, lanes over the D features (D is
// 16, 7 or 3 on the inference path), f32 accumulation in registers, no
// atomics, so the result is the same from run to run and every destination
// is written exactly once (zero when it has no edge, as the TPU kernels'
// coverage padding guarantees). Gathered H rows are reused across
// destinations through L2, which holds the whole of H at these graph sizes.
// Later work: several rows per warp for narrow D, vectorised loads.
//
// Ring instantiation (csr_gather_sum_u64): the same function on additive
// shares in Z_2^64, the share instantiation of the same two TPU kernels
// (cognn_tpu/mpc/engine.py `_bcsr_agg_shares` sends byte planes of uint32
// limbs through them as int8 or bf16 values and recombines the planes with
// carries, under multiplicity and in-degree exactness guards). Here the rows
// are int64 shares summed in uint64_t, where wrapping is defined and IS the
// ring's addition, with int64 edge counts multiplied in: exact for any
// multiplicity and degree, so no guard is needed. Both shares go in one
// launch (blockIdx.y is the share). Bound: bytes, as above, with 8-byte rows
// and 8-byte counts.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kWarp;

__global__ void __launch_bounds__(kThreads)
csr_gather_sum_f32(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const float* __restrict__ counts,
                   const float* __restrict__ h, float* __restrict__ out,
                   int n_dst, int d) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_dst) return;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int c = lane; c < d; c += kWarp) {
    float acc = 0.0f;
    for (int e = beg; e < end; ++e) {
      acc += counts[e] * h[static_cast<int64_t>(indices[e]) * d + c];
    }
    out[row * d + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
csr_gather_sum_u64(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const uint64_t* __restrict__ counts,
                   const uint64_t* __restrict__ h, uint64_t* __restrict__ out,
                   int n_src, int n_dst, int d) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_dst) return;
  const int64_t share = blockIdx.y;
  h += share * n_src * d;
  out += share * n_dst * d;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int c = lane; c < d; c += kWarp) {
    uint64_t acc = 0;
    for (int e = beg; e < end; ++e) {
      acc += counts[e] * h[static_cast<int64_t>(indices[e]) * d + c];
    }
    out[row * d + c] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
extern "C" int cognn_spmm_csr_f32(const int32_t* indptr,
                                  const int32_t* indices,
                                  const float* counts, const float* h,
                                  float* out, int n_dst, int d,
                                  cudaStream_t stream) {
  const unsigned blocks = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  csr_gather_sum_f32<<<blocks, kThreads, 0, stream>>>(indptr, indices, counts,
                                                       h, out, n_dst, d);
  return static_cast<int>(cudaGetLastError());
}

// The ring instantiation over `shares` stacked [shares, n_src, d] rows into
// [shares, n_dst, d]; same launch contract.
extern "C" int cognn_spmm_csr_i64(const int32_t* indptr,
                                  const int32_t* indices,
                                  const int64_t* counts, const int64_t* h,
                                  int64_t* out, int shares, int n_src,
                                  int n_dst, int d, cudaStream_t stream) {
  const dim3 grid((n_dst + kRowsPerBlock - 1) / kRowsPerBlock, shares);
  csr_gather_sum_u64<<<grid, kThreads, 0, stream>>>(
      indptr, indices, reinterpret_cast<const uint64_t*>(counts),
      reinterpret_cast<const uint64_t*>(h), reinterpret_cast<uint64_t*>(out),
      n_src, n_dst, d);
  return static_cast<int>(cudaGetLastError());
}
