// Sampled dense-dense product (SDDMM): one f32 score per edge,
//
//   scores[e] = sum over k < D of a[src_e, k] * b[dst_e, k]
//
// in the order of the input edge list (a duplicated edge is scored once per
// copy). The per-edge score of attention-style models over the graph.
//
// Replaces the TPU kernel cognn_tpu/ops/pallas_sddmm.py `_kernel`
// (PallasSddmm): one grid step per non-zero 128x128 block computes the
// dense block At[:, bi]^T * Bt[:, bj] on the matrix unit and masks it by the
// block's edges, and `edge_scores` then picks the edges out of the
// block-dense output. Here each edge's score is computed directly: no block
// is formed, no mask is read, nothing but the scores is written.
//
// Bound on the H100: bytes. An edge reads its two D-wide f32 rows (gathered
// by index, reused across edges through L2) and two indices and writes one
// score: 2 flops for every 8 bytes of rows, far below the card's flop/byte
// balance.
//
// Design: a group of L lanes per edge, L the power of two that covers D up
// to 32 (so a warp scores 32/L edges when D < 32: 2 edges at D = 16),
// lanes over the features, each lane summing its features, then a
// butterfly of warp shuffles inside the group. Every lane of the warp takes
// part in the shuffles; lanes past the last edge add nothing and write
// nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
edge_dot_f32(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int64_t n_edges, int d) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t e = tid / kLanes;
  const int sub = static_cast<int>(tid % kLanes);
  float acc = 0.0f;
  if (e < n_edges) {
    const float* ar = a + static_cast<int64_t>(src[e]) * d;
    const float* br = b + static_cast<int64_t>(dst[e]) * d;
    for (int k = sub; k < d; k += kLanes) acc = fmaf(ar[k], br[k], acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (e < n_edges && sub == 0) out[e] = acc;
}

template <int kLanes>
void launch(const int32_t* src, const int32_t* dst, const float* a,
            const float* b, float* out, int64_t n_edges, int d,
            cudaStream_t stream) {
  const int64_t blocks = (n_edges * kLanes + kThreads - 1) / kThreads;
  edge_dot_f32<kLanes><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(src, dst, a, b, out, n_edges, d);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
extern "C" int cognn_sddmm_f32(const int32_t* src, const int32_t* dst,
                               const float* a, const float* b, float* out,
                               int64_t n_edges, int d, cudaStream_t stream) {
  if (d > 16) {
    launch<32>(src, dst, a, b, out, n_edges, d, stream);
  } else if (d > 8) {
    launch<16>(src, dst, a, b, out, n_edges, d, stream);
  } else if (d > 4) {
    launch<8>(src, dst, a, b, out, n_edges, d, stream);
  } else if (d > 2) {
    launch<4>(src, dst, a, b, out, n_edges, d, stream);
  } else if (d > 1) {
    launch<2>(src, dst, a, b, out, n_edges, d, stream);
  } else {
    launch<1>(src, dst, a, b, out, n_edges, d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
