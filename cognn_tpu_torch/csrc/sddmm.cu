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
// balance. On the repo's graphs (1e4-1e5 edges, D = 16 or the label width
// 3-7) that is a few hundred KB to ~2 MB, so a call costs its launch and the
// chain of dependent loads an edge walks (its two indices, then its two
// rows), as in csrc/spmm.cu.
//
// What the first design lost (L lanes an edge, L the power of two covering
// D): a warp scored 2 edges at D = 16, so the microbenchmark's 131,072
// edges took 65,536 warps, ~7.8 waves of the card; each wave paid the two
// round trips one after the other with one 4-byte load of each row a lane
// in flight; every lane of a group loaded the same two indices; 1 lane in 8
// (D = 7) or 4 (D = 3) was idle.
//
// This design:
// - An edge belongs to a group of GC lanes across its row, as in
//   csrc/spmm.cu: GC the power of two (at most 32) that covers D in loads
//   of V elements, V = 4 (a float4) where every row start of a and b is
//   16-byte aligned, else 1. D = 16: 4 lanes x float4, 8 groups a warp;
//   D = 7: 8 scalar lanes, one idle; D = 3: 4. Scalar rows are spread over
//   the lanes so that one load instruction of the warp reads a few rows'
//   consecutive words (few sectors), not one word of 32 rows. A lane covers
//   W elements a chunk (4 for a float4; a scalar lane 1, or at 32 lanes,
//   the group's reach, 2 up to D = 64 and 4 beyond); a row wider than the
//   group loops over chunks.
// - Each group scores kBatch edges: group q of a warp takes the warp's
//   edges q, q + NG, q + 2 NG, ... (NG groups a warp). The warp first loads
//   the index pairs of all its NG * kBatch edges, each once, lane l taking
//   edges l, l + 32, ... (coalesced), and hands each pair to its group with
//   __shfl_sync; then every lane issues all of its batch's row loads, then
//   the FMAs, then a butterfly of shuffles sums each edge across its group.
//   So a warp's two round trips are paid once for kBatch edges a group,
//   and the microbenchmark's graph needs 4,096 warps at D = 16, under one
//   wave.
// - One store per edge: lane j % GC of the group writes edge j, so the
//   warp's stores of one j fill consecutive words.
// - Deterministic: no atomics; each lane sums its elements in order, then
//   the group's fixed shuffle tree.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 4;  // edges a lane group takes at a time

// this lane's piece of a row: W elements from p (the row's element c), n =
// d - c > 0 of them in the row, the rest 0; one float4 when V = 4 (W = 4,
// d a multiple of 4), else W scalar loads
template <int V, int W>
__device__ __forceinline__ void load_piece(const float* p, int n,
                                           float (&x)[W]) {
  if constexpr (V == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = i < n ? p[i] : 0.0f;
  }
}

// V elements a load (4: float4, rows 16-byte aligned; 1: scalar), W
// elements a lane covers a chunk, GC lanes an edge
template <int V, int W, int GC>
__global__ void __launch_bounds__(kThreads)
edge_dot_f32(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int64_t n_edges, int d) {
  constexpr int NG = 32 / GC;                     // lane groups a warp
  constexpr int kWarpEdges = NG * kBatch;         // edges a warp
  constexpr int kHeld = (kBatch + GC - 1) / GC;   // index pairs a lane loads
  const int lane = threadIdx.x % 32;
  const int q = lane / GC;  // this lane's group
  const int s = lane % GC;  // its place in the group
  // edge j of group q is base + j * NG + q
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32 *
      kWarpEdges;
  if (base >= n_edges) return;  // the whole warp
  // every edge's index pair loaded once: lane l takes edges base + m*32 + l
  int held_src[kHeld], held_dst[kHeld];
#pragma unroll
  for (int m = 0; m < kHeld; ++m) {
    const int k = m * 32 + lane;
    const bool ok = k < kWarpEdges && base + k < n_edges;
    held_src[m] = ok ? src[base + k] : 0;
    held_dst[m] = ok ? dst[base + k] : 0;
  }
  // edge j of group q (warp offset j * NG + q) sits in lane j % GC * NG + q,
  // slot j / GC
  int es[kBatch], ed[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    es[j] = __shfl_sync(~0u, held_src[j / GC], j % GC * NG + q);
    ed[j] = __shfl_sync(~0u, held_dst[j / GC], j % GC * NG + q);
  }
  float acc[kBatch] = {};
  // the loop runs alike in every lane of the warp (the shuffles need all of
  // them); lanes past D or past the last edge load nothing
  for (int c0 = 0; c0 < d; c0 += GC * W) {
    const int c = c0 + s * W;
    float x[kBatch][W], y[kBatch][W];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c < d && base + j * NG + q < n_edges) {
        load_piece<V>(a + static_cast<int64_t>(es[j]) * d + c, d - c, x[j]);
        load_piece<V>(b + static_cast<int64_t>(ed[j]) * d + c, d - c, y[j]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) x[j][i] = y[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[j] = fmaf(x[j][i], y[j][i], acc[j]);
    }
  }
#pragma unroll
  for (int off = GC / 2; off > 0; off /= 2) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      acc[j] += __shfl_xor_sync(~0u, acc[j], off);
    }
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int64_t e = base + j * NG + q;
    if (s == j % GC && e < n_edges) out[e] = acc[j];
  }
}

// every instantiation of edge_dot_f32 has this signature
using Kernel = void (*)(const int32_t*, const int32_t*, const float*,
                        const float*, float*, int64_t, int);

// the instantiation of GC = lanes (1, 2, 4, ..., 32), or nullptr
template <int V, int W>
Kernel with_lanes(int lanes) {
  switch (lanes) {
    case 1:
      return edge_dot_f32<V, W, 1>;
    case 2:
      return edge_dot_f32<V, W, 2>;
    case 4:
      return edge_dot_f32<V, W, 4>;
    case 8:
      return edge_dot_f32<V, W, 8>;
    case 16:
      return edge_dot_f32<V, W, 16>;
    case 32:
      return edge_dot_f32<V, W, 32>;
    default:
      return nullptr;
  }
}

// the instantiation for `vec` and `lanes` at width d, or nullptr: a float4
// lane covers 4 elements a chunk; a scalar lane 1 where the lanes cover d,
// else (at 32 lanes only) 2 up to d = 64 and 4 beyond
Kernel pick(int vec, int lanes, int d) {
  if (vec == 4) return with_lanes<4, 4>(lanes);
  if (vec != 1) return nullptr;
  if (d <= lanes) return with_lanes<1, 1>(lanes);
  if (lanes != 32) return nullptr;
  return d <= 64 ? edge_dot_f32<1, 2, 32> : edge_dot_f32<1, 4, 32>;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}


// Ring multi-head instantiation (the backward of the GAT layers' attention-
// weighted aggregation, cognn_tpu_torch/mpc/gat.py): per edge and head, over
// rows of d = heads * f ring elements, head-major,
//
//   out[e, h] = sum over k < f of a[src_e, h*f + k] * b[dst_e, h*f + k]
//
// mod 2^64 (uint64_t) or 2^32 (uint32_t), out [n_edges, heads]. The operands
// are reconstructed ring values (a shared x shared product: the engine
// truncates and re-shares the result). Bound by bytes as edge_dot_f32.
//
// A warp takes kBatch edges at a time; each edge's heads are spread over the
// warp, GF lanes a head (the power of two covering f in loads of W
// elements) and 32 / GF heads a pass, so at f = 8 (GF = 4 at W = 2 words)
// one pass covers the 8 heads of a 64-wide row in 16-byte loads, the warp's
// loads of an edge one contiguous 512-byte row; at f = 3 (W = 1, GF = 4) a
// pass covers 8 heads with 24 of the 32 lanes. All lanes load the edges'
// index pairs (one address a warp: one transaction), then issue all of the
// batch's row loads before the products; a butterfly of shuffles over the
// GF lanes sums each head, whose first lane writes it. Deterministic: no
// atomics; ring sums wrap.

template <int W>
struct RingLoad;
template <>
struct RingLoad<1> {
  template <typename T>
  __device__ static void run(const T* p, T (&x)[1]) {
    x[0] = *p;
  }
};
template <>
struct RingLoad<2> {
  __device__ static void run(const uint64_t* p, uint64_t (&x)[2]) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  }
};
template <>
struct RingLoad<4> {
  __device__ static void run(const uint32_t* p, uint32_t (&x)[4]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <typename T, int W, int GF>
__global__ void __launch_bounds__(kThreads)
edge_dot_heads(const int32_t* __restrict__ src,
               const int32_t* __restrict__ dst, const T* __restrict__ a,
               const T* __restrict__ b, T* __restrict__ out, int64_t n_edges,
               int heads, int f) {
  constexpr int HP = 32 / GF;  // heads a pass
  const int lane = threadIdx.x % 32;
  const int hl = lane / GF;  // this lane's head in a pass
  const int k0 = lane % GF * W;  // its first element of the head
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32 *
      kBatch;
  if (base >= n_edges) return;  // the whole warp
  const int d = heads * f;
  int es[kBatch], ed[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool ok = base + j < n_edges;
    es[j] = ok ? src[base + j] : 0;
    ed[j] = ok ? dst[base + j] : 0;
  }
  // the loop runs alike in every lane (the shuffles need all of them)
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int h = h0 + hl;
    const bool live = h < heads && k0 < f;
    const int c = h * f + k0;
    T x[kBatch][W], y[kBatch][W];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (live && base + j < n_edges) {
        RingLoad<W>::run(a + static_cast<int64_t>(es[j]) * d + c, x[j]);
        RingLoad<W>::run(b + static_cast<int64_t>(ed[j]) * d + c, y[j]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) x[j][i] = y[j][i] = T(0);
      }
    }
    T acc[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      acc[j] = T(0);
#pragma unroll
      for (int i = 0; i < W; ++i) acc[j] += x[j][i] * y[j][i];
    }
#pragma unroll
    for (int off = GF / 2; off > 0; off /= 2) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        acc[j] += __shfl_xor_sync(~0u, acc[j], off);
      }
    }
    if (live && k0 == 0) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (base + j < n_edges) out[(base + j) * heads + h] = acc[j];
      }
    }
  }
}

template <typename T, int W>
using HeadsKernel = void (*)(const int32_t*, const int32_t*, const T*,
                             const T*, T*, int64_t, int, int);

// the instantiation of GF = lanes (1, 2, 4, ..., 32), or nullptr
template <typename T, int W>
HeadsKernel<T, W> heads_with_lanes(int lanes) {
  switch (lanes) {
    case 1:
      return edge_dot_heads<T, W, 1>;
    case 2:
      return edge_dot_heads<T, W, 2>;
    case 4:
      return edge_dot_heads<T, W, 4>;
    case 8:
      return edge_dot_heads<T, W, 8>;
    case 16:
      return edge_dot_heads<T, W, 16>;
    case 32:
      return edge_dot_heads<T, W, 32>;
    default:
      return nullptr;
  }
}

// Refuses (cudaErrorInvalidValue) a `lanes` with no instantiation, lanes
// that do not cover f in loads of W, and a vector load that would straddle
// two heads or not be 16-byte aligned at every row start of a and b.
template <typename T, int W>
int launch_heads(int lanes, const int32_t* src, const int32_t* dst,
                 const T* a, const T* b, T* out, int64_t n_edges, int heads,
                 int f, cudaStream_t s) {
  if (heads < 1 || f < 1 || lanes * W < f ||
      (W > 1 && (f % W != 0 || !aligned16(a) || !aligned16(b)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HeadsKernel<T, W> kernel = heads_with_lanes<T, W>(lanes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = (n_edges + kBatch - 1) / kBatch * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, s>>>(src, dst, a, b, out, n_edges, heads,
                                     f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it. a is
// [*, d] and b [*, d]; the kernel reads only the rows the edges name.
// `vec` (1 or 4 floats a load) and `lanes` (1, 2, ..., 32 an edge) pick
// the instantiation (cognn_tpu_torch/ops/sddmm.py `launch_shape`). A pair
// with no instantiation (a scalar row wider than fewer than 32 lanes), and
// a vector load that would not be 16-byte aligned at every row start of a
// and b, are refused (cudaErrorInvalidValue): a misaligned one would fault.
extern "C" int cognn_sddmm_f32(const int32_t* src, const int32_t* dst,
                               const float* a, const float* b, float* out,
                               int64_t n_edges, int d, int vec, int lanes,
                               cudaStream_t stream) {
  if (vec == 4 && (d % 4 != 0 || !aligned16(a) || !aligned16(b))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(vec, lanes, d);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warp_edges = 32 / lanes * kBatch;
  const int64_t threads = (n_edges + warp_edges - 1) / warp_edges * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, stream>>>(src, dst, a, b, out, n_edges, d);
  return static_cast<int>(cudaGetLastError());
}

// The ring multi-head instantiation: a [*, heads * f] and b [*, heads * f]
// int64 ring rows -> out [n_edges, heads]; `vec` is 1 or 2 words a load and
// `lanes` (1, 2, ..., 32) the lanes a head. Same launch contract.
extern "C" int cognn_sddmm_heads_i64(const int32_t* src, const int32_t* dst,
                                     const int64_t* a, const int64_t* b,
                                     int64_t* out, int64_t n_edges,
                                     int heads, int f, int vec, int lanes,
                                     cudaStream_t s) {
  const auto* x = reinterpret_cast<const uint64_t*>(a);
  const auto* y = reinterpret_cast<const uint64_t*>(b);
  auto* z = reinterpret_cast<uint64_t*>(out);
  switch (vec) {
    case 1:
      return launch_heads<uint64_t, 1>(lanes, src, dst, x, y, z, n_edges,
                                       heads, f, s);
    case 2:
      return launch_heads<uint64_t, 2>(lanes, src, dst, x, y, z, n_edges,
                                       heads, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Its 32-bit ring instantiation (RING32); `vec` is 1 or 4 words a load.
extern "C" int cognn_sddmm_heads_i32(const int32_t* src, const int32_t* dst,
                                     const int32_t* a, const int32_t* b,
                                     int32_t* out, int64_t n_edges,
                                     int heads, int f, int vec, int lanes,
                                     cudaStream_t s) {
  const auto* x = reinterpret_cast<const uint32_t*>(a);
  const auto* y = reinterpret_cast<const uint32_t*>(b);
  auto* z = reinterpret_cast<uint32_t*>(out);
  switch (vec) {
    case 1:
      return launch_heads<uint32_t, 1>(lanes, src, dst, x, y, z, n_edges,
                                       heads, f, s);
    case 4:
      return launch_heads<uint32_t, 4>(lanes, src, dst, x, y, z, n_edges,
                                       heads, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
