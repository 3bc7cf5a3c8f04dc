// Destination-sorted CSR gather-sum on f32 rows and on int64 or int32 ring
// shares: the neighborhood aggregation U = A^T * H of the GAS engines.
//
//   out[s, d, :] = sum over e in [indptr[d], indptr[d+1]) of
//                  counts[e] * h[s, indices[e], :]
//
// Replaces the TPU kernels cognn_tpu/ops/pallas_spmm.py `_kernel` (one
// 128x128 block per grid step) and `_tiled_kernel` (G blocks per step over
// supertiles). Both compute this function over dense 128x128 blocks of A,
// which on a 0.1%-dense graph are almost all zeros; here A is stored as
// one (source, count) entry per distinct edge.
//
// Ring instantiation (csr_gather_sum<uint64_t, 2, ...>): the same function
// on the two additive shares in Z_2^64, the share instantiation of the same
// two TPU kernels (cognn_tpu/mpc/engine.py `_bcsr_agg_shares` sends byte
// planes of uint32 limbs through them as int8 or bf16 values and
// recombines the planes with carries, under multiplicity and in-degree
// exactness guards). Here the rows are int64 shares summed in uint64_t,
// where wrapping is defined and IS the ring's addition, with int64 edge
// counts multiplied in: exact for any multiplicity and degree, so no guard
// is needed. The 32-bit ring (RING32) is csr_gather_sum<uint32_t, 2, ...>:
// int32 shares and counts summed in uint32_t (signed overflow is undefined
// in C++, unsigned wraps mod 2^32), 16-byte loads of 4 words.
//
// Bound on the H100: bytes. Each destination row reads its CSR entries and
// the D-wide rows of its sources and writes one D-wide row: one multiply-add
// per element of H read, far below the card's op/byte balance. The
// compulsory traffic is the CSR once, H once and out once. On the engines'
// graphs (mean in-degree 4-7, D = 16 or the label width 3-7) that traffic is
// a few hundred KB to a few MB, so a call costs its launch, the chain of
// dependent loads each row walks (indptr, then its entries, then the H rows
// they name), and the gathers' traffic from L2: each H row is read once
// per entry that names it, in-degree times H in all. PERF.md §6 times the
// parts by removing each (cognn_tpu_torch/tools/sweep_spmm.py).
//
// What the first design lost (one warp per row, lanes over features, each
// lane walking the row's entries one by one): most lanes idle at D <= 16;
// two dependent loads per entry (its index, then its H row), so a row cost
// about twice its degree in load latencies; the ring put the share on
// blockIdx.y and read every CSR entry twice; all loads 4 or 8 bytes wide.
//
// This design:
// - A row belongs to a group of GC * GE lanes: GC lanes across the row, the
//   power of two that covers D in loads of V elements (at most 32), times
//   GE entry slots side by side (2 wherever the group still fits a warp),
//   so a warp walks 32 / (GC * GE) rows at once and no lane is idle when D
//   fills its GC lanes (f32 D = 16: 4 lanes x float4; ring D = 16: 8 lanes
//   x 16 bytes a share; D = 7: 8 lanes, one idle). A row wider than 32
//   loads is cut into chunks of 32 loads, one for each block row along
//   blockIdx.y (the unopt layer-0 aggregation at the input width: f32
//   D = 500 4 chunks, D = 1433 45; ring 8 and 45), so a row's chunks run
//   in parallel: one group walking them in turn leaves too few loads in
//   flight (f32 D = 1433 on Cora: 16% of its bound, PERF.md §6). As the
//   blocks are dispatched chunk by chunk, the sources' slices of one chunk
//   (20 MB for PubMed's ring shares, whose whole 158 MB exceeds L2) are
//   what L2 holds at a time. Every chunk walks the row's entries again,
//   from L1 or L2.
// - A row's entries go in batches of GE * kBatch: slot s takes entries
//   b + j * GE + s. Each lane loads its slot's (index, count) pairs (the
//   lanes of a slot read the same words: one transaction), then issues all
//   of the batch's H loads before it sums any, so kBatch gathers are in
//   flight per lane and a batch costs two load latencies, not 2 * kBatch.
//   Longer rows loop over batches (correct at any degree; hubs are not the
//   target). At the end the slots' sums meet in a fixed __shfl_xor_sync
//   tree. (Coalesced loads by the whole group, then __shfl_sync to each
//   slot, measured no faster; PERF.md §6.)
// - Ring: one group sums a row in both shares, one CSR read feeding two
//   independent H loads (share stride n_src * D).
// - 16-byte loads (V = 16 / sizeof(elem)) only where every row start is
//   16-byte aligned; the wrapper checks the pointers, D and the share
//   strides and otherwise picks the scalar instantiation (V = 1).
// - Deterministic and exact: no atomics, no shared memory; each row is
//   written once by its group (zero for no entries), f32 sums run in a
//   fixed order (each slot in entry order, then the slots' tree), ring sums
//   wrap in uint64_t.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Chosen on the card against 256 threads a block, 8 entries a slot and 1
// slot a row (PERF.md §6).
constexpr int kThreads = 128;
constexpr int kBatch = 4;  // entries a slot takes at a time
// entry slots a row: 2 wherever the group still fits a warp
template <int GC>
constexpr int kSlots = GC < 32 ? 2 : 1;

__device__ __forceinline__ void load_row(const float* p, float (&x)[1]) {
  x[0] = *p;
}
__device__ __forceinline__ void load_row(const float* p, float (&x)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}
__device__ __forceinline__ void load_row(const uint64_t* p,
                                         uint64_t (&x)[1]) {
  x[0] = *p;
}
__device__ __forceinline__ void load_row(const uint64_t* p,
                                         uint64_t (&x)[2]) {
  const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p);
  x[0] = w.x;
  x[1] = w.y;
}
__device__ __forceinline__ void load_row(const uint32_t* p,
                                         uint32_t (&x)[1]) {
  x[0] = *p;
}
__device__ __forceinline__ void load_row(const uint32_t* p,
                                         uint32_t (&x)[4]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}
__device__ __forceinline__ void store_row(float* p, const float (&x)[1]) {
  *p = x[0];
}
__device__ __forceinline__ void store_row(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_row(uint64_t* p,
                                          const uint64_t (&x)[1]) {
  *p = x[0];
}
__device__ __forceinline__ void store_row(uint64_t* p,
                                          const uint64_t (&x)[2]) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(x[0], x[1]);
}
__device__ __forceinline__ void store_row(uint32_t* p,
                                          const uint32_t (&x)[1]) {
  *p = x[0];
}
__device__ __forceinline__ void store_row(uint32_t* p,
                                          const uint32_t (&x)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
}

// S shares (h and out each [S, rows, d], share strides h_share and
// out_share elements); a row's group is GE entry slots of GC lanes, each
// lane loading V elements at once.
template <typename T, int S, int V, int GC>
__global__ void __launch_bounds__(kThreads)
csr_gather_sum(const int32_t* __restrict__ indptr,
               const int32_t* __restrict__ indices,
               const T* __restrict__ counts, const T* __restrict__ h,
               T* __restrict__ out, int64_t h_share, int64_t out_share,
               int n_dst, int d) {
  constexpr int GE = kSlots<GC>;
  constexpr int G = GC * GE;              // lanes a row
  constexpr int kRowBatch = GE * kBatch;  // entries a row takes at a time
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (row >= n_dst) return;  // the whole group: row is the same in it
  const int g = threadIdx.x % G;
  const int slot = g / GC;
  const unsigned group = (G == 32 ? ~0u : (1u << G % 32) - 1u)
                         << (threadIdx.x % 32 / G * G);
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  // the loops run alike in every lane of the group (the shuffles need all
  // of them); lanes past D load and store nothing. Block row blockIdx.y
  // takes every gridDim.y-th chunk of the row.
  for (int c0 = static_cast<int>(blockIdx.y) * (GC * V); c0 < d;
       c0 += static_cast<int>(gridDim.y) * (GC * V)) {
    const int c = c0 + g % GC * V;
    const bool live = c < d;
    T acc[S][V] = {};
    for (int b = beg; b < end; b += kRowBatch) {
      // this lane's slot takes entries b + j * GE + slot, j < kBatch
      // (the lanes of a slot load the same words: one transaction)
      int src[kBatch];
      T w[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = b + j * GE + slot;
        src[j] = e < end ? indices[e] : 0;
        w[j] = e < end ? counts[e] : T(0);
      }
      T x[kBatch][S][V];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (live && b + j * GE + slot < end) {
          const T* p = h + static_cast<int64_t>(src[j]) * d + c;
#pragma unroll
          for (int s = 0; s < S; ++s) load_row(p + s * h_share, x[j][s]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (live && b + j * GE + slot < end) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[s][v] += w[j] * x[j][s][v];
          }
        }
      }
    }
    // the slots' partial sums, in a fixed tree
#pragma unroll
    for (int off = GC; off < G; off *= 2) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[s][v] += __shfl_xor_sync(group, acc[s][v], off, G);
        }
      }
    }
    if (live && slot == 0) {
      T* p = out + row * d + c;
#pragma unroll
      for (int s = 0; s < S; ++s) store_row(p + s * out_share, acc[s]);
    }
  }
}

template <typename T, int S, int V, int GC>
int launch(const int32_t* indptr, const int32_t* indices, const T* counts,
           const T* h, T* out, int64_t h_share, int64_t out_share, int n_dst,
           int d, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(n_dst) * GC * kSlots<GC>;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  // a block row for each chunk of GC * V elements (one at D <= 16);
  // gridDim.y stops at 65535, and the kernel strides over chunks beyond
  const int chunks = (d + GC * V - 1) / (GC * V);
  const dim3 grid(blocks, chunks < 1 ? 1 : chunks > 65535 ? 65535 : chunks);
  csr_gather_sum<T, S, V, GC><<<grid, kThreads, 0, stream>>>(
      indptr, indices, counts, h, out, h_share, out_share, n_dst, d);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The instantiation for `vec` elements a load and `lanes` (GC) lanes across
// the row, which the wrapper picks (cognn_tpu_torch/ops/spmm.py
// `launch_shape`). Refuses (cudaErrorInvalidValue) a `lanes` with no
// instantiation, and a vector load that would not be 16-byte aligned at
// every row start of h and out: a misaligned one would fault.
template <typename T, int S, int V>
int dispatch(int lanes, const int32_t* indptr, const int32_t* indices,
             const T* counts, const T* h, T* out, int64_t h_share,
             int64_t out_share, int n_dst, int d, cudaStream_t stream) {
  if (V > 1 && (d % V != 0 || h_share % V != 0 || out_share % V != 0 ||
                !aligned16(h) || !aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (lanes) {
    case 1:
      return launch<T, S, V, 1>(indptr, indices, counts, h, out, h_share,
                                out_share, n_dst, d, stream);
    case 2:
      return launch<T, S, V, 2>(indptr, indices, counts, h, out, h_share,
                                out_share, n_dst, d, stream);
    case 4:
      return launch<T, S, V, 4>(indptr, indices, counts, h, out, h_share,
                                out_share, n_dst, d, stream);
    case 8:
      return launch<T, S, V, 8>(indptr, indices, counts, h, out, h_share,
                                out_share, n_dst, d, stream);
    case 16:
      return launch<T, S, V, 16>(indptr, indices, counts, h, out, h_share,
                                 out_share, n_dst, d, stream);
    case 32:
      return launch<T, S, V, 32>(indptr, indices, counts, h, out, h_share,
                                 out_share, n_dst, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// Attention-weighted instantiation (the GAT layers of cognn_tpu_torch/mpc/
// gat.py): one ring tensor, not two shares, and a ring weight an entry and
// a head in place of the count. Rows are d = heads * f elements, head-major:
//
//   out[d_row, c] = sum over e in [indptr[d_row], indptr[d_row+1]) of
//                   w[e, c / f] * h[indices[e], c]        (mod 2^64 or 2^32)
//
// The weights are the reconstructed attention coefficients and h the
// reconstructed values of the layer (a shared x shared product: the engine
// truncates and re-shares the result, as it does K3's). One entry an edge
// (a repeated edge is two entries), so the CSR has no counts. No TPU kernel
// is replaced: the JAX package has no attention model (its K5,
// cognn_tpu/ops/pallas_sddmm.py, was written for one).
//
// Bound on the H100: bytes, as csr_gather_sum: each entry reads its index,
// its H weights and the d-wide row it names, and a row writes d elements;
// 3 IMADs a 64-bit multiply-add (1 at 32 bits) stay far under the bytes'
// time. The design is csr_gather_sum's (groups of GC lanes across the row,
// GE entry slots, batches of kBatch entries whose loads are all issued
// before any sum, a fixed shuffle tree over the slots, no atomics), with
// S = 1 and each element's weight loaded beside its row element: an entry's
// H weights are one 64-byte line (H = 8), read by every lane of the group.

template <typename T, int V, int GC>
__global__ void __launch_bounds__(kThreads)
csr_gather_wsum(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ w, const T* __restrict__ h,
                T* __restrict__ out, int n_dst, int heads, int f) {
  constexpr int GE = kSlots<GC>;
  constexpr int G = GC * GE;
  constexpr int kRowBatch = GE * kBatch;
  const int d = heads * f;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (row >= n_dst) return;  // the whole group
  const int g = threadIdx.x % G;
  const int slot = g / GC;
  const unsigned group = (G == 32 ? ~0u : (1u << G % 32) - 1u)
                         << (threadIdx.x % 32 / G * G);
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int c0 = static_cast<int>(blockIdx.y) * (GC * V); c0 < d;
       c0 += static_cast<int>(gridDim.y) * (GC * V)) {
    const int c = c0 + g % GC * V;
    const bool live = c < d;
    int head[V];
#pragma unroll
    for (int v = 0; v < V; ++v) head[v] = live ? (c + v) / f : 0;
    T acc[V] = {};
    for (int b = beg; b < end; b += kRowBatch) {
      int src[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = b + j * GE + slot;
        src[j] = e < end ? indices[e] : 0;
      }
      T x[kBatch][V], a[kBatch][V];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = b + j * GE + slot;
        if (live && e < end) {
          load_row(h + static_cast<int64_t>(src[j]) * d + c, x[j]);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            a[j][v] = w[static_cast<int64_t>(e) * heads + head[v]];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (live && b + j * GE + slot < end) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += a[j][v] * x[j][v];
        }
      }
    }
#pragma unroll
    for (int off = GC; off < G; off *= 2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[v] += __shfl_xor_sync(group, acc[v], off, G);
      }
    }
    if (live && slot == 0) store_row(out + row * d + c, acc);
  }
}

template <typename T, int V, int GC>
int launch_wsum(const int32_t* indptr, const int32_t* indices, const T* w,
                const T* h, T* out, int n_dst, int heads, int f,
                cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(n_dst) * GC * kSlots<GC>;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const int chunks = (heads * f + GC * V - 1) / (GC * V);
  const dim3 grid(blocks, chunks < 1 ? 1 : chunks > 65535 ? 65535 : chunks);
  csr_gather_wsum<T, V, GC><<<grid, kThreads, 0, stream>>>(
      indptr, indices, w, h, out, n_dst, heads, f);
  return static_cast<int>(cudaGetLastError());
}

// As dispatch: the instantiation for `lanes`, refusing a vector load that
// would not be 16-byte aligned at every row start of h and out.
template <typename T, int V>
int dispatch_wsum(int lanes, const int32_t* indptr, const int32_t* indices,
                  const T* w, const T* h, T* out, int n_dst, int heads,
                  int f, cudaStream_t stream) {
  if (heads < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (V > 1 &&
      ((heads * f) % V != 0 || !aligned16(h) || !aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (lanes) {
    case 1:
      return launch_wsum<T, V, 1>(indptr, indices, w, h, out, n_dst, heads,
                                  f, stream);
    case 2:
      return launch_wsum<T, V, 2>(indptr, indices, w, h, out, n_dst, heads,
                                  f, stream);
    case 4:
      return launch_wsum<T, V, 4>(indptr, indices, w, h, out, n_dst, heads,
                                  f, stream);
    case 8:
      return launch_wsum<T, V, 8>(indptr, indices, w, h, out, n_dst, heads,
                                  f, stream);
    case 16:
      return launch_wsum<T, V, 16>(indptr, indices, w, h, out, n_dst, heads,
                                   f, stream);
    case 32:
      return launch_wsum<T, V, 32>(indptr, indices, w, h, out, n_dst, heads,
                                   f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the CUDA
// runtime refuses never runs, and only this return value reports it.
// `vec` (1 or 4 floats a load) and `lanes` (1, 2, ..., 32 across the row)
// pick the instantiation.
extern "C" int cognn_spmm_csr_f32(const int32_t* indptr,
                                  const int32_t* indices,
                                  const float* counts, const float* h,
                                  float* out, int n_dst, int d, int vec,
                                  int lanes, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return dispatch<float, 1, 1>(lanes, indptr, indices, counts, h, out, 0,
                                   0, n_dst, d, stream);
    case 4:
      return dispatch<float, 1, 4>(lanes, indptr, indices, counts, h, out, 0,
                                   0, n_dst, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The ring instantiation over the 2 shares stacked [2, n_src, d] rows into
// [2, n_dst, d]; `vec` is 1 or 2 words a load; same launch contract.
extern "C" int cognn_spmm_csr_i64(const int32_t* indptr,
                                  const int32_t* indices,
                                  const int64_t* counts, const int64_t* h,
                                  int64_t* out, int shares, int n_src,
                                  int n_dst, int d, int vec, int lanes,
                                  cudaStream_t stream) {
  if (shares != 2) return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = reinterpret_cast<const uint64_t*>(counts);
  const auto* x = reinterpret_cast<const uint64_t*>(h);
  auto* y = reinterpret_cast<uint64_t*>(out);
  const int64_t h_share = static_cast<int64_t>(n_src) * d;
  const int64_t out_share = static_cast<int64_t>(n_dst) * d;
  switch (vec) {
    case 1:
      return dispatch<uint64_t, 2, 1>(lanes, indptr, indices, c, x, y,
                                      h_share, out_share, n_dst, d, stream);
    case 2:
      return dispatch<uint64_t, 2, 2>(lanes, indptr, indices, c, x, y,
                                      h_share, out_share, n_dst, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The 32-bit ring instantiation (RING32) over the 2 shares stacked
// [2, n_src, d] rows into [2, n_dst, d], counts int32; `vec` is 1 or 4 words
// a load; same launch contract.
extern "C" int cognn_spmm_csr_i32(const int32_t* indptr,
                                  const int32_t* indices,
                                  const int32_t* counts, const int32_t* h,
                                  int32_t* out, int shares, int n_src,
                                  int n_dst, int d, int vec, int lanes,
                                  cudaStream_t stream) {
  if (shares != 2) return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = reinterpret_cast<const uint32_t*>(counts);
  const auto* x = reinterpret_cast<const uint32_t*>(h);
  auto* y = reinterpret_cast<uint32_t*>(out);
  const int64_t h_share = static_cast<int64_t>(n_src) * d;
  const int64_t out_share = static_cast<int64_t>(n_dst) * d;
  switch (vec) {
    case 1:
      return dispatch<uint32_t, 2, 1>(lanes, indptr, indices, c, x, y,
                                      h_share, out_share, n_dst, d, stream);
    case 4:
      return dispatch<uint32_t, 2, 4>(lanes, indptr, indices, c, x, y,
                                      h_share, out_share, n_dst, d, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The attention-weighted instantiation over one ring tensor h [*, heads * f]
// rows into out [n_dst, heads * f], weights w [entries, heads]; `vec` is 1
// or 2 words a load; same launch contract.
extern "C" int cognn_spmm_csr_wsum_i64(const int32_t* indptr,
                                       const int32_t* indices,
                                       const int64_t* w, const int64_t* h,
                                       int64_t* out, int n_dst, int heads,
                                       int f, int vec, int lanes,
                                       cudaStream_t stream) {
  const auto* a = reinterpret_cast<const uint64_t*>(w);
  const auto* x = reinterpret_cast<const uint64_t*>(h);
  auto* y = reinterpret_cast<uint64_t*>(out);
  switch (vec) {
    case 1:
      return dispatch_wsum<uint64_t, 1>(lanes, indptr, indices, a, x, y,
                                        n_dst, heads, f, stream);
    case 2:
      return dispatch_wsum<uint64_t, 2>(lanes, indptr, indices, a, x, y,
                                        n_dst, heads, f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Its 32-bit ring instantiation (RING32); `vec` is 1 or 4 words a load.
extern "C" int cognn_spmm_csr_wsum_i32(const int32_t* indptr,
                                       const int32_t* indices,
                                       const int32_t* w, const int32_t* h,
                                       int32_t* out, int n_dst, int heads,
                                       int f, int vec, int lanes,
                                       cudaStream_t stream) {
  const auto* a = reinterpret_cast<const uint32_t*>(w);
  const auto* x = reinterpret_cast<const uint32_t*>(h);
  auto* y = reinterpret_cast<uint32_t*>(out);
  switch (vec) {
    case 1:
      return dispatch_wsum<uint32_t, 1>(lanes, indptr, indices, a, x, y,
                                        n_dst, heads, f, stream);
    case 4:
      return dispatch_wsum<uint32_t, 4>(lanes, indptr, indices, a, x, y,
                                        n_dst, heads, f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
