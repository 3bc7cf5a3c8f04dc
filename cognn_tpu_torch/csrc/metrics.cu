// The GCN's per-party metrics in one pass over the prediction: for each
// party p of prob [P, V, C] (the softmax of the last layer's logits),
//
//   loss             = sum over valid rows v of -log(prob[p, v, label])
//                      (a probability of exactly 0 taken as 0.001), summed
//                      in float64, over num_local[p], rounded once to f32
//   full_acc         = hits / rows over the valid rows
//   train_acc        = the same over the train rows
//   border_train_acc = over train & border
//   test_acc         = over test = valid & ~train & ~val
//   border_test_acc  = over test & border
//   num_border       = the valid border rows (int64)
//
// where a row's hit is argmax(prob[p, v, :]) == label (the first maximal
// index; a NaN counts as the largest, as torch.argmax has it) and an
// accuracy over no rows is 0. These are the plain metric definitions of
// cognn_tpu_torch/ops/metrics.py `gcn_metrics_plain`, with the same float32
// log and divisions. There a valid row's loss is a one-hot row sum, which
// turns a NaN or an infinity in any column of the row (a negative
// probability too, whose log is NaN) into a NaN term: so does this kernel.
// Both sum the float64 terms of a party, but in different orders; float32
// terms from about 2^-47 to 2^15 do not fit in 53 bits, so the two float64
// sums may differ in their last bits, and equality rests on the one
// rounding to f32 (chip_smoke.py holds it at the cells' shapes).
//
// Replaces no TPU kernel: the JAX package computes these with plain jnp
// ops, which XLA fuses inside the jitted forward and epoch. The port ran
// them as about 55 small PyTorch operations (one-hot, clamp, log, row sum,
// float64 sum, argmax, and two masked int64 sums, a division and a select
// for each accuracy), each a node of the epoch's and the request's CUDA
// graph, for ~0.5 MB of reads on PubMed with 4 parties.
//
// Bound on the H100: neither bytes (prob, the int64 labels and four byte
// masks: 0.5 MB, 0.15 us at 3.35 TB/s) nor the card's operations, but one
// launch and the latency of the loads and of the reduction.
//
// Why a cluster a party and not one block: one block runs a party's rows
// on one SM, whose instruction rate the ~5,000 rows of a PubMed party
// then bound. Of such designs (rows read straight from global memory, their
// loads batched, or staged in shared memory as here) none took less than
// 8.3 us at PubMed's [4, 4936, 3] on an H100 (700 W) against a 1.8 us
// launch floor, and the epoch's `metrics` phase read 12.4 us with the
// staged one; this design takes 6.0 us there (5.3 at Cora's [2, 1360, 7],
// where one block does as well).
//
// Design:
// - A party is a cluster of kCluster blocks of kThreads threads (Hopper's
//   thread block clusters): block b takes the party's rows [b * chunk,
//   (b + 1) * chunk), chunk = ceil(V / kCluster), a contiguous range of
//   prob.
// - A block walks its rows in tiles of at most kThreads * kRows rows and
//   kTileFloats probabilities (so C is at most kTileFloats). The tile of
//   prob is copied into shared memory by all the threads together,
//   coalesced, kStage loads in flight a thread (a thread reading its own
//   rows from global memory would wait a round trip for each
//   probability); each thread's rows of the tile (t, t + kThreads, ...)
//   have their masks and labels loaded meanwhile. Then each thread reads
//   its rows from shared memory: argmax, -log of the label's probability,
//   and the counts.
// - A thread keeps the float64 loss sum and 11 int counts (the rows and
//   the hits of each of the five accuracies, and the valid border rows).
//   A block sums them in a fixed order (in each warp a shuffle tree for
//   the loss and one integer reduction a count, then the warps' sums in
//   warp 0); each block writes its sums into block 0's shared memory
//   (distributed shared memory, between two cluster barriers), and warp 0
//   of block 0 adds the kCluster partial sums, again in a fixed tree, and
//   writes the party's outputs.
// - No atomics: the order of every sum depends on V alone, so a party's
//   metrics are the same whether it is stacked with others ([P, V]) or
//   alone ([1, V], a sharded party). C is read in a loop, not fixed at
//   compile time. Nothing is allocated and nothing synchronises with the
//   host: the launch captures into a CUDA graph as it is.

#include <cfloat>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks a party (the portable cluster size)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;           // rows a thread has in a tile
constexpr int kTileFloats = 8192;  // 32 KB of prob in shared memory
constexpr int kStage = 8;          // loads in flight a thread, staging

// the counts a thread keeps: the rows of each accuracy's set, its hits,
// and the valid border rows
enum : int {
  kValid, kTrain, kTrainBorder, kTest, kTestBorder,
  kHitValid, kHitTrain, kHitTrainBorder, kHitTest, kHitTestBorder,
  kValidBorder, kCounts
};

// the bits of a row's flags
constexpr unsigned kIsValid = 1, kIsTrain = 2, kIsVal = 4, kIsBorder = 8;

struct Sums {
  double loss;
  int n[kCounts];
};

// the sum of lane 0 .. 31's values in lane 0: the loss by a fixed shuffle
// tree, each count by one warp-wide integer reduction (redux.sync)
__device__ __forceinline__ void warp_sum(Sums& s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s.loss += __shfl_down_sync(0xffffffffu, s.loss, off);
  }
#pragma unroll
  for (int k = 0; k < kCounts; ++k) {
    s.n[k] = __reduce_add_sync(0xffffffffu, s.n[k]);
  }
}

// lane < n: sums[lane]; the other lanes zeros
__device__ __forceinline__ Sums lane_sums(const Sums* sums, int lane, int n) {
  Sums s;
  s.loss = 0.0;
#pragma unroll
  for (int k = 0; k < kCounts; ++k) s.n[k] = 0;
  if (lane < n) s = sums[lane];
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gcn_metrics_f32(const float* __restrict__ prob,
                const int64_t* __restrict__ labels,
                const uint8_t* __restrict__ valid,
                const uint8_t* __restrict__ train,
                const uint8_t* __restrict__ val,
                const uint8_t* __restrict__ border,
                const int64_t* __restrict__ num_local, int parties, int v_rows,
                int c_cols, float* __restrict__ out,
                int64_t* __restrict__ num_border) {
  __shared__ float tile[kTileFloats];
  __shared__ Sums warp_sums[kWarps];
  __shared__ Sums block_sums[kCluster];  // block 0's: the cluster's partials

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.y;
  const int64_t first = static_cast<int64_t>(p) * v_rows;  // party's row 0
  const int chunk = (v_rows + kCluster - 1) / kCluster;
  const int r_begin = min(v_rows, rank * chunk);
  const int r_end = min(v_rows, r_begin + chunk);
  const int tile_rows = min(kThreads * kRows, kTileFloats / c_cols);

  Sums s = lane_sums(nullptr, 0, 0);
  for (int t0 = r_begin; t0 < r_end; t0 += tile_rows) {
    const int rows = min(tile_rows, r_end - t0);
    unsigned flags[kRows];
    int64_t label[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = threadIdx.x + r * kThreads;
      flags[r] = 0;
      label[r] = -1;
      if (i < rows) {
        const int64_t g = first + t0 + i;
        flags[r] = (valid[g] ? kIsValid : 0u) | (train[g] ? kIsTrain : 0u) |
                   (val[g] ? kIsVal : 0u) | (border[g] ? kIsBorder : 0u);
        label[r] = labels[g];
      }
    }
    const float* rows_prob =
        prob + (first + t0) * static_cast<int64_t>(c_cols);
    const int n_floats = rows * c_cols;
    for (int i = threadIdx.x; i < n_floats; i += kThreads * kStage) {
      float x[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        if (i + j * kThreads < n_floats) x[j] = rows_prob[i + j * kThreads];
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        if (i + j * kThreads < n_floats) tile[i + j * kThreads] = x[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned f = flags[r];
      const bool is_valid = f & kIsValid, is_train = f & kIsTrain;
      if (!is_valid && !is_train) continue;  // in no set, no loss term
      const bool is_border = f & kIsBorder;
      const bool is_test = is_valid && !is_train && !(f & kIsVal);
      const int64_t y = label[r];
      const float* row = tile + (threadIdx.x + r * kThreads) * c_cols;
      float best = row[0];
      float at_label = 0.0f;
      bool nan_term = false;  // a column whose log is NaN or infinite
      int arg = 0;
      for (int c = 0; c < c_cols; ++c) {
        const float x = row[c];
        // the first maximal index; a NaN counts as the largest
        if (x > best || (x != x && best == best)) {
          best = x;
          arg = c;
        }
        if (c == y) {
          at_label = x;
        } else {
          nan_term |= !(x >= 0.0f && x <= FLT_MAX);
        }
      }
      const bool in_range = y >= 0 && y < c_cols;
      const int hit = in_range && arg == y;
      if (is_valid) {
        // the plain version's one-hot row sum: the label's term, plus 0
        // times the log of every other column, which is NaN where that log
        // is not finite
        float term =
            in_range ? -logf(at_label == 0.0f ? 0.001f : at_label) : 0.0f;
        if (nan_term) term = __int_as_float(0x7fc00000);  // a quiet NaN
        s.loss += static_cast<double>(term);
        s.n[kValid] += 1;
        s.n[kHitValid] += hit;
        s.n[kValidBorder] += is_border;
      }
      if (is_train) {
        s.n[kTrain] += 1;
        s.n[kHitTrain] += hit;
        s.n[kTrainBorder] += is_border;
        s.n[kHitTrainBorder] += hit & is_border;
      }
      if (is_test) {
        s.n[kTest] += 1;
        s.n[kHitTest] += hit;
        s.n[kTestBorder] += is_border;
        s.n[kHitTestBorder] += hit & is_border;
      }
    }
    __syncthreads();  // the tile is read before it is refilled
  }

  // the block's sums: each warp's, then warp 0 adds the kWarps of them
  // and writes them into block 0's shared memory, once every block of the
  // cluster runs
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  warp_sum(s);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  cluster.sync();
  if (warp == 0) {
    s = lane_sums(warp_sums, lane, kWarps);
    warp_sum(s);
    if (lane == 0) *cluster.map_shared_rank(&block_sums[rank], 0) = s;
  }
  cluster.sync();  // every block's sums are in block 0's shared memory
  if (rank != 0 || warp != 0) return;
  s = lane_sums(block_sums, lane, kCluster);
  warp_sum(s);
  if (lane != 0) return;
  // float(hits) / float(rows) in f32, as the plain version's int64 true
  // division computes it; 0 over no rows
  const auto acc = [](int hits, int rows) {
    return rows > 0 ? static_cast<float>(hits) / static_cast<float>(rows)
                    : 0.0f;
  };
  const int* n = s.n;
  out[p] = static_cast<float>(s.loss / static_cast<double>(num_local[p]));
  out[parties + p] = acc(n[kHitValid], n[kValid]);
  out[2 * parties + p] = acc(n[kHitTrain], n[kTrain]);
  out[3 * parties + p] = acc(n[kHitTrainBorder], n[kTrainBorder]);
  out[4 * parties + p] = acc(n[kHitTest], n[kTest]);
  out[5 * parties + p] = acc(n[kHitTestBorder], n[kTestBorder]);
  num_border[p] = n[kValidBorder];
}

static_assert(kWarps <= 32 && kCluster <= 32,
              "warp 0 adds one partial sum a lane");

}  // namespace

// prob [parties, v, c] f32, labels [parties, v] int64, the four masks
// [parties, v] bool (one byte each, 0 or 1), num_local [parties] int64, all
// contiguous on the current device; out [6, parties] f32 (loss and the five
// accuracies), num_border [parties] int64. Returns the launch's CUDA error.
extern "C" int cognn_gcn_metrics_f32(const float* prob, const int64_t* labels,
                                     const uint8_t* valid,
                                     const uint8_t* train, const uint8_t* val,
                                     const uint8_t* border,
                                     const int64_t* num_local, int parties,
                                     int v, int c, float* out,
                                     int64_t* num_border,
                                     cudaStream_t stream) {
  if (parties <= 0 || parties > 65535 || v < 0 || c <= 0 ||
      c > kTileFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gcn_metrics_f32<<<dim3(kCluster, parties), kThreads, 0, stream>>>(
      prob, labels, valid, train, val, border, num_local, parties, v, c, out,
      num_border);
  return static_cast<int>(cudaGetLastError());
}
