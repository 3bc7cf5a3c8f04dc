// The device clock of the port's tracer
// (cognn_tpu_torch/utils/logging_utils.py): at each phase boundary on the card, one thread writes %globaltimer (the
// card's nanosecond clock, 32 ns ticks on the H100) into a slot of pinned
// host memory, which the host reads once the caller has synchronised.
//
// Captured into a CUDA graph it is one kernel node, which each replay runs
// again, so a replay's boundaries overwrite the capture's slots. A timing
// event recorded in a graph (cudaEventRecordExternal) does the same job
// at about 3.6 us a node on the H100 against 0.8 us for this kernel (200
// boundaries between 200 one-element kernels, 50 replays): an epoch has
// some 170 boundaries.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void stamp_globaltimer(uint64_t* slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

extern "C" int cognn_stamp(uint64_t* slot, cudaStream_t stream) {
  stamp_globaltimer<<<1, 1, 0, stream>>>(slot);
  return static_cast<int>(cudaGetLastError());
}
