// Probes of the card for the event model's machine (perf/simcal.py sets
// csrc/perfsim.cpp's SimConfig fields from what they measure). No TPU
// kernel is replaced: these kernels only measure the card.
//
// - chase_kernel: one thread follows a chain of dependent loads through
//   L2 (ld.global.cg, no L1) and times it with clock64(): the latency of
//   one load, in SM cycles, of an address the chain decides. Bound by
//   latency, by design: nothing overlaps one load with the next.
// - noop_kernel: an empty grid; a launch of many blocks against one of
//   a single block gives what a block costs the card beyond its work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase_kernel(const unsigned* __restrict__ next, unsigned start,
                             int steps, int stride, long long* cycles,
                             unsigned* sink) {
  unsigned i = start;
  long long t0 = clock64();
  for (int s = 0; s < steps; ++s) i = __ldcg(next + static_cast<size_t>(i) * stride);
  long long t1 = clock64();
  *cycles = t1 - t0;
  *sink = i;
}

__global__ void noop_kernel() {}

}  // namespace

// next: the chain, entry k at word k * stride; cycles: int64[1]; sink:
// int32[1] (the last index, so the chain cannot be dropped).
extern "C" int simcal_chase(const void* next, unsigned start, int steps, int stride,
                            void* cycles, void* sink, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(next), start, steps, stride,
      static_cast<long long*>(cycles), static_cast<unsigned*>(sink));
  return cudaGetLastError();
}

extern "C" int simcal_noop(int blocks, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  noop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
