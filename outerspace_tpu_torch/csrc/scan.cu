// K2: merge epilogue over a sorted biased-key stream, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_scan_kernel` of the JAX package
// (ops/pallas/scan.py:57, launched by `merge_epilogue_scan`). For each
// slot i of a stream sorted by key: the slot is a run's last iff
// key[i] != key[i+1] (or i == N-1); a run-last slot whose key is not the
// sentinel INT32_MAX holds its run's sum, its unpacked (row, col) =
// ((key ^ 2^31) / n, (key ^ 2^31) % n) and valid = 1; every other slot
// holds (sentinel_row, 0, 0, valid = 0). Sentinel slots are the padding
// plus, when m*n == 2^32, the real corner (m-1, n-1), whose key is the
// same bit pattern: their values are summed, and the terminal slot is
// real iff the sentinel count exceeds the host-known pad_count. nnz
// counts the valid slots.
//
// Bound on the H100: it reads 8 B per slot (key, value; the lookahead
// and run sums re-read neighbours from L1/L2) and writes 13 B (row, col,
// value, valid byte), 21 B per slot: ~17 M slots on rmat14 A² is
// ~0.36 GB, ~0.11 ms at 3.35 TB/s.
//
// Design: the TPU kernel carries the run sum, sentinel count and nnz
// across a sequential grid; Hopper blocks run in no order, so nothing is
// carried. One thread per slot: a run-last thread sums its own run
// backwards until the key changes (runs are short: at most the largest
// row nnz of A), so every slot is read by at most two threads and no
// cross-block scan is needed. The sentinel count, sentinel value sum
// and nnz are reduced per block (warp shuffles) and added with atomics
// to a 4-word scratch; a second one-thread launch writes the corner
// slot and the final nnz. Any stream length works (no power-of-two
// chunk constraint).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// scratch words: [0] sentinel count, [1] nnz, [2] sentinel sum (f32 bits)

__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* __restrict__ key, const float* __restrict__ vals,
            int* __restrict__ rows, int* __restrict__ cols,
            float* __restrict__ out_vals, unsigned char* __restrict__ valid,
            int* __restrict__ scratch, int n, unsigned n_cols,
            int sentinel_row) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int sent = 0;
  int live = 0;
  float sent_sum = 0.0f;
  if (i < n) {
    const int k = key[i];
    const bool is_sent = k == INT_MAX;
    const bool is_last = i == n - 1 || key[i + 1] != k;
    int r = sentinel_row;
    int c = 0;
    float v = 0.0f;
    if (is_sent) {
      sent = 1;
      sent_sum = vals[i];
    } else if (is_last) {
      v = vals[i];
      for (int j = i - 1; j >= 0 && key[j] == k; --j) v += vals[j];
      const unsigned ku = static_cast<unsigned>(k) ^ 0x80000000u;
      r = static_cast<int>(ku / n_cols);
      c = static_cast<int>(ku % n_cols);
      live = 1;
    }
    rows[i] = r;
    cols[i] = c;
    out_vals[i] = v;
    valid[i] = static_cast<unsigned char>(live);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sent += __shfl_down_sync(0xffffffffu, sent, off);
    live += __shfl_down_sync(0xffffffffu, live, off);
    sent_sum += __shfl_down_sync(0xffffffffu, sent_sum, off);
  }
  __shared__ int s_sent[kWarps];
  __shared__ int s_live[kWarps];
  __shared__ float s_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sent[warp] = sent;
    s_live[warp] = live;
    s_sum[warp] = sent_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bs = 0, bl = 0;
    float bsum = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      bs += s_sent[w];
      bl += s_live[w];
      bsum += s_sum[w];
    }
    if (bs) {
      atomicAdd(scratch + 0, bs);
      atomicAdd(reinterpret_cast<float*>(scratch + 2), bsum);
    }
    if (bl) atomicAdd(scratch + 1, bl);
  }
}

__global__ void scan_corner_kernel(const int* __restrict__ key,
                                   int* __restrict__ rows,
                                   int* __restrict__ cols,
                                   float* __restrict__ out_vals,
                                   unsigned char* __restrict__ valid,
                                   int* __restrict__ nnz,
                                   const int* __restrict__ scratch, int n,
                                   unsigned n_cols, int pad_count) {
  int total = scratch[1];
  if (n > 0 && key[n - 1] == INT_MAX && scratch[0] > pad_count) {
    const unsigned ku = static_cast<unsigned>(INT_MAX) ^ 0x80000000u;
    rows[n - 1] = static_cast<int>(ku / n_cols);
    cols[n - 1] = static_cast<int>(ku % n_cols);
    out_vals[n - 1] = __int_as_float(scratch[2]);
    valid[n - 1] = 1;
    total += 1;
  }
  *nnz = total;
}

}  // namespace

extern "C" int scan_launch(const int* key, const float* vals, int* rows,
                           int* cols, float* out_vals, unsigned char* valid,
                           int* nnz, int* scratch, int n, int n_cols,
                           int sentinel_row, int pad_count, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, 4 * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    scan_kernel<<<blocks, kThreads, 0, st>>>(
        key, vals, rows, cols, out_vals, valid, scratch, n,
        static_cast<unsigned>(n_cols), sentinel_row);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_corner_kernel<<<1, 1, 0, st>>>(key, rows, cols, out_vals, valid, nnz,
                                      scratch, n,
                                      static_cast<unsigned>(n_cols),
                                      pad_count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
