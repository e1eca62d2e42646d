// K3 and K4: the dense-tile expand, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_expand_kernel_packed` (K3) and
// `_expand_kernel_coords` (K4) of the JAX package
// (ops/pallas/expand.py:45 and :87, launched by `expand_tiles_packed`
// and `expand_tiles_coords`). Same function, same bits: task t of a
// class table holds (a_len, b_block, b_lo, b_hi) and forms the
// tile_a x 128 outer product of its A slice (a_rows_t[t], a_vals_t[t])
// with B block b_block, masked to sub < a_len and b_lo <= lane < b_hi.
// K3 writes the biased key row*n + col - 2^31 (uint32 arithmetic,
// stored as int32) and a*b, or INT32_MAX / 0 where masked; K4 writes
// (row, col, a*b), or (sentinel_row, 0, 0). Output is task-major, then
// sub, then lane.
//
// Bound on the H100: the writes. Each slot costs 8 B (K3) or 12 B (K4)
// of output against at most 16 B of table, tile_a * 8 B of A and 1 KB
// of B read per task of tile_a * 128 slots, and one multiply. So the
// kernel is bound by device-memory bytes, ~20-40 us for the ~8 M slots
// of rmat14_ef8 A^2.
//
// Design: one block per task, 128 threads, one per lane. The Pallas
// kernel fetches 8-row groups of the A slices and B blocks and selects
// its row (TPU layout); here each thread keeps its lane's B column and
// value in registers, the block stages the task's A rows and values in
// shared memory, and the block walks the tile_a subs: each step stores
// 512 contiguous bytes per output array (coalesced). Loads happen only
// where the mask needs them, so padding tasks (a_len = 0) read nothing
// but their table row. One launch covers a whole class; the JAX
// package's slab calls only served executable reuse.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kLanes = 128;  // B lanes per task, one thread each

template <bool kPacked>
__global__ void __launch_bounds__(kLanes)
expand_kernel(const int* __restrict__ tasks,
              const int* __restrict__ a_rows_t,
              const float* __restrict__ a_vals_t,
              const int* __restrict__ b_cols_blk,
              const float* __restrict__ b_vals_blk,
              int* __restrict__ out0,    // K3: keys;  K4: rows
              int* __restrict__ out1,    // K3: unused; K4: cols
              float* __restrict__ vals,
              int tile_a,
              int last) {               // K3: n_cols; K4: sentinel_row
  __shared__ int s_rows[kLanes];
  __shared__ float s_vals[kLanes];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int a_len = tasks[4 * t];
  const int b_block = tasks[4 * t + 1];
  const int b_lo = tasks[4 * t + 2];
  const int b_hi = tasks[4 * t + 3];
  const bool lane_live = a_len > 0 && lane >= b_lo && lane < b_hi;

  int b_col = 0;
  float b_val = 0.0f;
  if (lane_live) {
    const size_t bi = static_cast<size_t>(b_block) * kLanes + lane;
    b_col = __ldg(b_cols_blk + bi);
    b_val = __ldg(b_vals_blk + bi);
  }
  if (lane < min(a_len, tile_a)) {
    const size_t ai = static_cast<size_t>(t) * tile_a + lane;
    s_rows[lane] = __ldg(a_rows_t + ai);
    s_vals[lane] = __ldg(a_vals_t + ai);
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(t) * tile_a * kLanes + lane;
  for (int sub = 0; sub < tile_a; ++sub) {
    const size_t o = base + static_cast<size_t>(sub) * kLanes;
    int r0 = kPacked ? INT_MAX : last;
    int r1 = 0;
    float v = 0.0f;
    if (lane_live && sub < a_len) {
      const int row = s_rows[sub];
      v = __fmul_rn(s_vals[sub], b_val);
      if (kPacked) {
        const unsigned u = static_cast<unsigned>(row) *
                               static_cast<unsigned>(last) +
                           static_cast<unsigned>(b_col) + 0x80000000u;
        r0 = static_cast<int>(u);
      } else {
        r0 = row;
        r1 = b_col;
      }
    }
    out0[o] = r0;
    if (!kPacked) out1[o] = r1;
    vals[o] = v;
  }
}

}  // namespace

extern "C" int expand_packed_launch(const int* tasks, const int* a_rows_t,
                                    const float* a_vals_t,
                                    const int* b_cols_blk,
                                    const float* b_vals_blk, int* keys,
                                    float* vals, int ntasks, int tile_a,
                                    int n_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ntasks > 0) {
    expand_kernel<true><<<ntasks, kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, keys, nullptr,
        vals, tile_a, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int expand_coords_launch(const int* tasks, const int* a_rows_t,
                                    const float* a_vals_t,
                                    const int* b_cols_blk,
                                    const float* b_vals_blk, int* rows,
                                    int* cols, float* vals, int ntasks,
                                    int tile_a, int sentinel_row, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ntasks > 0) {
    expand_kernel<false><<<ntasks, kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, rows, cols, vals,
        tile_a, sentinel_row);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
