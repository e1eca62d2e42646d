// K5: block-ELL SpMM, Y = W·X with W block-sparse and X dense,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_spmm_kernel` of the JAX package
// (ops/pallas/spmm_kernel.py:30, launched by `spmm_blockell_device`).
// W is block-ELL: blocks f32[nrb, max_blocks, bm, bn] and meta
// int32[nrb * max_blocks, 3] = (effective block col, mask, effective
// w-slot) per slot. X is f32[K_pad, N_pad] row-major, Y f32[nrb * bm,
// N_pad]. Row block ib of Y is the sum over its slots s with mask set of
// blocks[ib, slot(s)] @ X[col(s) * bn : col(s) * bn + bn, :]; a row block
// with no valid slot is zero. Full float32: the TPU kernel runs its dots
// at Precision.HIGHEST, so no TF32 and no tensor cores here, only fp32
// FMAs (the parity bar is 1e-6 of max |y|).
//
// Bound on the H100: per valid (row block, slot) pair it does
// 2 * bm * bn * N_pad float32 operations and needs the bm x bn block and
// bn rows of X. With the sparse-NN path's (8, 128) blocks a 1%-dense
// 1000 x 1000 layer stores almost every block, so at batch 1024 the
// operations (~4 GFLOP per MLP forward, ~0.06 ms at 67 TFLOP/s) bound it,
// not the ~28 MB it must move (~0.01 ms at 3.35 TB/s).
//
// Design (simple first): the TPU kernel walks a sequential grid axis over
// slots with the output tile resident in VMEM; here one thread block
// owns one (row block, tn-column tile, 8-row group of bm) output tile and
// loops over the row block's slots itself, skipping masked ones (the
// mask is the same for the whole block, so no divergence). Thread c owns
// output column c of the tile and keeps its 8 rows' sums in registers.
// Per valid slot the block stages the 8 x kc slice of the W block
// (transposed, so one k's 8 weights are two 16-byte words) and kc x tn
// rows of X in shared memory, kc rows at a time (a full 128 x 128 fp32 X
// tile is 64 KB, above the 48 KB static limit), then each thread runs
// kc * 8 FMAs, reading W as 16-byte broadcasts and its X column without
// bank conflicts: 3 shared loads per 8 FMAs. Each X element feeds 8 FMAs only, so the kernel leans
// on L2 for X (every row block re-reads it); blocking several row blocks
// per thread block is the next step, in a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;          // rows of bm per thread block (fixed:
                                  // the inner loop reads them as 2 float4)
constexpr int kMaxTn = 256;       // threads per block = tn
constexpr int kXsFloats = 8192;   // 32 KB: kc x tn staged rows of X
constexpr int kMaxKc = 256;

__global__ void __launch_bounds__(kMaxTn)
spmm_kernel(const int* __restrict__ meta, const float* __restrict__ blocks,
            const float* __restrict__ x, float* __restrict__ y,
            int max_blocks, int bm, int bn, int n_pad, int tn, int kc_max) {
  __shared__ __align__(16) float ws[kMaxKc * kRows];  // [kk][r]
  __shared__ float xs[kXsFloats];                      // [kk][c]
  const int c = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * tn + c;
  const int ib = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, bm - r0);
  const int* m = meta + static_cast<long long>(ib) * max_blocks * 3;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  for (int s = 0; s < max_blocks; ++s) {
    if (m[3 * s + 1] == 0) continue;
    const long long xrow = static_cast<long long>(m[3 * s]) * bn;
    const float* wb =
        blocks +
        ((static_cast<long long>(ib) * max_blocks + m[3 * s + 2]) * bm + r0) * bn;
    for (int k0 = 0; k0 < bn; k0 += kc_max) {
      const int kc = min(kc_max, bn - k0);
      __syncthreads();  // the previous chunk's reads are done
      for (int i = c; i < kRows * kc; i += tn) {
        const int r = i / kc;
        const int kk = i - r * kc;
        ws[kk * kRows + r] =
            r < rows ? wb[static_cast<long long>(r) * bn + k0 + kk] : 0.0f;
      }
      const float* xp = x + (xrow + k0) * n_pad + col;
      for (int kk = 0; kk < kc; ++kk)
        xs[kk * tn + c] = xp[static_cast<long long>(kk) * n_pad];
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        const float xv = xs[kk * tn + c];
        const float4 w0 = *reinterpret_cast<const float4*>(ws + kk * kRows);
        const float4 w1 = *reinterpret_cast<const float4*>(ws + kk * kRows + 4);
        acc[0] = fmaf(w0.x, xv, acc[0]);
        acc[1] = fmaf(w0.y, xv, acc[1]);
        acc[2] = fmaf(w0.z, xv, acc[2]);
        acc[3] = fmaf(w0.w, xv, acc[3]);
        acc[4] = fmaf(w1.x, xv, acc[4]);
        acc[5] = fmaf(w1.y, xv, acc[5]);
        acc[6] = fmaf(w1.z, xv, acc[6]);
        acc[7] = fmaf(w1.w, xv, acc[7]);
      }
    }
  }

  float* yp = y + (static_cast<long long>(ib) * bm + r0) * n_pad + col;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < rows) yp[static_cast<long long>(r) * n_pad] = acc[r];
}

}  // namespace

// Takes tn a multiple of 32 up to 256 and N_pad a multiple of tn (the
// wrapper checks); returns the launch's cudaError_t.
extern "C" int spmm_launch(const int* meta, const float* blocks,
                           const float* x, float* y, int nrb, int max_blocks,
                           int bm, int bn, int n_pad, int tn, int device,
                           void* stream) {
  if (tn <= 0 || tn % 32 || tn > kMaxTn || bn <= 0 || bm <= 0 || n_pad % tn)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int kc_max = kXsFloats / tn;
  if (kc_max > kMaxKc) kc_max = kMaxKc;
  if (kc_max > bn) kc_max = bn;
  const dim3 grid(n_pad / tn, nrb, (bm + kRows - 1) / kRows);
  spmm_kernel<<<grid, tn, 0, static_cast<cudaStream_t>(stream)>>>(
      meta, blocks, x, y, max_blocks, bm, bn, n_pad, tn, kc_max);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
