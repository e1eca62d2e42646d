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
// Divergence by design: the kernel never reads an X row that no nonzero
// weight of its 8-row group needs, so a NaN or Inf in such a row does not
// reach Y. On the TPU, and in the plain version, 0 * NaN = NaN reaches
// the sum. For finite X the results are the same.
//
// What bounds it on the H100: the sparse-NN weights are pruned to ~1%,
// and an (8, 128) block keeps only 5-10% of its columns k nonempty. The
// work these inputs need is the valid stored blocks, the X rows some
// nonzero weight needs (read once), Y, and 2 fp32 operations per weight
// nonzero and column: a few to a few tens of MB, so bytes bound it
// (~0.008 ms for an MLP1w b1024 forward at 3.35 TB/s). A kernel that
// multiplies every stored block by all bn rows of X does 10-20x that work
// and reads every X row of every stored block through L2; the nominal
// count 2 * bm * bn * N_pad per valid slot is no floor for this design.
//
// Design: one thread block of 128 threads owns one (row block, 256-column
// tile, 8-row group of bm) output tile; each thread owns 2 consecutive
// columns and keeps their 8 rows' sums in 16 registers. The block walks
// its row block's (slot, k) pairs in order, 512 at a time: each thread
// reads the 8 weights of 4 columns k (coalesced across the warp), a
// __ballot_sync per warp and a __popc prefix over the warps pack the
// nonempty columns, in order, into a list in shared memory: their 8
// weights (two float4) and their X row. Masked slots add nothing. When
// the list holds 512 entries or more (or the row block is done) every
// thread walks it: 16 X loads in flight as 8-byte float2 words straight
// through L1/L2, then 8 FMAs per column for each entry, the weights read
// as two broadcast float4s. A dense block degrades to one FMA chain per
// X element, as a plain tiled product. The sums run in the same order as
// the plain slot loop (slots in order, k ascending), minus terms that are
// exactly 0. The ragged column edge is masked (N_pad is a multiple of 32
// only); where X or Y do not allow 8-byte access, the same kernel runs
// with scalar loads and stores. At these sizes the kernel waits on
// latency chains (meta, then weights, then X, per round), not on memory:
// measured on the H100 over the 8 sparse-NN layers, 128 threads x 2
// columns with 16 loads in flight beat 64 x 4 with 8 by 24%, and more
// columns per thread, fewer or more threads, or more pairs per round did
// not help.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 8;                  // rows of bm per thread block (two
                                          // float4 weights per list entry)
constexpr int kThreads = 128;             // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 2;                  // consecutive columns per thread
constexpr int kTile = kThreads * kCols;   // 256 columns per block
constexpr int kCand = 4;                  // (slot, k) pairs per thread per round
constexpr int kRound = kThreads * kCand;  // pairs examined per build round
constexpr int kCap = 1024;                // list entries (36 KB of shared memory)
constexpr int kUnroll = 16;               // X loads in flight per thread
constexpr int kMaxTn = 256;               // the wrapper's column tile limit
constexpr unsigned kFull = 0xffffffffu;

// a thread's kCols consecutive floats at p: one 16- or 8-byte word where
// kVec says p allows it, else scalars
template <bool kVec>
__device__ __forceinline__ void load_cols(float (&v)[kCols], const float* p) {
  if constexpr (kVec && kCols == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (kVec && kCols == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = __ldg(p + c);
  }
}

template <bool kVec>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[kCols]) {
  if constexpr (kVec && kCols == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec && kCols == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) p[c] = v[c];
  }
}

__device__ __forceinline__ void fma_entry(float (&acc)[kRows][kCols], float4 wa,
                                          float4 wb, const float (&xv)[kCols]) {
  const float w[kRows] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(w[r], xv[c], acc[r][c]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int* __restrict__ meta, const float* __restrict__ blocks,
            const float* __restrict__ x, float* __restrict__ y,
            int max_blocks, int bm, int bn, int n_pad) {
  __shared__ float4 lw[2 * kCap];  // entry e's weights: rows 0-3, rows 4-7
  __shared__ int lx[kCap];         // entry e's X row
  __shared__ int counts[kCand * kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * kTile + tid * kCols;
  const bool live = col < n_pad;  // kCols | n_pad: all columns in or out
  const int ib = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, bm - r0);
  const int* m = meta + static_cast<long long>(ib) * max_blocks * 3;
  const float* wrow =
      blocks + (static_cast<long long>(ib) * max_blocks * bm + r0) * bn;
  const int npairs = max_blocks * bn;
  const unsigned below = (1u << lane) - 1u;

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;

  int p0 = 0;
  while (p0 < npairs) {
    // build: append the nonempty columns of the next pairs, in order
    int count = 0;
    while (p0 < npairs && count <= kCap - kRound) {
      float w[kCand][kRows];
      int xrow[kCand];
      bool nz[kCand];
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        const int p = p0 + j * kThreads + tid;
        xrow[j] = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) w[j][r] = 0.0f;
        if (p < npairs) {
          const int s = p / bn;
          const int k = p - s * bn;
          if (m[3 * s + 1] != 0) {
            const float* wb =
                wrow + static_cast<long long>(m[3 * s + 2]) * bm * bn + k;
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              if (r < rows) w[j][r] = wb[static_cast<long long>(r) * bn];
            xrow[j] = m[3 * s] * bn + k;
          }
        }
        nz[j] = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) nz[j] = nz[j] || w[j][r] != 0.0f;
      }
      int rank[kCand];
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        const unsigned b = __ballot_sync(kFull, nz[j]);
        rank[j] = __popc(b & below);
        if (lane == 0) counts[j * kWarps + warp] = __popc(b);
      }
      __syncthreads();
      // pair p0 + j * kThreads + tid: order is j, then warp, then lane
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        int mine = count;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          const int cq = counts[j * kWarps + q];
          if (q < warp) mine += cq;
          count += cq;
        }
        if (nz[j]) {
          const int e = mine + rank[j];
          lw[2 * e] = make_float4(w[j][0], w[j][1], w[j][2], w[j][3]);
          lw[2 * e + 1] = make_float4(w[j][4], w[j][5], w[j][6], w[j][7]);
          lx[e] = xrow[j];
        }
      }
      p0 += kRound;
      __syncthreads();  // the list is complete; counts may be rewritten
    }
    // walk the list: kUnroll X loads in flight, then their FMAs in order
    for (int e0 = 0; e0 < count; e0 += kUnroll) {
      float xv[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) xv[u][c] = 0.0f;
        if (live && e0 + u < count)
          load_cols<kVec>(xv[u], x + static_cast<long long>(lx[e0 + u]) * n_pad + col);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e0 + u < count)
          fma_entry(acc, lw[2 * (e0 + u)], lw[2 * (e0 + u) + 1], xv[u]);
    }
    __syncthreads();  // every thread is done with the list
  }

  if (!live) return;
  float* yp = y + (static_cast<long long>(ib) * bm + r0) * n_pad + col;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < rows) store_cols<kVec>(yp + static_cast<long long>(r) * n_pad, acc[r]);
}

}  // namespace

// Takes tn a multiple of 32 up to 256 and N_pad a multiple of tn (the
// wrapper checks; the kernel tiles columns by its own 256 and masks the
// edge); returns the launch's cudaError_t.
extern "C" int spmm_launch(const int* meta, const float* blocks,
                           const float* x, float* y, int nrb, int max_blocks,
                           int bm, int bn, int n_pad, int tn, int device,
                           void* stream) {
  if (tn <= 0 || tn % 32 || tn > kMaxTn || bn <= 0 || bm <= 0 || n_pad % tn)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_pad + kTile - 1) / kTile, nrb, (bm + kRows - 1) / kRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(y)) %
                       (kCols * sizeof(float)) == 0;
  if (vec)
    spmm_kernel<true><<<grid, kThreads, 0, st>>>(meta, blocks, x, y, max_blocks,
                                                 bm, bn, n_pad);
  else
    spmm_kernel<false><<<grid, kThreads, 0, st>>>(meta, blocks, x, y,
                                                  max_blocks, bm, bn, n_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
