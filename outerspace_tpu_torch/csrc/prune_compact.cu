// Prune and compaction of the MCL chain's first squaring, hand-written for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package prunes and compacts this
// stream with XLA ops in its `mcl_whole_traced` (the prune, then
// `compact_masked_stream` or `_to_front` and a sort), and the port did the
// same in plain PyTorch: some 25 launches, each over the whole merged
// stream, several in int64. This kernel does that step in one pass. For
// each slot i of the first squaring's merged stream (rows, cols, vals,
// valid; L slots), the slot survives iff valid[i] and
// max(vals[i], 0) > thr, thr being the float32 t^(1/p) of the prune
// threshold t and the inflation p. Each survivor's biased CSC key
// (cols[i]*m + rows[i]) ^ 2^31, computed in 32-bit unsigned arithmetic,
// and its max(v, 0) are written to one of the first elem_pad slots of
// (kp, vp). A second launch fills the slots past the survivors with
// (INT32_MAX, 0) and writes ok.
//
// What bounds it on the H100: bytes. Deciding a slot needs only valid
// (1 B) and vals (4 B); rows and cols are read only for the survivors
// (~149K of the 503M slots on the benchmark's rmat15_ef16 flow). So the
// least time is 5 B a slot, 503M x 5 B / 3.35 TB/s = 0.75 ms there, plus
// the survivors' reads and the elem_pad output slots written once.
//
// Design: one block of 256 threads per tile of CAP_BLOCK = 8,192 slots,
// aligned at multiples of 8,192. A thread takes 8 groups of 4 slots,
// group j at tile word j*256 + t, so each of a warp's loads covers one
// contiguous span: vals as one float4 and valid as one 4-byte word per
// group (the wrapper holds vals 16-byte and valid 4-byte aligned; scalar
// loads only at the stream's ragged end), all issued before any is used,
// streamed past the caches (__ldcs). A block with no survivor leaves
// after one __syncthreads_or. Otherwise a warp scan of the threads'
// survivor counts and one scan over the 8 warp totals give the tile's
// count and each thread's offset in it; thread 0 takes the tile's place
// in the output by one atomicAdd on a global counter and records the
// tile's count by one atomicMax, so the same block count is both the
// tile's share of the survivors and its cap check.
//
// Why the write order is free: the caller sorts the elem_pad slots by key
// next. K2 merged the stream, so the survivors' keys are unique and the
// sorted (kp, vp) are bit-identical to those of a compaction in stream
// order whenever ok holds; when ok is false the caller discards them and
// runs the exact fallback. Survivors whose place is at or past elem_pad
// are counted and not written.
//
// ok keeps the JAX package's cap semantics: ok = (survivors <= elem_pad)
// and, when cap > 0, (the most survivors any CAP_BLOCK-slot block holds
// <= cap), the bound under which the JAX package's blocked compaction is
// exact, so the same inputs take the fast path or the fallback in both
// packages.
//
// The 64-bit instantiation (prune_compact64_launch; kernels
// prune_compact_kernel_wide, prune_compact_tail_wide) writes plain int64
// keys cols[i]*m + rows[i] and fills with INT64_MAX, for flows with
// m^2 >= 2^32, whose CSC keys pass 32 bits; it reads what the 32-bit one
// reads and writes 4 more bytes a survivor. The 32-bit kernels are the
// same templates at int keys, unchanged.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;                          // groups of 4 slots per thread
constexpr int kTile = kThreads * kGroups * 4;       // 8,192 slots: CAP_BLOCK
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTailThreads = 256;
constexpr int kTailBlocks = 1024;

// A survivor's key, and the sentinel, of each instantiation: the biased
// int32 (cols*m + rows) ^ 2^31 in 32-bit unsigned arithmetic, or the
// plain int64 cols*m + rows.
__device__ __forceinline__ int csc_key(int col, int row, unsigned m, int) {
  const unsigned key = static_cast<unsigned>(col) * m + static_cast<unsigned>(row);
  return static_cast<int>(key ^ 0x80000000u);
}

__device__ __forceinline__ long long csc_key(int col, int row, unsigned m, long long) {
  return static_cast<long long>(col) * m + row;
}

__device__ __forceinline__ int sentinel(int) { return INT_MAX; }

__device__ __forceinline__ long long sentinel(long long) { return LLONG_MAX; }

template <typename K>
__device__ __forceinline__ void
prune_compact_body(const int* __restrict__ rows, const int* __restrict__ cols,
                   const float* __restrict__ vals, const unsigned char* __restrict__ valid,
                   long long n, float thr, unsigned m, unsigned elem_pad,
                   K* __restrict__ kp, float* __restrict__ vp,
                   unsigned* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  __shared__ unsigned s_base;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  float v[kGroups][4];
  unsigned ok4[kGroups];  // the group's 4 valid bytes
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const long long s0 = base + 4LL * (j * kThreads + t);
    if (s0 + 4 <= n) {
      const float4 f = __ldcs(reinterpret_cast<const float4*>(vals + s0));
      v[j][0] = f.x;
      v[j][1] = f.y;
      v[j][2] = f.z;
      v[j][3] = f.w;
      ok4[j] = __ldcs(reinterpret_cast<const unsigned*>(valid + s0));
    } else {
      ok4[j] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = s0 + k < n;
        v[j][k] = in ? vals[s0 + k] : 0.0f;
        ok4[j] |= (in && valid[s0 + k] ? 1u : 0u) << (8 * k);
      }
    }
  }
  unsigned bits = 0;  // bit 4j+k: slot k of group j survives
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // max(v, 0) as torch.clamp(v, min=0) gives it: NaN stays NaN
      const float r = v[j][k] < 0.0f ? 0.0f : v[j][k];
      v[j][k] = r;
      const bool live = ((ok4[j] >> (8 * k)) & 0xffu) != 0 && r > thr;
      bits |= static_cast<unsigned>(live) << (4 * j + k);
    }
  }
  const int c = __popc(bits);
  if (!__syncthreads_or(c)) return;

  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (t == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = s_warp[w];
      s_warp[w] = total;
      total += x;
    }
    s_base = atomicAdd(counts, static_cast<unsigned>(total));
    atomicMax(counts + 1, static_cast<unsigned>(total));
  }
  __syncthreads();
  if (!c) return;
  unsigned long long dest = static_cast<unsigned long long>(s_base) + s_warp[warp] + (incl - c);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (bits >> (4 * j + k) & 1u) {
        if (dest < elem_pad) {
          const long long s = base + 4LL * (j * kThreads + t) + k;
          kp[dest] = csc_key(__ldg(cols + s), __ldg(rows + s), m, K());
          vp[dest] = v[j][k];
        }
        ++dest;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
prune_compact_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                     const float* __restrict__ vals, const unsigned char* __restrict__ valid,
                     long long n, float thr, unsigned m, unsigned elem_pad,
                     int* __restrict__ kp, float* __restrict__ vp,
                     unsigned* __restrict__ counts) {
  prune_compact_body<int>(rows, cols, vals, valid, n, thr, m, elem_pad, kp, vp, counts);
}

__global__ void __launch_bounds__(kThreads)
prune_compact_kernel_wide(const int* __restrict__ rows, const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const unsigned char* __restrict__ valid, long long n, float thr,
                          unsigned m, unsigned elem_pad, long long* __restrict__ kp,
                          float* __restrict__ vp, unsigned* __restrict__ counts) {
  prune_compact_body<long long>(rows, cols, vals, valid, n, thr, m, elem_pad, kp, vp, counts);
}

// The slots past the survivors get (the sentinel, 0); ok from the counts.
template <typename K>
__device__ __forceinline__ void
prune_compact_tail_body(const unsigned* __restrict__ counts, unsigned elem_pad, unsigned cap,
                        K* __restrict__ kp, float* __restrict__ vp,
                        unsigned char* __restrict__ ok) {
  const unsigned total = counts[0];
  const long long start = total < elem_pad ? total : elem_pad;
  const long long step = static_cast<long long>(gridDim.x) * kTailThreads;
  for (long long i = start + static_cast<long long>(blockIdx.x) * kTailThreads + threadIdx.x;
       i < elem_pad; i += step) {
    kp[i] = sentinel(K());
    vp[i] = 0.0f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *ok = total <= elem_pad && (cap == 0 || counts[1] <= cap);
}

__global__ void __launch_bounds__(kTailThreads)
prune_compact_tail(const unsigned* __restrict__ counts, unsigned elem_pad, unsigned cap,
                   int* __restrict__ kp, float* __restrict__ vp,
                   unsigned char* __restrict__ ok) {
  prune_compact_tail_body<int>(counts, elem_pad, cap, kp, vp, ok);
}

__global__ void __launch_bounds__(kTailThreads)
prune_compact_tail_wide(const unsigned* __restrict__ counts, unsigned elem_pad, unsigned cap,
                        long long* __restrict__ kp, float* __restrict__ vp,
                        unsigned char* __restrict__ ok) {
  prune_compact_tail_body<long long>(counts, elem_pad, cap, kp, vp, ok);
}

// Both passes of one instantiation.
template <typename K>
int launch(const int* rows, const int* cols, const float* vals, const unsigned char* valid,
           int n, float thr, int m, int elem_pad, int cap, K* kp, float* vp,
           unsigned char* ok, unsigned* counts, int device, void* stream) {
  constexpr bool kWide = sizeof(K) == 8;
  if (n < 0 || m <= 0 || elem_pad < 0 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the vector loads: vals as float4, valid as 4-byte words
  if (reinterpret_cast<std::uintptr_t>(vals) % 16 || reinterpret_cast<std::uintptr_t>(valid) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counts, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  if (tiles > 0) {
    const unsigned grid = static_cast<unsigned>(tiles);
    if constexpr (kWide)
      prune_compact_kernel_wide<<<grid, kThreads, 0, st>>>(
          rows, cols, vals, valid, n, thr, static_cast<unsigned>(m),
          static_cast<unsigned>(elem_pad), kp, vp, counts);
    else
      prune_compact_kernel<<<grid, kThreads, 0, st>>>(
          rows, cols, vals, valid, n, thr, static_cast<unsigned>(m),
          static_cast<unsigned>(elem_pad), kp, vp, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long want = (static_cast<long long>(elem_pad) + kTailThreads - 1) / kTailThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > kTailBlocks ? kTailBlocks : want));
  if constexpr (kWide)
    prune_compact_tail_wide<<<blocks, kTailThreads, 0, st>>>(
        counts, static_cast<unsigned>(elem_pad), static_cast<unsigned>(cap), kp, vp, ok);
  else
    prune_compact_tail<<<blocks, kTailThreads, 0, st>>>(
        counts, static_cast<unsigned>(elem_pad), static_cast<unsigned>(cap), kp, vp, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// counts: two 32-bit words of scratch (the survivors, the most in a tile),
// zeroed here on the stream before the pass.
extern "C" int prune_compact_launch(const int* rows, const int* cols, const float* vals,
                                    const unsigned char* valid, int n, float thr, int m,
                                    int elem_pad, int cap, int* kp, float* vp,
                                    unsigned char* ok, unsigned* counts, int device,
                                    void* stream) {
  return launch<int>(rows, cols, vals, valid, n, thr, m, elem_pad, cap, kp, vp, ok, counts,
                     device, stream);
}

// The 64-bit instantiation: the same arguments, kp as int64.
extern "C" int prune_compact64_launch(const int* rows, const int* cols, const float* vals,
                                      const unsigned char* valid, int n, float thr, int m,
                                      int elem_pad, int cap, long long* kp, float* vp,
                                      unsigned char* ok, unsigned* counts, int device,
                                      void* stream) {
  return launch<long long>(rows, cols, vals, valid, n, thr, m, elem_pad, cap, kp, vp, ok,
                           counts, device, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
