// The expand of each MCL loop squaring, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package runs the loop's flat expand
// as XLA ops (segment broadcasts by scatter and cumulative sum, gathers,
// key packing), and the port did the same in plain PyTorch: three int64
// segment broadcasts, each an index_add_ into a p_pad + 1 buffer, a cumsum,
// a remainder and a cast, then the gathers and the key packing, some 45
// launches over every product slot. This kernel writes each slot once.
//
// What it computes (bit for bit the plain version in
// ops/kernels/loop_expand.py). The loop's state is a CSC stream of
// elem_pad slots: sorted keys col*m + row (biased int32, (col*m + row) ^
// 2^31 in 32-bit unsigned arithmetic, or plain int64), a sentinel tail
// (INT32_MAX / INT64_MAX), float32 values and the column starts
// starts_ext[m + 1]. Element f = (k = row_f, c = col_f) owns the product
// slots [offsets[f], offsets[f + 1]) (offsets: int64, elem_pad + 1, a
// cumulative sum of degrees, so non-decreasing). Slot p < p_clamped, owned
// by the last f with offsets[f] <= p, reads stream position
// j = starts_ext[row_f] + (p - offsets[f]) and gets the key of
// (col_f, row of key[j]) in the stream's dtype and the value
// vals[f] * vals[j] (one float32 multiply); slots p_clamped <= p < p_pad get
// (sentinel, +0.0). p_clamped is a 0-d int64 on the card, read here, so the
// caller never reads it on the host.
//
// What bounds it on the H100: bytes. Each slot's key and value are written
// once (12 B a slot with int64 keys, 8 B with int32 ones) and each product
// reads its B-side key and value (12 B or 8 B); the lfr19_k20_mu03 loop's
// three squarings fill 838.9M slots, 469.3M of them products: at 3.35 TB/s
// about 3-5 ms a run. The plain version moved several int64 passes over
// every slot, scratch included.
//
// Design: one block of 256 threads per tile of 4,096 consecutive slots.
// A tile wholly at or past p_clamped writes only sentinels. Otherwise two
// warps find the owners of the tile's first and last product slot by a
// 32-way search over offsets (one probe a lane, ~5 rounds for 16.8M
// elements), and the block stages the elements between them in shared
// memory: each one's offset relative to the tile, column, value and
// starts_ext[row] - offsets[f], decoded once per element. A thread takes 4
// groups of 4 consecutive slots (group g at tile word g*256 + t, so each
// warp store covers one contiguous span); it finds a group's first owner by
// a binary search of the staged offsets and walks forward for the other
// three. Keys leave as 16-byte stores (an int4 or two longlong2) and values
// as a float4, with scalar stores only at an unaligned ragged end. A tile
// that spans more elements than the stage holds searches offsets in device
// memory and decodes its elements there: always correct, only slower.
// Neighbouring slots of one owner read neighbouring j, so the B-side reads
// coalesce. A key's row is key - (key / m) * m, the division by a
// multiply-shift whose magic the host precomputes (exact for every key
// below 2^63), not a 64-bit division a slot.
//
// The 64-bit instantiation (loop_expand64_launch; kernel
// loop_expand_kernel_wide) writes int64 keys, for flows with m^2 >= 2^32;
// the 32-bit one (loop_expand_launch; loop_expand_kernel) biased int32 keys.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                       // groups of 4 slots per thread
constexpr int kTile = kThreads * kGroups * 4;    // 4,096 slots
constexpr int kStage = 1024;                     // elements a tile stages
constexpr unsigned kFull = 0xffffffffu;

// The division of a key by m: q = floor(u * magic / 2^shift), exact for
// every u < 2^63 (magic = ceil(2^shift / m), shift = 63 + ceil(log2 m)).
struct Divider {
  unsigned long long magic;
  int shift;
};

__device__ __forceinline__ unsigned long long div_m(unsigned long long u, Divider d) {
  const unsigned long long hi = __umul64hi(u, d.magic);
  if (d.shift >= 64) return hi >> (d.shift - 64);
  return (hi << (64 - d.shift)) | ((u * d.magic) >> d.shift);  // m = 1: shift 63
}

// Each instantiation's unsigned key value, key of (col, row), sentinel.
__device__ __forceinline__ unsigned long long ukey(int k) {
  return static_cast<unsigned>(k) ^ 0x80000000u;
}

__device__ __forceinline__ unsigned long long ukey(long long k) {
  return static_cast<unsigned long long>(k);
}

__device__ __forceinline__ int make_key(unsigned col, unsigned long long row, unsigned m, int) {
  return static_cast<int>((col * m + static_cast<unsigned>(row)) ^ 0x80000000u);
}

__device__ __forceinline__ long long make_key(unsigned col, unsigned long long row, unsigned m,
                                              long long) {
  return static_cast<long long>(col) * m + static_cast<long long>(row);
}

__device__ __forceinline__ int sentinel(int) { return INT_MAX; }

__device__ __forceinline__ long long sentinel(long long) { return LLONG_MAX; }

// 4 keys at an aligned slot: one int4, or two longlong2.
__device__ __forceinline__ void store4(int* out, const int (&k)[4]) {
  *reinterpret_cast<int4*>(out) = make_int4(k[0], k[1], k[2], k[3]);
}

__device__ __forceinline__ void store4(long long* out, const long long (&k)[4]) {
  reinterpret_cast<longlong2*>(out)[0] = make_longlong2(k[0], k[1]);
  reinterpret_cast<longlong2*>(out)[1] = make_longlong2(k[2], k[3]);
}

// The last i in [0, n) with off[i] <= p, given off[0] <= p and off
// non-decreasing: a 32-way search by one warp, every lane returning it.
__device__ __forceinline__ long long warp_owner(const long long* __restrict__ off, long long n,
                                                long long p, int lane) {
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, i < hi && __ldg(off + i) <= p);
    const long long next = lo + static_cast<long long>(31 - __clz(le)) * step;
    hi = min(hi, next + step);
    lo = next;
  }
  const long long i = lo + lane;
  const unsigned le = __ballot_sync(kFull, i < hi && __ldg(off + i) <= p);
  return lo + (31 - __clz(le));
}

// An element's column, value and starts_ext[row] - offsets[f]: the B-side
// position of its slot p is base + p. An empty slot's element owns no
// product; it reads row 0's start.
template <typename K>
__device__ __forceinline__ void decode(const K* __restrict__ kcsc, const float* __restrict__ vals,
                                       const int* __restrict__ starts_ext,
                                       const long long* __restrict__ offsets, long long f,
                                       unsigned m, Divider d, unsigned& col, long long& base,
                                       float& val) {
  const K k = __ldg(kcsc + f);
  const unsigned long long u = ukey(k);
  const unsigned long long c = div_m(u, d);
  const bool valid = k != sentinel(K());
  const unsigned long long row = valid ? u - c * m : 0;
  col = static_cast<unsigned>(c);
  base = static_cast<long long>(__ldg(starts_ext + row)) - __ldg(offsets + f);
  val = __ldg(vals + f);
}

template <typename K>
__device__ __forceinline__ void
loop_expand_body(const K* __restrict__ kcsc, const float* __restrict__ vals,
                 const int* __restrict__ starts_ext, const long long* __restrict__ offsets,
                 const long long* __restrict__ p_clamped, long long elem_pad, long long p_pad,
                 unsigned m, Divider d, K* __restrict__ key_out, float* __restrict__ val_out) {
  __shared__ int s_off[kStage];  // offsets[f0 + i] - tile0
  __shared__ unsigned s_col[kStage];
  __shared__ long long s_base[kStage];
  __shared__ float s_val[kStage];
  __shared__ long long s_f[2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long pc = *p_clamped;
  const long long live = min(tile0 + kTile, pc) - tile0;  // product slots of the tile

  long long f0 = 0, n_el = 0;
  bool staged = false;
  if (live > 0) {
    if (warp < 2) {
      const long long f = warp_owner(offsets, elem_pad, tile0 + (warp ? live - 1 : 0), lane);
      if (lane == 0) s_f[warp] = f;
    }
    __syncthreads();
    f0 = s_f[0];
    n_el = s_f[1] - f0 + 1;
    staged = n_el <= kStage;
    if (staged) {
      for (int i = t; i < n_el; i += kThreads) {
        unsigned col;
        long long base;
        float val;
        decode(kcsc, vals, starts_ext, offsets, f0 + i, m, d, col, base, val);
        s_off[i] = static_cast<int>(__ldg(offsets + f0 + i) - tile0);
        s_col[i] = col;
        s_base[i] = base;
        s_val[i] = val;
      }
      __syncthreads();
    }
  }

#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int q0 = 4 * (g * kThreads + t);  // the group's first slot in the tile
    const long long p0 = tile0 + q0;
    if (p0 >= p_pad) break;
    K k[4];
    float v[4];
    long long i = 0;  // the owner of slot q (staged: an index of the stage)
    if (q0 < live) {
      long long lo = 0, hi = n_el;  // last i with offset <= q0
      while (hi - lo > 1) {
        const long long mid = (lo + hi) >> 1;
        const long long o = staged ? s_off[mid] : __ldg(offsets + f0 + mid) - tile0;
        if (o <= q0) lo = mid; else hi = mid;
      }
      i = lo;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = q0 + s;
      if (q >= live) {
        k[s] = sentinel(K());
        v[s] = 0.0f;
        continue;
      }
      while (i + 1 < n_el
             && (staged ? s_off[i + 1] : __ldg(offsets + f0 + i + 1) - tile0) <= q)
        ++i;
      unsigned col;
      long long base;
      float val;
      if (staged) {
        col = s_col[i];
        base = s_base[i];
        val = s_val[i];
      } else {
        decode(kcsc, vals, starts_ext, offsets, f0 + i, m, d, col, base, val);
      }
      const long long j = base + tile0 + q;
      const unsigned long long u = ukey(__ldg(kcsc + j));
      k[s] = make_key(col, u - div_m(u, d) * m, m, K());
      v[s] = __fmul_rn(val, __ldg(vals + j));
    }
    if (p0 + 4 <= p_pad) {
      store4(key_out + p0, k);
      *reinterpret_cast<float4*>(val_out + p0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int s = 0; s < 4 && p0 + s < p_pad; ++s) {
        key_out[p0 + s] = k[s];
        val_out[p0 + s] = v[s];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
loop_expand_kernel(const int* __restrict__ kcsc, const float* __restrict__ vals,
                   const int* __restrict__ starts_ext, const long long* __restrict__ offsets,
                   const long long* __restrict__ p_clamped, long long elem_pad, long long p_pad,
                   unsigned m, Divider d, int* __restrict__ key_out,
                   float* __restrict__ val_out) {
  loop_expand_body<int>(kcsc, vals, starts_ext, offsets, p_clamped, elem_pad, p_pad, m, d,
                        key_out, val_out);
}

__global__ void __launch_bounds__(kThreads)
loop_expand_kernel_wide(const long long* __restrict__ kcsc, const float* __restrict__ vals,
                        const int* __restrict__ starts_ext,
                        const long long* __restrict__ offsets,
                        const long long* __restrict__ p_clamped, long long elem_pad,
                        long long p_pad, unsigned m, Divider d, long long* __restrict__ key_out,
                        float* __restrict__ val_out) {
  loop_expand_body<long long>(kcsc, vals, starts_ext, offsets, p_clamped, elem_pad, p_pad, m, d,
                              key_out, val_out);
}

template <typename K>
int launch(const K* kcsc, const float* vals, const int* starts_ext, const long long* offsets,
           const long long* p_clamped, long long elem_pad, long long p_pad, int m,
           unsigned long long magic, int shift, K* key_out, float* val_out, int device,
           void* stream) {
  if (elem_pad < 0 || p_pad < 0 || m <= 0 || shift < 63 || shift > 95)
    return static_cast<int>(cudaErrorInvalidValue);
  // the 16-byte stores of keys and values
  if (reinterpret_cast<std::uintptr_t>(key_out) % 16
      || reinterpret_cast<std::uintptr_t>(val_out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (p_pad + kTile - 1) / kTile;
  if (tiles == 0) return 0;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Divider d{magic, shift};
  if constexpr (sizeof(K) == 8)
    loop_expand_kernel_wide<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        kcsc, vals, starts_ext, offsets, p_clamped, elem_pad, p_pad, static_cast<unsigned>(m),
        d, key_out, val_out);
  else
    loop_expand_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        kcsc, vals, starts_ext, offsets, p_clamped, elem_pad, p_pad, static_cast<unsigned>(m),
        d, key_out, val_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kcsc, vals: elem_pad slots; starts_ext: m + 1; offsets: elem_pad + 1;
// p_clamped: one int64 in [0, p_pad] on the card; key_out, val_out: p_pad
// slots, 16-byte aligned. magic, shift: the division by m (the wrapper's).
extern "C" int loop_expand_launch(const int* kcsc, const float* vals, const int* starts_ext,
                                  const long long* offsets, const long long* p_clamped,
                                  long long elem_pad, long long p_pad, int m,
                                  unsigned long long magic, int shift, int* key_out,
                                  float* val_out, int device, void* stream) {
  return launch<int>(kcsc, vals, starts_ext, offsets, p_clamped, elem_pad, p_pad, m, magic,
                     shift, key_out, val_out, device, stream);
}

// The 64-bit instantiation: the same arguments, kcsc and key_out as int64.
extern "C" int loop_expand64_launch(const long long* kcsc, const float* vals,
                                    const int* starts_ext, const long long* offsets,
                                    const long long* p_clamped, long long elem_pad,
                                    long long p_pad, int m, unsigned long long magic, int shift,
                                    long long* key_out, float* val_out, int device,
                                    void* stream) {
  return launch<long long>(kcsc, vals, starts_ext, offsets, p_clamped, elem_pad, p_pad, m, magic,
                           shift, key_out, val_out, device, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
