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
// What bounds it on the H100: bytes. It reads 8 B per slot (key, value)
// and writes 13 B (row, col, value, valid byte): ~17 M slots on rmat14
// A² is ~0.36 GB, ~0.11 ms at 3.35 TB/s. A run may be any length (the
// port keeps no max_run bound; runs on rmat14 A² reach 655 slots, MCL
// flows longer), so a design in which one thread sums a run serially, or
// in which blocks of a few hundred slots meet with atomics, waits on
// serial chains and same-address atomics instead of memory; and stores
// that leave a warp 64 bytes apart per thread cost twice the L2 write
// transactions of coalesced ones (measured: 16 slots per thread ran at a
// third of the bound, 4 per thread at two thirds).
//
// Design: two launches, no memset, no atomics.
// Pass 1 (tiles): one block of 256 threads per tile of 1,024 consecutive
// slots, 4 per thread, loaded and stored as one int4 / float4 word per
// array (coalesced across the warp; scalar for an unaligned stream or the
// stream's ragged end), plus one key on each side of the tile for the
// run-start and run-last flags. Each thread scans its slots serially; a
// segmented inclusive scan of (run start seen, sum since the last start)
// pairs by __shfl_up_sync within each warp, then over the 8 warp totals
// in shared memory, gives each thread the sum of its leading run from
// the tile's start; a second serial walk finishes every run that starts
// in the tile, whatever its length, and writes rows, cols, values and
// valid (one packed 32-bit word). The unpack divides by n_cols as a
// multiply-high by a magic number computed once. The one slot it cannot
// finish is the last slot of the tile's leading continuation run, which
// started in an earlier tile: it holds the tile-local partial sum, and
// the tile's record (6 words in scratch) names it, with the tile's
// trailing partial sum, whether the tile holds a run start, its sentinel
// count and sum and its valid count.
// Pass 2 (carry): one block of up to 1,024 threads walks the records
// (stored one array per field, so a thread reads each field of its 4
// consecutive tiles as one coalesced 16-byte word), 4,096 tiles at a
// time; a warp scans the warp totals, and an exclusive
// segmented scan of (run start seen, trailing sum) gives each tile the
// sum its leading run carries in, for a run that spans any number of
// tiles, added into the named slot; the counts and the sentinel sum are
// added in tile order (deterministic: two launches on the same input give
// bit-equal values), and the 2^32 corner rule sets the terminal slot and
// nnz.
//
// The 64-bit instantiation (scan64_launch; kernels scan_tile_kernel_wide,
// scan_carry_kernel_wide) takes plain int64 keys row*n + col, for an index
// space past 2^32 (the MCL chain's loop from m^2 >= 2^32 on), sorted
// ascending with the sentinel INT64_MAX. It reads each key as 8 bytes
// (a thread's 4 keys as two 16-byte words), decodes row and column by a
// 64-bit division, and never counts a sentinel slot as real: no key of
// an index space below 2^62 is INT64_MAX, so pad_count is not read. The
// 32-bit kernels are the same templates at int keys, unchanged.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                 // consecutive slots per thread: one
                                        // int4 / float4 word, so a warp's
                                        // loads and stores are coalesced
constexpr int kTile = kThreads * kPer;  // 1,024 slots per tile
constexpr int kRecFields = 6;           // int32 words per tile record
constexpr int kCarryThreads = 1024;
constexpr int kRecPer = 4;              // tile records per carry thread
constexpr unsigned kFull = 0xffffffffu;

// Tile records, one array per field, each `stride` (the tile count
// rounded up to 4) words long, so a carry thread reads its 4 tiles'
// field as one coalesced 16-byte word: [0] the tile holds a run start,
// [1] its trailing run's sum (f32 bits; the whole tile's sum if it holds
// no start), [2] the slot closing its leading continuation run (-1 if
// none), [3] sentinel count, [4] sentinel sum (f32 bits), [5] valid slots.

// A segment of the stream: whether it holds a run start, and the sum of
// its values since its last start (all of them if none).
struct Seg {
  int f;
  float v;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {  // a, then b
  return {a.f | b.f, b.f ? b.v : a.v + b.v};
}

// Inclusive scan of `s` over the warp's lanes; `excl` gets the lanes
// before this one (the empty segment for lane 0).
__device__ __forceinline__ Seg warp_scan(Seg s, int lane, Seg& excl) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg o = {__shfl_up_sync(kFull, s.f, off), __shfl_up_sync(kFull, s.v, off)};
    if (lane >= off) s = combine(o, s);
  }
  excl = {__shfl_up_sync(kFull, s.f, 1), __shfl_up_sync(kFull, s.v, 1)};
  if (lane == 0) excl = {0, 0.0f};
  return s;
}

// n / d for any 32-bit n, with magic = ceil(2^64 / d) for d > 1 and 0 for
// d == 1 (Lemire, Kaser and Kurz, "Faster remainder by direct
// computation", 2019: exact since 64 >= 32 + log2(d)).
__device__ __forceinline__ unsigned div_magic(unsigned n, unsigned long long magic) {
  return magic ? static_cast<unsigned>(__umul64hi(magic, n)) : n;
}

// The keys of each instantiation: the sentinel, a thread's 4 keys loaded
// as 16-byte words, and a real key decoded to (row, col).
template <typename K>
struct Keys;

template <>
struct Keys<int> {
  static constexpr int kSentinel = INT_MAX;
  __device__ static void load4(const int* p, int* k) {
    const int4 a = *reinterpret_cast<const int4*>(p);
    k[0] = a.x;
    k[1] = a.y;
    k[2] = a.z;
    k[3] = a.w;
  }
  // biased: key ^ 2^31 is the unsigned row * n_cols + col
  __device__ static void decode(int k, unsigned n_cols, unsigned long long magic, int& row,
                                int& col) {
    const unsigned ku = static_cast<unsigned>(k) ^ 0x80000000u;
    const unsigned r = div_magic(ku, magic);
    row = static_cast<int>(r);
    col = static_cast<int>(ku - r * n_cols);
  }
};

template <>
struct Keys<long long> {
  static constexpr long long kSentinel = LLONG_MAX;
  __device__ static void load4(const long long* p, long long* k) {
    const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
    k[0] = a.x;
    k[1] = a.y;
    k[2] = b.x;
    k[3] = b.y;
  }
  __device__ static void decode(long long k, unsigned n_cols, unsigned long long, int& row,
                                int& col) {
    const unsigned long long ku = static_cast<unsigned long long>(k);
    const unsigned long long r = ku / n_cols;
    row = static_cast<int>(r);
    col = static_cast<int>(ku - r * n_cols);
  }
};

// component i (0-3) of a
__device__ __forceinline__ int lane_of(int4 a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : (i == 2 ? a.z : a.w));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

template <typename K, bool kVec>
__device__ __forceinline__ void
scan_tile(const K* __restrict__ key, const float* __restrict__ vals,
          int* __restrict__ rows, int* __restrict__ cols,
          float* __restrict__ out_vals, unsigned char* __restrict__ valid,
          int* __restrict__ rec, int stride, int n, unsigned n_cols,
          unsigned long long magic, int sentinel_row) {
  constexpr K kSent = Keys<K>::kSentinel;
  __shared__ K s_first[kThreads];
  __shared__ K s_last[kThreads];
  __shared__ int s_wf[kWarps];
  __shared__ float s_wv[kWarps];
  __shared__ int s_sent[kWarps];
  __shared__ float s_ssum[kWarps];
  __shared__ int s_live[kWarps];
  __shared__ int s_close;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long i0 = base + static_cast<long long>(t) * kPer;
  const long long left = n - i0;
  const int nv = left <= 0 ? 0 : (left >= kPer ? kPer : static_cast<int>(left));
  const bool vec = kVec && nv == kPer;
  // the keys beside the tile, loaded with the tile's own
  const K before = t == 0 && base > 0 ? key[base - 1] : 0;
  const K after = t == kThreads - 1 && base + kTile < n ? key[base + kTile] : 0;

  K k[kPer];
  float v[kPer];
  if (vec) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      Keys<K>::load4(key + i0 + 4 * q, k + 4 * q);
      const float4 b = reinterpret_cast<const float4*>(vals + i0)[q];
      v[4 * q] = b.x;
      v[4 * q + 1] = b.y;
      v[4 * q + 2] = b.z;
      v[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      k[j] = j < nv ? key[i0 + j] : kSent;
      v[j] = j < nv ? vals[i0 + j] : 0.0f;
    }
  }
  if (t == 0) s_close = -1;
  s_first[t] = k[0];
  s_last[t] = k[kPer - 1];
  __syncthreads();
  // a thread with slots has a full thread before it and, if has_next, a
  // thread after it with slots (or the next tile's first slot)
  const K prev = t > 0 ? s_last[t - 1] : before;
  const bool has_next = i0 + kPer < n;
  const K next = t + 1 < kThreads ? s_first[t + 1] : after;

  unsigned start = 0, last = 0, sent = 0;
  Seg own = {0, 0.0f};
  int nsent = 0;
  float ssum = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < nv) {
      const K kp = j > 0 ? k[j > 0 ? j - 1 : 0] : prev;
      const bool st = (j == 0 && i0 == 0) || kp != k[j];
      const bool la = j + 1 < nv ? k[j + 1 < kPer ? j + 1 : j] != k[j]
                                 : (!has_next || next != k[j]);
      const bool se = k[j] == kSent;
      start |= static_cast<unsigned>(st) << j;
      last |= static_cast<unsigned>(la) << j;
      sent |= static_cast<unsigned>(se) << j;
      if (st) {
        own.f = 1;
        own.v = v[j];
      } else {
        own.v += v[j];
      }
      if (se) {
        ++nsent;
        ssum += v[j];
      }
    }
  }
  int nlive = __popc(last & ~sent);

  Seg excl;
  const Seg incl = warp_scan(own, lane, excl);
  nsent = warp_sum(nsent);
  ssum = warp_sum(ssum);
  nlive = warp_sum(nlive);
  if (lane == 31) {
    s_wf[warp] = incl.f;
    s_wv[warp] = incl.v;
  }
  if (lane == 0) {
    s_sent[warp] = nsent;
    s_ssum[warp] = ssum;
    s_live[warp] = nlive;
  }
  __syncthreads();
  Seg carry = {0, 0.0f};  // the tile's slots before this thread's
  for (int w = 0; w < warp; ++w) carry = combine(carry, Seg{s_wf[w], s_wv[w]});
  carry = combine(carry, excl);

  float run = carry.v;
  bool lead = !carry.f;  // the current run started before this tile
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    int rr[4], cc[4];
    float vv[4];
    unsigned vb = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      if (start >> j & 1u) {
        run = v[j];
        lead = false;
      } else {
        run += v[j];
      }
      rr[u] = sentinel_row;
      cc[u] = 0;
      vv[u] = 0.0f;
      if (j < nv && (last >> j & 1u) && !(sent >> j & 1u)) {
        Keys<K>::decode(k[j], n_cols, magic, rr[u], cc[u]);
        vv[u] = run;
        vb |= 1u << (8 * u);
        if (lead) s_close = static_cast<int>(i0 + j);
      }
    }
    if (vec) {
      reinterpret_cast<int4*>(rows + i0)[q] = make_int4(rr[0], rr[1], rr[2], rr[3]);
      reinterpret_cast<int4*>(cols + i0)[q] = make_int4(cc[0], cc[1], cc[2], cc[3]);
      reinterpret_cast<float4*>(out_vals + i0)[q] = make_float4(vv[0], vv[1], vv[2], vv[3]);
      reinterpret_cast<unsigned*>(valid + i0)[q] = vb;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * q + u;
        if (j < nv) {
          rows[i0 + j] = rr[u];
          cols[i0 + j] = cc[u];
          out_vals[i0 + j] = vv[u];
          valid[i0 + j] = static_cast<unsigned char>(vb >> (8 * u) & 1u);
        }
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    Seg tile = {0, 0.0f};
    int ts = 0, tl = 0;
    float tsum = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      tile = combine(tile, Seg{s_wf[w], s_wv[w]});
      ts += s_sent[w];
      tsum += s_ssum[w];
      tl += s_live[w];
    }
    int* r = rec + blockIdx.x;
    r[0] = tile.f;
    r[stride] = __float_as_int(tile.v);
    r[2 * stride] = s_close;
    r[3 * stride] = ts;
    r[4 * stride] = __float_as_int(tsum);
    r[5 * stride] = tl;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_tile_kernel(const int* __restrict__ key, const float* __restrict__ vals,
                 int* __restrict__ rows, int* __restrict__ cols,
                 float* __restrict__ out_vals, unsigned char* __restrict__ valid,
                 int* __restrict__ rec, int stride, int n, unsigned n_cols,
                 unsigned long long magic, int sentinel_row) {
  scan_tile<int, kVec>(key, vals, rows, cols, out_vals, valid, rec, stride, n, n_cols, magic,
                       sentinel_row);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_tile_kernel_wide(const long long* __restrict__ key, const float* __restrict__ vals,
                      int* __restrict__ rows, int* __restrict__ cols,
                      float* __restrict__ out_vals, unsigned char* __restrict__ valid,
                      int* __restrict__ rec, int stride, int n, unsigned n_cols,
                      unsigned long long magic, int sentinel_row) {
  scan_tile<long long, kVec>(key, vals, rows, cols, out_vals, valid, rec, stride, n, n_cols,
                             magic, sentinel_row);
}

template <typename K>
__device__ __forceinline__ void
scan_carry(const K* __restrict__ key, const int* __restrict__ rec,
           int ntiles, int stride, int* __restrict__ rows, int* __restrict__ cols,
           float* __restrict__ out_vals, unsigned char* __restrict__ valid,
           int* __restrict__ nnz, int n, unsigned n_cols, int pad_count) {
  __shared__ int s_wf[32];
  __shared__ float s_wv[32];
  __shared__ int s_sent[32];
  __shared__ float s_ssum[32];
  __shared__ int s_live[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const K last_key = t == 0 && n > 0 ? key[n - 1] : 0;
  Seg carry = {0, 0.0f};  // every tile before this chunk
  int sent = 0, live = 0;  // totals before this chunk (thread 0's)
  float ssum = 0.0f;
  for (int c0 = 0; c0 < ntiles; c0 += blockDim.x * kRecPer) {
    // this thread's kRecPer consecutive tiles, folded in order
    const int tile0 = c0 + t * kRecPer;
    int4 f[kRecFields];
#pragma unroll
    for (int q = 0; q < kRecFields; ++q) f[q] = make_int4(0, 0, 0, 0);
    if (tile0 < ntiles) {
#pragma unroll
      for (int q = 0; q < kRecFields; ++q)
        f[q] = reinterpret_cast<const int4*>(rec + static_cast<long long>(q) * stride)[tile0 / 4];
    }
    Seg segs[kRecPer];
    int close[kRecPer];
    Seg own = {0, 0.0f};
    int ts = 0, tl = 0;
    float tsum = 0.0f;
#pragma unroll
    for (int i = 0; i < kRecPer; ++i) {
      segs[i] = {0, 0.0f};
      close[i] = -1;
      if (tile0 + i < ntiles) {
        segs[i] = {lane_of(f[0], i), __int_as_float(lane_of(f[1], i))};
        close[i] = lane_of(f[2], i);
        ts += lane_of(f[3], i);
        tsum += __int_as_float(lane_of(f[4], i));
        tl += lane_of(f[5], i);
      }
      own = combine(own, segs[i]);
    }
    // the partial sums the tiles' closing slots hold (distinct slots:
    // each lies in its own tile), fetched before the scans
    float part[kRecPer];
#pragma unroll
    for (int i = 0; i < kRecPer; ++i) part[i] = close[i] >= 0 ? out_vals[close[i]] : 0.0f;
    Seg excl;
    const Seg incl = warp_scan(own, lane, excl);
    ts = warp_sum(ts);
    tsum = warp_sum(tsum);
    tl = warp_sum(tl);
    if (lane == 31) {
      s_wf[warp] = incl.f;
      s_wv[warp] = incl.v;
    }
    if (lane == 0) {
      s_sent[warp] = ts;
      s_ssum[warp] = tsum;
      s_live[warp] = tl;
    }
    __syncthreads();
    Seg wexcl = {0, 0.0f};  // the warps before this one
    Seg chunk = {0, 0.0f};  // the whole chunk
    if (warp == 0) {
      // warp 0 scans the warp totals; the others wait at the barrier
      const Seg w = lane < nwarps ? Seg{s_wf[lane], s_wv[lane]} : Seg{0, 0.0f};
      const Seg wincl = warp_scan(w, lane, wexcl);
      chunk = {__shfl_sync(kFull, wincl.f, 31), __shfl_sync(kFull, wincl.v, 31)};
      const int cs = warp_sum(lane < nwarps ? s_sent[lane] : 0);
      const float css = warp_sum(lane < nwarps ? s_ssum[lane] : 0.0f);
      const int cl = warp_sum(lane < nwarps ? s_live[lane] : 0);
      if (t == 0) {
        sent += cs;
        ssum += css;
        live += cl;
      }
    }
    __syncthreads();
    if (warp == 0) {
      s_wf[lane] = wexcl.f;
      s_wv[lane] = wexcl.v;
      if (lane == 0) {
        s_sent[0] = chunk.f;
        s_ssum[0] = chunk.v;
      }
    }
    __syncthreads();
    Seg before = combine(carry, Seg{s_wf[warp], s_wv[warp]});
    before = combine(before, excl);
#pragma unroll
    for (int i = 0; i < kRecPer; ++i) {
      if (close[i] >= 0) out_vals[close[i]] = before.v + part[i];
      before = combine(before, segs[i]);
    }
    carry = combine(carry, Seg{s_sent[0], s_ssum[0]});
    __syncthreads();
  }
  if (t == 0) {
    // the 2^32 corner shares the 32-bit sentinel's bit pattern; no 64-bit
    // key is the sentinel
    if (sizeof(K) == 4 && n > 0 && last_key == Keys<K>::kSentinel && sent > pad_count) {
      const unsigned ku = static_cast<unsigned>(INT_MAX) ^ 0x80000000u;
      rows[n - 1] = static_cast<int>(ku / n_cols);
      cols[n - 1] = static_cast<int>(ku % n_cols);
      out_vals[n - 1] = ssum;
      valid[n - 1] = 1;
      ++live;
    }
    *nnz = live;
  }
}

__global__ void __launch_bounds__(kCarryThreads)
scan_carry_kernel(const int* __restrict__ key, const int* __restrict__ rec,
                  int ntiles, int stride, int* __restrict__ rows, int* __restrict__ cols,
                  float* __restrict__ out_vals, unsigned char* __restrict__ valid,
                  int* __restrict__ nnz, int n, unsigned n_cols, int pad_count) {
  scan_carry<int>(key, rec, ntiles, stride, rows, cols, out_vals, valid, nnz, n, n_cols,
                  pad_count);
}

__global__ void __launch_bounds__(kCarryThreads)
scan_carry_kernel_wide(const long long* __restrict__ key, const int* __restrict__ rec,
                       int ntiles, int stride, int* __restrict__ rows, int* __restrict__ cols,
                       float* __restrict__ out_vals, unsigned char* __restrict__ valid,
                       int* __restrict__ nnz, int n, unsigned n_cols, int pad_count) {
  scan_carry<long long>(key, rec, ntiles, stride, rows, cols, out_vals, valid, nnz, n, n_cols,
                        pad_count);
}

// Both launches of one instantiation.
template <typename K>
int launch(const K* key, const float* vals, int* rows, int* cols, float* out_vals,
           unsigned char* valid, int* nnz, int* scratch, int scratch_words, int n, int n_cols,
           int sentinel_row, int pad_count, int device, void* stream) {
  constexpr bool kWide = sizeof(K) == 8;
  const long long ntiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  const long long stride = (ntiles + 3) / 4 * 4;
  if (n < 0 || n_cols <= 0 || stride * kRecFields > scratch_words ||
      reinterpret_cast<std::uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nc = static_cast<unsigned>(n_cols);
  const unsigned long long magic = nc > 1 ? ~0ull / nc + 1 : 0;
  if (ntiles > 0) {
    const std::uintptr_t addr =
        reinterpret_cast<std::uintptr_t>(key) | reinterpret_cast<std::uintptr_t>(vals) |
        reinterpret_cast<std::uintptr_t>(rows) | reinterpret_cast<std::uintptr_t>(cols) |
        reinterpret_cast<std::uintptr_t>(out_vals) |
        reinterpret_cast<std::uintptr_t>(valid);
    const unsigned grid = static_cast<unsigned>(ntiles);
    const int s = static_cast<int>(stride);
    if constexpr (kWide) {
      if (addr % 16 == 0)
        scan_tile_kernel_wide<true><<<grid, kThreads, 0, st>>>(
            key, vals, rows, cols, out_vals, valid, scratch, s, n, nc, magic, sentinel_row);
      else
        scan_tile_kernel_wide<false><<<grid, kThreads, 0, st>>>(
            key, vals, rows, cols, out_vals, valid, scratch, s, n, nc, magic, sentinel_row);
    } else {
      if (addr % 16 == 0)
        scan_tile_kernel<true><<<grid, kThreads, 0, st>>>(
            key, vals, rows, cols, out_vals, valid, scratch, s, n, nc, magic, sentinel_row);
      else
        scan_tile_kernel<false><<<grid, kThreads, 0, st>>>(
            key, vals, rows, cols, out_vals, valid, scratch, s, n, nc, magic, sentinel_row);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long want = (ntiles + kRecPer * 32 - 1) / (kRecPer * 32) * 32;
  const int threads = static_cast<int>(want < 32 ? 32 : (want > kCarryThreads ? kCarryThreads : want));
  if constexpr (kWide)
    scan_carry_kernel_wide<<<1, threads, 0, st>>>(key, scratch, static_cast<int>(ntiles),
                                                  static_cast<int>(stride), rows, cols,
                                                  out_vals, valid, nnz, n, nc, pad_count);
  else
    scan_carry_kernel<<<1, threads, 0, st>>>(key, scratch, static_cast<int>(ntiles),
                                             static_cast<int>(stride), rows, cols, out_vals,
                                             valid, nnz, n, nc, pad_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: kRecFields arrays of the tile count rounded up to 4 int32
// words, 16-byte aligned (the wrapper allocates them; scratch_words says
// how many it gave). Returns the launches' cudaError_t.
extern "C" int scan_launch(const int* key, const float* vals, int* rows,
                           int* cols, float* out_vals, unsigned char* valid,
                           int* nnz, int* scratch, int scratch_words, int n,
                           int n_cols, int sentinel_row, int pad_count,
                           int device, void* stream) {
  return launch<int>(key, vals, rows, cols, out_vals, valid, nnz, scratch, scratch_words, n,
                     n_cols, sentinel_row, pad_count, device, stream);
}

// The 64-bit instantiation: the same arguments, keys as int64.
extern "C" int scan64_launch(const long long* key, const float* vals, int* rows,
                             int* cols, float* out_vals, unsigned char* valid,
                             int* nnz, int* scratch, int scratch_words, int n,
                             int n_cols, int sentinel_row, int pad_count,
                             int device, void* stream) {
  return launch<long long>(key, vals, rows, cols, out_vals, valid, nnz, scratch, scratch_words,
                           n, n_cols, sentinel_row, pad_count, device, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
