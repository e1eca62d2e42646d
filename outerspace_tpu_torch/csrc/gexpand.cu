// K1: windowed-gather expand, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_expand_gather_kernel` of the JAX package
// (ops/pallas/gexpand.py:60, launched by `expand_gather_packed`). Same
// function, same bits as the plain version (`expand_gather_plain`,
// ops/kernels/gexpand.py): for every product slot p = p0 + slot of every
// subtile the planner staged (sched/gplanner.py), a binary search of the
// group's depth over the A window's product prefix `cum` picks the owner
// (`bits` steps from the subtile's anchor, or 8 from 0; probe = ow + 2^bit,
// taken when cum[probe] <= p: the search's answer even where `cum` does
// not increase, as in the zero blocks that pad a commonised part), then
// the slot gathers the owner's (row, a_val, jb, cum) and the B element
// (col, b_val) at the clamped window offset jb + (p - cum) - b_lo, and
// writes the biased key row*n + col - 2^31 (uint32 arithmetic, stored as
// int32) and the value a_val * b_val. Slots at or past a subtile's plen
// get INT32_MAX / 0.
//
// Bound on the H100: bytes. It writes 8 B per slot and reads each part's
// packs once; on rmat14_ef8 A^2 (17.0 M slots, 5 parts) that is ~144 MB,
// ~43 us at 3.35 TB/s. The operations (one multiply per slot) are far
// below. The first design read every probe of the search (up to 8
// dependent loads) and every field straight from global memory,
// recomputing the clamped block address each time, and stored 4 B per
// thread and stream: a latency chain per slot, 27% of the bound.
//
// Design: one block per subtile, 128 threads, each with 2 runs of 4
// consecutive slots, at most 32 registers a thread: 16 blocks (subtiles)
// in flight per SM. The block stages its subtile's windows in shared
// memory with 16-byte loads: the A window (2 blocks x 4 fields, 4 KB) and
// the B window (b_win blocks x 2 fields, 1 KB per block: 3-5 KB on the
// planner's b_win 3 / 5, 40 KB at the wrapper's limit of 40), each block
// fetched through the same clamp to the pack's last 8-block ref as the
// plain version's reads. Every probe and field read then comes from
// shared memory. One block-wide check then decides whether cum does not
// decrease over the search's range. There a thread searches the owner of
// the first slot of each run only and walks forward for the next three,
// which finds what the search would; elsewhere every slot searches. A
// subtile whose search could leave the A window (not in a planner's plan,
// but the wrapper accepts such tables) reads A through the clamp in
// global memory, with 64-bit indices as the plain version's. A block
// index below 0 (a negative base or window ref) wraps once by the pack's
// length, as the plain version's torch indexing does; where torch would
// raise, the kernel reads the pack's first block. Keys and values leave
// as one 16-byte store per run each, a warp's 512 contiguous bytes. A
// subtile with plen <= 0 (a padding group, a commonised part's tail)
// writes its sentinels and stages nothing. Shared memory stays under
// 48 KB for every b_win the wrapper accepts, so the launch needs no
// attribute.
//
// What still holds it (kernel_variants.py, rmat14_ef8's 5 gather parts,
// device-only CUDA events): the same grid writing only its sentinels
// reaches ~72% of the bound, about what torch's fill of the same buffers
// reaches (~67%); staging the windows adds about a fifth to that time,
// the rest of the slot work about a seventh, the search and walk another
// fifth: ~44% of the bound in all.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kSubP = 1024;      // products per subtile
constexpr int kGroupSubs = 8;    // subtiles per group
constexpr int kBlk = 128;        // lanes per block
constexpr int kAWin = 2 * kBlk;  // A-window elements (A_WIN = 2 blocks)
constexpr int kAFields = 4;      // a_pack fields: row, a_val bits, jb, cum
constexpr int kBFields = 2;      // b_pack fields: col, b_val bits
constexpr int kMaxSteps = 8;     // the full-window search
constexpr int kMaxBWin = 40;     // the wrapper's limit (SUPER_B refs x 8)
constexpr int kThreads = 128;    // threads per block
constexpr int kPer = kSubP / kThreads;  // slots per thread, in runs of 4
static_assert(kPer % 4 == 0, "16-byte stores need runs of 4 slots");

// Block l of a window whose 8-block refs start at base8, clamped to the
// pack's last ref (as the Pallas index maps clamp); below 0 it wraps
// once by the pack's n8 * 8 blocks, as a negative torch index does.
__device__ __forceinline__ long long ref_block(int base8, int n8, long long l) {
  long long blk = min(static_cast<long long>(base8) + (l >> 3),
                      static_cast<long long>(n8) - 1) * 8 + (l & 7);
  if (blk < 0) blk += 8LL * n8;
  return max(blk, 0LL);
}

// The n elements (a multiple of 4) of the nf fields of a window whose
// block l is block r + l of the 8-block refs from base8, clamped as the
// plain version clamps, to shared memory: field f of element e at
// dst[f * n + e]. 16 bytes a load, or 4 where the packs are not 16-byte
// aligned.
__device__ __forceinline__ void stage(int* dst, const int* pack, int nf, int base8, int n8,
                                      int r, int n, bool vec) {
  const int n4 = n >> 2;
  for (int q = threadIdx.x; q < nf * n4; q += kThreads) {
    const int f = q / n4;
    const int e = 4 * (q - f * n4);
    const long long blk = ref_block(base8, n8, r + (e >> 7));
    const int* src = pack + (blk * nf + f) * kBlk + (e & (kBlk - 1));
    if (vec) {
      *reinterpret_cast<int4*>(dst + f * n + e) = __ldg(reinterpret_cast<const int4*>(src));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[f * n + e + k] = __ldg(src + k);
    }
  }
}

struct Subtile {
  const int* a_pack;
  const int* s_a;  // staged A window, field-major [4][kAWin]
  const int* s_b;  // staged B window, field-major [2][bw]
  int nab8, a_base8, r_a, bw;
  long long b_lo;  // flat B index of the window's first element
  unsigned n_cols;
};

// An A-window index: the staged window's, or one that may leave it
// (kept in 64 bits, as the plain version's are).
template <bool kShared>
using Idx = typename std::conditional<kShared, int, long long>::type;

// Field f of A-window element e: from shared memory, or through the
// clamp in global memory.
template <bool kShared>
__device__ __forceinline__ int a_at(const Subtile& s, Idx<kShared> e, int f) {
  if constexpr (kShared) {
    return s.s_a[f * kAWin + e];
  } else {
    const long long blk = ref_block(s.a_base8, s.nab8, s.r_a + (e >> 7));
    return __ldg(s.a_pack + (blk * kAFields + f) * kBlk + (e & (kBlk - 1)));
  }
}

// Owner of product p: `steps` binary-search steps from `start`.
template <bool kShared>
__device__ __forceinline__ Idx<kShared> search(const Subtile& s, int start, int steps, int p) {
  Idx<kShared> ow = start;
#pragma unroll
  for (int bit = kMaxSteps - 1; bit >= 0; --bit) {
    if (bit < steps) {
      const Idx<kShared> probe = ow + (1 << bit);
      if (a_at<kShared>(s, probe, 3) <= p) ow = probe;
    }
  }
  return ow;
}

// Slot i of this thread: slot i & 3 of run i / 4 of the block's runs of
// 4 (thread t holds the t-th run of each 4 * kThreads slots).
__device__ __forceinline__ int slot_of(int i) {
  return (i >> 2) * 4 * kThreads + threadIdx.x * 4 + (i & 3);
}

// Key and value of product p owned by element ow; the window offset in
// 64 bits, as the plain version computes it.
template <bool kShared>
__device__ __forceinline__ void emit(const Subtile& s, Idx<kShared> ow, long long p,
                                     int& key, float& val) {
  const int row = a_at<kShared>(s, ow, 0);
  const int a_bits = a_at<kShared>(s, ow, 1);
  const long long off = a_at<kShared>(s, ow, 2) + (p - a_at<kShared>(s, ow, 3)) - s.b_lo;
  const int jloc = static_cast<int>(min(max(off, 0LL), static_cast<long long>(s.bw - 1)));
  const int col = s.s_b[jloc];
  const int b_bits = s.s_b[s.bw + jloc];
  key = static_cast<int>(static_cast<unsigned>(row) * s.n_cols +
                         static_cast<unsigned>(col) + 0x80000000u);
  val = __fmul_rn(__int_as_float(a_bits), __int_as_float(b_bits));
}

// The thread's kPer slots, the owners in [start, hi]. kWalk: search the
// first slot of each run and walk forward for the rest. p is clamped to
// INT_MAX for the search (cum is an int32, so cum <= p is unchanged).
template <bool kShared, bool kWalk>
__device__ __forceinline__ void slots(const Subtile& s, int p0, int plen, int start,
                                      int steps, int hi, int (&key)[kPer],
                                      float (&val)[kPer]) {
  Idx<kShared> ow = start;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int slot = slot_of(i);
    key[i] = INT_MAX;
    val[i] = 0.0f;
    if (slot < plen) {
      const long long p = static_cast<long long>(p0) + slot;
      const int p32 = static_cast<int>(min(p, static_cast<long long>(INT_MAX)));
      if (kWalk && (i & 3) != 0) {
        while (ow < hi && s.s_a[3 * kAWin + ow + 1] <= p32) ++ow;
      } else {
        ow = search<kShared>(s, start, steps, p32);
      }
      emit<kShared>(s, ow, p, key[i], val[i]);
    }
  }
}

// The thread's kPer slots. On the staged window the block first checks,
// once, that cum does not decrease over the search's range [start, hi]:
// there the owner of p + 1 is the owner of p or a later element, so
// walking forward finds what the search would.
template <bool kShared>
__device__ __forceinline__ void expand_slots(const Subtile& s, int p0, int plen,
                                             int start, int steps,
                                             int (&key)[kPer], float (&val)[kPer]) {
  const int hi = start + (steps > 0 ? 1 << steps : 1) - 1;
  if constexpr (kShared) {
    const int* cum = s.s_a + 3 * kAWin;
    bool ok = true;
    for (int e = start + threadIdx.x; e < hi; e += kThreads) ok = ok && cum[e] <= cum[e + 1];
    if (__syncthreads_and(ok)) {
      slots<true, true>(s, p0, plen, start, steps, hi, key, val);
      return;
    }
  }
  slots<kShared, false>(s, p0, plen, start, steps, hi, key, val);
}

// A full SM's threads resident: at most 32 registers a thread.
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
gexpand_kernel(const int* __restrict__ bases,
               const int* __restrict__ table,
               const int* __restrict__ a_pack,
               const int* __restrict__ b_pack,
               const int* __restrict__ group_bits,
               int* __restrict__ keys,
               float* __restrict__ vals,
               int nab8, int nbb8, int b_win) {
  extern __shared__ int4 smem[];
  const int t = blockIdx.x;  // subtile: group * 8 + subtile of the group
  const int g = t / kGroupSubs;
  const int* tab = table + static_cast<size_t>(t) * kBlk;
  const int plen = tab[3];
  const size_t out0 = static_cast<size_t>(t) * kSubP;
  int key[kPer];
  float val[kPer];

  if (plen > 0) {
    int* sm = reinterpret_cast<int*>(smem);
    Subtile s;
    s.a_pack = a_pack;
    s.s_a = sm;
    s.s_b = sm + kAFields * kAWin;
    s.nab8 = nab8;
    s.a_base8 = bases[2 * g];
    s.r_a = tab[0];
    s.bw = b_win * kBlk;
    const int b_base8 = bases[2 * g + 1];
    const int r_b = tab[1];
    s.b_lo = (static_cast<long long>(b_base8) * 8 + r_b) * kBlk;
    s.n_cols = static_cast<unsigned>(table[static_cast<size_t>(g) * kGroupSubs * kBlk + 5]);
    const bool vec =
        ((reinterpret_cast<uintptr_t>(a_pack) | reinterpret_cast<uintptr_t>(b_pack)) & 15) == 0;
    const int p0 = tab[2];
    const int anchor = tab[6];
    const int bits = group_bits[g];
    const int start = bits >= kMaxSteps ? 0 : anchor;
    const int steps = min(bits, kMaxSteps);
    const bool in_win = start >= 0 && start <= kAWin - (steps > 0 ? 1 << steps : 1);
    // (a search that may leave the A window reads A from global memory)
    if (in_win) stage(sm, a_pack, kAFields, s.a_base8, nab8, s.r_a, kAWin, vec);
    stage(sm + kAFields * kAWin, b_pack, kBFields, b_base8, nbb8, r_b, s.bw, vec);
    __syncthreads();
    if (in_win) {
      expand_slots<true>(s, p0, plen, start, steps, key, val);
    } else {
      expand_slots<false>(s, p0, plen, start, steps, key, val);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      key[i] = INT_MAX;
      val[i] = 0.0f;
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; i += 4) {
    const size_t o = out0 + slot_of(i);
    *reinterpret_cast<int4*>(keys + o) = make_int4(key[i], key[i + 1], key[i + 2], key[i + 3]);
    *reinterpret_cast<float4*>(vals + o) =
        make_float4(val[i], val[i + 1], val[i + 2], val[i + 3]);
  }
}

}  // namespace

extern "C" int gexpand_launch(const int* bases, const int* table,
                              const int* a_pack, const int* b_pack,
                              const int* group_bits, int* keys, float* vals,
                              int ngroups, int nab8, int nbb8, int b_win,
                              int device, void* stream) {
  if (b_win < 1 || b_win > kMaxBWin) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ngroups > 0) {
    const size_t smem = (kAFields * kAWin + kBFields * b_win * kBlk) * sizeof(int);
    gexpand_kernel<<<ngroups * kGroupSubs, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        bases, table, a_pack, b_pack, group_bits, keys, vals, nab8, nbb8, b_win);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
