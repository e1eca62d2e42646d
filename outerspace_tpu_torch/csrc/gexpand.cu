// K1: windowed-gather expand, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_expand_gather_kernel` of the JAX package
// (ops/pallas/gexpand.py:60, launched by `expand_gather_packed`). Same
// function, same bits: for every product slot of every subtile the
// planner staged (sched/gplanner.py), it finds the owning A element by
// binary search over the window's product prefix, gathers that
// element's (row, a_val, jb, cum) and the B element's (col, b_val), and
// writes the biased key row*n + col - 2^31 (uint32 arithmetic, stored
// as int32) and the value a_val * b_val. Slots at or past a subtile's
// plen get INT32_MAX / 0.
//
// Bound on the H100: it writes 8 B per slot (key + value) and reads
// each window a few times from L2; with ~17 M slots on rmat14 A² the
// writes alone are ~134 MB, i.e. ~40 us at 3.35 TB/s. The search is a
// chain of dependent loads (up to 8), so latency, not bandwidth, is
// what a simple version pays.
//
// Design: one block per (group, subtile), 256 threads x 4 slots, so
// neighbouring threads own neighbouring slots: output stores coalesce,
// and a warp's A-window probes mostly hit the same element (one
// transaction, broadcast). One launch covers every group; the TPU
// kernel's slab split only served executable reuse. Windows are read
// straight from global memory (through the read-only cache); staging
// them in shared memory is later work. Super-window reads clamp to the
// last 8-block ref exactly as the Pallas index maps do.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kSubP = 1024;      // products per subtile
constexpr int kGroupSubs = 8;    // subtiles per group
constexpr int kBlk = 128;        // lanes per block
constexpr int kThreads = 256;
constexpr int kAFields = 4;      // a_pack fields: row, a_val bits, jb, cum
constexpr int kBFields = 2;      // b_pack fields: col, b_val bits

// Field f of window element e of a subtile's A window: window block
// r_a + e/128 of the group's super-window, whose 8-block refs start at
// base8 and clamp to the last ref of the pack.
__device__ __forceinline__ int a_field(const int* __restrict__ a_pack,
                                       int nab8, int base8, int r_a,
                                       int e, int f) {
  const int la = r_a + (e >> 7);
  const int blk8 = min(base8 + (la >> 3), nab8 - 1);
  const size_t blk = static_cast<size_t>(blk8) * 8 + (la & 7);
  return __ldg(a_pack + (blk * kAFields + f) * kBlk + (e & (kBlk - 1)));
}

__global__ void __launch_bounds__(kThreads)
gexpand_kernel(const int* __restrict__ bases,
               const int* __restrict__ table,
               const int* __restrict__ a_pack,
               const int* __restrict__ b_pack,
               const int* __restrict__ group_bits,
               int* __restrict__ keys,
               float* __restrict__ vals,
               int nab8, int nbb8, int b_win) {
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int* tab = table + (static_cast<size_t>(g) * kGroupSubs + s) * kBlk;
  const int r_a = tab[0];
  const int r_b = tab[1];
  const int p0 = tab[2];
  const int plen = tab[3];
  const int anchor = tab[6];
  const unsigned n_cols =
      static_cast<unsigned>(table[static_cast<size_t>(g) * kGroupSubs * kBlk + 5]);
  const int a_base8 = bases[2 * g];
  const int b_base8 = bases[2 * g + 1];
  const int bits = group_bits[g];
  const int b_lo = (b_base8 * 8 + r_b) * kBlk;  // flat B index of the window
  const int j_max = b_win * kBlk - 1;
  const size_t out0 = (static_cast<size_t>(g) * kGroupSubs + s) * kSubP;

  for (int slot = threadIdx.x; slot < kSubP; slot += kThreads) {
    int key = INT_MAX;
    float val = 0.0f;
    if (slot < plen) {
      const int p = p0 + slot;
      // Largest window element e with cum[e] <= p (cum strictly
      // increasing); `bits` steps from the anchor, or 8 from 0.
      int ow = bits >= 8 ? 0 : anchor;
      for (int bit = bits - 1; bit >= 0; --bit) {
        const int probe = ow + (1 << bit);
        if (a_field(a_pack, nab8, a_base8, r_a, probe, 3) <= p) ow = probe;
      }
      const int row = a_field(a_pack, nab8, a_base8, r_a, ow, 0);
      const int a_bits = a_field(a_pack, nab8, a_base8, r_a, ow, 1);
      const int jb = a_field(a_pack, nab8, a_base8, r_a, ow, 2);
      const int cum = a_field(a_pack, nab8, a_base8, r_a, ow, 3);
      const int jloc = min(max(jb + (p - cum) - b_lo, 0), j_max);
      const int lb = r_b + (jloc >> 7);
      const int blk8 = min(b_base8 + (lb >> 3), nbb8 - 1);
      const size_t blk = static_cast<size_t>(blk8) * 8 + (lb & 7);
      const size_t bi = blk * kBFields * kBlk + (jloc & (kBlk - 1));
      const int col = __ldg(b_pack + bi);
      const int b_bits = __ldg(b_pack + bi + kBlk);
      const unsigned u = static_cast<unsigned>(row) * n_cols +
                         static_cast<unsigned>(col) + 0x80000000u;
      key = static_cast<int>(u);
      val = __fmul_rn(__int_as_float(a_bits), __int_as_float(b_bits));
    }
    keys[out0 + slot] = key;
    vals[out0 + slot] = val;
  }
}

}  // namespace

extern "C" int gexpand_launch(const int* bases, const int* table,
                              const int* a_pack, const int* b_pack,
                              const int* group_bits, int* keys, float* vals,
                              int ngroups, int nab8, int nbb8, int b_win,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ngroups > 0) {
    dim3 grid(ngroups, kGroupSubs);
    gexpand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        bases, table, a_pack, b_pack, group_bits, keys, vals, nab8, nbb8,
        b_win);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
