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
// stored as int32) and a*b (__fmul_rn), or INT32_MAX / 0 where masked;
// K4 writes (row, col, a*b), or (sentinel_row, 0, 0). A class's output
// is task-major, then sub, then lane.
//
// One launch covers every class table of a row part (a "group", at most
// three tables: tile_a 128, 32 and 8), written straight into the part's
// merge stream at each class's first slot; one class is the group of
// the single-table wrappers. The group's descriptor (per class: tile_a,
// tasks, first task, first A element, first output slot, first unit)
// travels by value as a kernel parameter, so a launch copies nothing to
// the device.
//
// Bound on the H100: the writes. Each slot costs 8 B (K3) or 12 B (K4)
// of output against 16 B of table per task, at most tile_a * 8 B of A
// and 1 KB of B per task of tile_a * 128 slots, and one multiply, so the
// kernel is bound by device-memory bytes: ~17.6 us for the 7.3 M slots
// of rmat14_ef8 A^2 (K3), ~26 us (K4).
//
// Design: the work is cut into uniform units of 8 rows x 128 lanes
// (1,024 slots, 8 KB of K3 output): a tile_a = 8 task is one unit, 32 is
// four, 128 sixteen, so every block does the same work whatever the
// class. A block of 8 warps takes two units, one warp per row, and
// issues both units' loads before it stores (one unit per block left
// the loads' latency exposed); each lane owns 4 adjacent B lanes, loads
// their columns and values as one int4 and one float4, and stores one
// int4 of keys (K4: rows and cols) and one float4 of values: 512
// contiguous bytes per warp per array per store. The warp's A row and
// value are one broadcast load each (the 8 warps read the unit's 64
// bytes of A). A padding task (a_len = 0), a masked row or a lane group
// outside [b_lo, b_hi) loads nothing but the 16-byte task row and
// stores sentinels. The block finds its unit's class by comparing with
// the <= 3 unit offsets. The stores stay plain: TMA bulk stores of each
// staged unit and evict-first stores were tried (kernel_variants.py K3,
// PERF.md); neither shortened the tiled pipeline.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kLanes = 128;                  // B lanes per task
constexpr int kRows = 8;                     // rows per unit, one warp each
constexpr int kThreads = 32 * kRows;         // 8 warps
constexpr int kUnitSlots = kRows * kLanes;   // 1,024 slots per unit
constexpr int kMaxClasses = 3;
constexpr int kDescFields = 6;
constexpr int kUnroll = 2;  // units a block takes, their loads in flight together

struct Group {
  int nclasses;
  int shift[kMaxClasses];     // log2(units per task) = log2(tile_a / 8)
  int tile_a[kMaxClasses];
  int task_off[kMaxClasses];  // first task of each class in the joined table
  int a_off[kMaxClasses];     // first A element of each class
  int out_off[kMaxClasses];   // first output slot of each class
  int unit_off[kMaxClasses + 1];  // first unit of each class; [nclasses] = all
};

// One slot: masked (the sentinels stay) or the product.
template <bool kPacked>
__device__ __forceinline__ void emit(bool live, int a_row, float a_val, int b_col,
                                     float b_val, unsigned last, int& r0, int& r1,
                                     float& v) {
  if (live) {
    v = __fmul_rn(a_val, b_val);
    if (kPacked) {
      r0 = static_cast<int>(static_cast<unsigned>(a_row) * last +
                            static_cast<unsigned>(b_col) + 0x80000000u);
    } else {
      r0 = a_row;
      r1 = b_col;
    }
  }
}

// Where unit u's row `row` reads and writes. The class is picked by
// compares against constant indices, so the descriptor stays in the
// parameter bank (a dynamic index would copy it to local memory).
struct Place {
  int task;    // the task row in the joined table
  int sub;     // the row within the task
  size_t a;    // the A element
  size_t out;  // the first output slot of the row
};

__device__ __forceinline__ Place locate(const Group& g, int u, int row) {
  int shift = g.shift[0], tile_a = g.tile_a[0], task_off = g.task_off[0];
  int a_off = g.a_off[0], out_off = g.out_off[0], first = g.unit_off[0];
#pragma unroll
  for (int i = 1; i < kMaxClasses; ++i) {
    if (i < g.nclasses && u >= g.unit_off[i]) {
      shift = g.shift[i];
      tile_a = g.tile_a[i];
      task_off = g.task_off[i];
      a_off = g.a_off[i];
      out_off = g.out_off[i];
      first = g.unit_off[i];
    }
  }
  const int lu = u - first;
  const int t = lu >> shift;  // the task within its class
  Place p;
  p.task = task_off + t;
  p.sub = ((lu & ((1 << shift) - 1)) << 3) + row;
  p.a = static_cast<size_t>(a_off) + static_cast<size_t>(t) * tile_a + p.sub;
  p.out = static_cast<size_t>(out_off) + static_cast<size_t>(lu) * kUnitSlots + row * kLanes;
  return p;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const __grid_constant__ Group g,
              const int4* __restrict__ tasks,    // (a_len, b_block, b_lo, b_hi)
              const int* __restrict__ a_rows,
              const float* __restrict__ a_vals,
              const int4* __restrict__ b_cols,   // [NB * 32] of 4 lanes
              const float4* __restrict__ b_vals,
              int* __restrict__ out0,    // K3: keys;  K4: rows
              int* __restrict__ out1,    // K3: unused; K4: cols
              float* __restrict__ vals,
              int last) {               // K3: n_cols; K4: sentinel_row
  const int row = threadIdx.x >> 5;          // the unit's row: the warp
  const int l4 = (threadIdx.x & 31) * 4;     // the first of the thread's 4 lanes
  const int units = g.unit_off[g.nclasses];
  const unsigned n = static_cast<unsigned>(last);
  // kUnroll units per pass, their loads issued before any store (the
  // grid covers the units in one pass; a smaller grid strides)
  for (int u0 = blockIdx.x * kUnroll; u0 < units; u0 += gridDim.x * kUnroll) {
    Place p[kUnroll];
    int4 task[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      task[k] = make_int4(0, 0, 0, 0);  // past the end: no live row, no store
      if (u0 + k < units) {
        p[k] = locate(g, u0 + k, row);
        task[k] = __ldg(tasks + p[k].task);
      }
    }
    int a_row[kUnroll];
    float a_val[kUnroll];
    int4 bc[kUnroll];
    float4 bv[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      // sub < a_len implies a_len > 0 and sub < tile_a
      live[k] = u0 + k < units && p[k].sub < task[k].x && l4 + 4 > task[k].z &&
                l4 < task[k].w;
      if (live[k]) {
        a_row[k] = __ldg(a_rows + p[k].a);
        a_val[k] = __ldg(a_vals + p[k].a);
        const size_t bi = static_cast<size_t>(task[k].y) * (kLanes / 4) + (l4 >> 2);
        bc[k] = __ldg(b_cols + bi);
        bv[k] = __ldg(b_vals + bi);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (u0 + k >= units) break;
      int4 r0 = kPacked ? make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX)
                        : make_int4(last, last, last, last);
      int4 r1 = make_int4(0, 0, 0, 0);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live[k]) {
        const int lo = task[k].z, hi = task[k].w;
        emit<kPacked>(l4 >= lo && l4 < hi, a_row[k], a_val[k], bc[k].x, bv[k].x, n, r0.x,
                      r1.x, v.x);
        emit<kPacked>(l4 + 1 >= lo && l4 + 1 < hi, a_row[k], a_val[k], bc[k].y, bv[k].y, n,
                      r0.y, r1.y, v.y);
        emit<kPacked>(l4 + 2 >= lo && l4 + 2 < hi, a_row[k], a_val[k], bc[k].z, bv[k].z, n,
                      r0.z, r1.z, v.z);
        emit<kPacked>(l4 + 3 >= lo && l4 + 3 < hi, a_row[k], a_val[k], bc[k].w, bv[k].w, n,
                      r0.w, r1.w, v.w);
      }
      const size_t o = p[k].out + l4;
      *reinterpret_cast<int4*>(out0 + o) = r0;
      if (!kPacked) *reinterpret_cast<int4*>(out1 + o) = r1;
      *reinterpret_cast<float4*>(vals + o) = v;
    }
  }
}

// The group from the host's descriptor rows (tile_a, tasks, first task,
// first A element, first output slot, first unit); false if malformed.
bool make_group(const int* desc, int nclasses, Group* g) {
  if (nclasses < 1 || nclasses > kMaxClasses) return false;
  g->nclasses = nclasses;
  for (int c = 0; c < nclasses; ++c) {
    const int* d = desc + c * kDescFields;
    const int per = d[0] / kRows;  // units per task, a power of two
    if (d[0] % kRows || per < 1 || per > kLanes / kRows || (per & (per - 1))) return false;
    g->shift[c] = __builtin_ctz(per);
    g->tile_a[c] = d[0];
    g->task_off[c] = d[2];
    g->a_off[c] = d[3];
    g->out_off[c] = d[4];
    g->unit_off[c] = d[5];
  }
  const int* end = desc + (nclasses - 1) * kDescFields;
  g->unit_off[nclasses] = end[5] + end[1] * (end[0] / kRows);
  for (int c = nclasses; c < kMaxClasses; ++c) {  // unused slots
    g->shift[c] = g->tile_a[c] = g->task_off[c] = g->a_off[c] = g->out_off[c] = 0;
    g->unit_off[c + 1] = g->unit_off[nclasses];
  }
  return true;
}

template <bool kPacked>
int launch(const int* desc, int nclasses, const int* tasks, const int* a_rows,
           const float* a_vals, const int* b_cols, const float* b_vals, int* out0,
           int* out1, float* vals, int last, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Group g;
  if (!make_group(desc, nclasses, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const int units = g.unit_off[nclasses];
  if (units > 0) {
    const int grid = (units + kUnroll - 1) / kUnroll;
    expand_kernel<kPacked><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        g, reinterpret_cast<const int4*>(tasks), a_rows, a_vals,
        reinterpret_cast<const int4*>(b_cols), reinterpret_cast<const float4*>(b_vals),
        out0, out1, vals, last);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int expand_packed_launch(const int* desc, int nclasses, const int* tasks,
                                    const int* a_rows, const float* a_vals,
                                    const int* b_cols_blk, const float* b_vals_blk,
                                    int* keys, float* vals, int n_cols, int device,
                                    void* stream) {
  return launch<true>(desc, nclasses, tasks, a_rows, a_vals, b_cols_blk, b_vals_blk, keys,
                      nullptr, vals, n_cols, device, stream);
}

extern "C" int expand_coords_launch(const int* desc, int nclasses, const int* tasks,
                                    const int* a_rows, const float* a_vals,
                                    const int* b_cols_blk, const float* b_vals_blk,
                                    int* rows, int* cols, float* vals, int sentinel_row,
                                    int device, void* stream) {
  return launch<false>(desc, nclasses, tasks, a_rows, a_vals, b_cols_blk, b_vals_blk, rows,
                       cols, vals, sentinel_row, device, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
