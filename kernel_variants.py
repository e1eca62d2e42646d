#!/usr/bin/env python3
"""Time variants of K1 (``csrc/gexpand.cu``), K2 (``csrc/scan.cu``), K3
(``csrc/expand.cu``) and K5 (``csrc/spmm.cu``) on one NVIDIA card, at
the shapes ``chip_smoke.py`` drives: the five gather parts of rmat14_ef8
A² (K1) and their sorted streams (K2), the class tables of its four
tiled row parts (K3), and the eight layers of one MLP1w b1024 and one
LeNet b256 forward with the committed weights (K5); with ROUTES, the
earlier routes of ``spgemm``'s host stages beside the committed ones
(``time_routes``); with WORLDS, what a launched world of the sharded
mode costs before any work (``time_worlds``). Run from the repository
root:

    python3 kernel_variants.py [K1] [K2] [K3] [K5] [ROUTES] [WORLDS] [--parent DIR]

Each variant is the kernel's source with some of its constants (or some
lines) replaced, built with the port's ``nvcc`` flags into
``build/variants/``; ``--parent DIR`` adds the K1 and K3 sources of the
checkout at DIR (another tree, e.g. the parent commit unpacked by ``git
archive``). A variant that computes the same function is held against
the plain PyTorch version, K1's and K3's bit for bit; one marked "timing
only" is not, or computes it only on these inputs.
It prints each variant's device ms and the card's name and power limit:
for K1 and K3 by CUDA events around the launches with the host's launch
cost left out (``chip_smoke._device_ms``, median of 10; the gaps between
the launches count), for K2 and K5 by ``torch.profiler`` (the sum of
the kernels' durations, mean of 5 runs).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke


def _threads(n):
    return [("constexpr int kThreads = 128;", f"constexpr int kThreads = {n};")]


# every slot searched, the block-wide check still run
_SEARCH_ALL = [("slots<true, true>(", "slots<true, false>(")]
# slot i of thread t at t + i * kThreads, one 4-byte store per slot
_SCALAR_STORES = [
    ("return (i >> 2) * 4 * kThreads + threadIdx.x * 4 + (i & 3);",
     "return threadIdx.x + i * kThreads;"),
    ('static_assert(kPer % 4 == 0, "16-byte stores need runs of 4 slots");', ""),
    ("""  for (int i = 0; i < kPer; i += 4) {
    const size_t o = out0 + slot_of(i);
    *reinterpret_cast<int4*>(keys + o) = make_int4(key[i], key[i + 1], key[i + 2], key[i + 3]);
    *reinterpret_cast<float4*>(vals + o) =
        make_float4(val[i], val[i + 1], val[i + 2], val[i + 3]);
  }""", """  for (int i = 0; i < kPer; ++i) {
    keys[out0 + slot_of(i)] = key[i];
    vals[out0 + slot_of(i)] = val[i];
  }"""),
]
_K1_SLOTS = """    if (in_win) {
      expand_slots<true>(s, p0, plen, start, steps, key, val);
    } else {
      expand_slots<false>(s, p0, plen, start, steps, key, val);
    }"""

# K1: (name, replacements in csrc/gexpand.cu, computes the kernel's
# function: held bit for bit to plain on the gather parts)
K1_VARIANTS = (
    ("K1 as built: windows in shared memory, 128 threads x 2 runs of 4 consecutive slots, "
     "each run's first slot searched and the rest walked, 16-byte stores", [], True),
    ("K1 256 threads x 1 run of 4 slots", _threads(256), True),
    ("K1 64 threads x 4 runs of 4 slots", _threads(64), True),
    ("K1 128 threads x 8 consecutive slots, one search per thread (stores 32 B apart)",
     [("return (i >> 2) * 4 * kThreads + threadIdx.x * 4 + (i & 3);",
       "return threadIdx.x * kPer + i;"),
      ("if (kWalk && (i & 3) != 0) {", "if (kWalk && i != 0) {")], True),
    ("K1 search every slot", _SEARCH_ALL, True),
    ("K1 256 threads x 4 slots 256 apart, 4-byte stores, search every slot",
     _threads(256) + _SCALAR_STORES + _SEARCH_ALL, True),
    ("K1 one thread per slot (1,024 threads), 4-byte stores, search every slot",
     _threads(1024) + _SCALAR_STORES + _SEARCH_ALL, True),
    ("K1 A window read from global memory (B staged), search every slot",
     [("const bool in_win = start >= 0 &&", "const bool in_win = false && start >= 0 &&")], True),
    # the walk alone is wrong where cum decreases over the search's range
    # (as in the hand-made windows of tests/torch_cases.py)
    ("K1 walk forward without the monotone check (timing only: == plain on these parts)",
     [("if (__syncthreads_and(ok)) {", "if (true) {")], True),
    ("K1 no search (timing only)",
     [("const int steps = min(bits, kMaxSteps);", "const int steps = 0 * bits;")], False),
    ("K1 staging and stores only (timing only)",
     [(_K1_SLOTS, "    for (int i = 0; i < kPer; ++i) {\n"
                  "      key[i] = s.s_a[threadIdx.x] + s.s_b[threadIdx.x + i];\n"
                  "      val[i] = 0.0f;\n    }")], False),
    ("K1 stores only: every block writes sentinels (timing only)",
     [("  if (plen > 0) {", "  if (plen < 0) {")], False),
)


K2_VARIANTS = (
    ("K2 as built: 4 slots per thread, 1,024-slot tiles", [], 1024, True),
    ("K2 16 slots per thread, 4,096-slot tiles",
     [("constexpr int kPer = 4;", "constexpr int kPer = 16;")], 4096, True),
    ("K2 8 slots per thread, 2,048-slot tiles",
     [("constexpr int kPer = 4;", "constexpr int kPer = 8;")], 2048, True),
    ("K2 dividing by n_cols", [("div_magic(ku, magic)", "ku / n_cols")], 1024, True),
    ("K2 without the tile pass's stores (timing only)",
     [("    if (vec) {\n      reinterpret_cast<int4*>(rows",
       "    if (n < 0) {\n      reinterpret_cast<int4*>(rows"),
      ("        if (j < nv) {\n          rows[i0 + j]",
       "        if (j < nv && n < 0) {\n          rows[i0 + j]")], 1024, False),
)


# K3: a persistent grid of k blocks per SM striding over the units, and
# the units a block takes per pass
def _persistent(k):
    return [("    const int grid = (units + kUnroll - 1) / kUnroll;\n",
             f"""    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (units + kUnroll - 1) / kUnroll;
    const int grid = blocks < sms * {k} ? blocks : sms * {k};
""")]


def _unroll(k):
    return [("constexpr int kUnroll = 2;", f"constexpr int kUnroll = {k};")]


# K3: each unit staged in shared memory and written by TMA bulk stores
# (cp.async.bulk, 4 KB per array per unit) instead of each thread's
# 16-byte stores
_TMA_STORES = [
    ("// One slot: masked (the sentinels stay) or the product.",
     """__device__ __forceinline__ void bulk_store(void* dst, const void* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))),
                  "r"(kUnitSlots * 4) : "memory");
}

// One slot: masked (the sentinels stay) or the product."""),
    ("  const unsigned n = static_cast<unsigned>(last);\n",
     """  const unsigned n = static_cast<unsigned>(last);
  __shared__ __align__(128) int4 s_out0[kUnroll][kThreads];
  __shared__ __align__(128) int4 s_out1[kPacked ? 1 : kUnroll][kThreads];
  __shared__ __align__(128) float4 s_vals[kUnroll][kThreads];
"""),
    ("gridDim.x * kUnroll) {\n",
     """gridDim.x * kUnroll) {
    // the last pass's bulk stores must have read the staging buffers
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
"""),
    ("""      const size_t o = p[k].out + l4;
      *reinterpret_cast<int4*>(out0 + o) = r0;
      if (!kPacked) *reinterpret_cast<int4*>(out1 + o) = r1;
      *reinterpret_cast<float4*>(vals + o) = v;
    }
  }
}""", """      s_out0[k][threadIdx.x] = r0;
      if (!kPacked) s_out1[k][threadIdx.x] = r1;
      s_vals[k][threadIdx.x] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {  // row 0: p[k].out is the unit's first slot
      for (int k = 0; k < kUnroll && u0 + k < units; ++k) {
        bulk_store(out0 + p[k].out, s_out0[k]);
        if (!kPacked) bulk_store(out1 + p[k].out, s_out1[k]);
        bulk_store(vals + p[k].out, s_vals[k]);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}"""),
]

# K3: (name, replacements in csrc/expand.cu, computes the kernel's
# function: held bit for bit to plain on every part)
K3_VARIANTS = (
    ("K3 as built: one launch per part, blocks of 8 warps, 2 8-row units per block, "
     "16-byte stores", [], True),
    ("K3 1 unit per block", _unroll(1), True),
    ("K3 4 units per block", _unroll(4), True),
    ("K3 persistent grid, 4 blocks per SM, 2 units per pass", _persistent(4), True),
    ("K3 persistent grid, 8 blocks per SM, 2 units per pass", _persistent(8), True),
    ("K3 persistent grid, 4 blocks per SM, 4 units per pass", _persistent(4) + _unroll(4), True),
    ("K3 TMA bulk stores (4 KB per array per unit), 2 units per block", _TMA_STORES, True),
    ("K3 TMA bulk stores, persistent grid, 4 blocks per SM", _TMA_STORES + _persistent(4), True),
    ("K3 streaming stores (st.global.cs, evict first)",
     [("""      *reinterpret_cast<int4*>(out0 + o) = r0;
      if (!kPacked) *reinterpret_cast<int4*>(out1 + o) = r1;
      *reinterpret_cast<float4*>(vals + o) = v;""",
       """      __stcs(reinterpret_cast<int4*>(out0 + o), r0);
      if (!kPacked) __stcs(reinterpret_cast<int4*>(out1 + o), r1);
      __stcs(reinterpret_cast<float4*>(vals + o), v);""")], True),
    ("K3 sentinels only: no A or B load (timing only)",
     [("      live[k] = u0 + k < units &&", "      live[k] = false && u0 + k < units &&")], False),
)


def _k5(threads, cols, cand, cap, unroll):
    return [("constexpr int kThreads = 128;", f"constexpr int kThreads = {threads};"),
            ("constexpr int kCols = 2;", f"constexpr int kCols = {cols};"),
            ("constexpr int kCand = 4;", f"constexpr int kCand = {cand};"),
            ("constexpr int kCap = 1024;", f"constexpr int kCap = {cap};"),
            ("constexpr int kUnroll = 16;", f"constexpr int kUnroll = {unroll};")]


K5_VARIANTS = (
    ("K5 as built: 128 threads x 2 columns, 16 loads in flight", []),
    ("K5 64 x 4, 8 in flight", _k5(64, 4, 4, 512, 8)),
    ("K5 128 x 4, 8 in flight", _k5(128, 4, 4, 512, 8)),
    ("K5 128 x 2, 8 in flight", _k5(128, 2, 4, 1024, 8)),
    ("K5 256 x 1, 8 in flight", _k5(256, 1, 2, 1024, 8)),
    ("K5 128 x 2, 16 in flight, 8 pairs per thread per round", _k5(128, 2, 8, 1024, 16)),
)


def build_variants(build, source, variants):
    """One library per variant, all built together; returns name → CDLL.
    A variant's replacements are (old, new) pairs in ``csrc/<source>.cu``,
    or the path of another source to build instead."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / f"{source}.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(variants):
        src = subs.read_text() if isinstance(subs, Path) else text
        for old, new in [] if isinstance(subs, Path) else subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {source}.cu")
            src = src.replace(old, new)
        cu = out_dir / f"{source}_{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"lib{source}_{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {' | '.join(regs)}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def device_ms(torch, fn, reps=5):
    """Summed kernel durations per run of ``fn`` (``torch.profiler``, one
    session over ``reps`` runs after a warm-up run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def _fetch_every_slot(np, CSR, merged):
    """The fetch before compaction on the card: every padded slot of the
    four streams copied to pageable host memory, masked and counted
    there."""
    valid = merged.valid.cpu().numpy()
    rows = merged.rows.cpu().numpy()[valid]
    cols = merged.cols.cpu().numpy()[valid]
    vals = merged.vals.cpu().numpy()[valid]
    indptr = np.zeros(merged.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=merged.shape[0]), out=indptr[1:])
    return CSR(merged.shape, indptr, cols, vals)


def _fetch_pageable(CSR, compact, merged):
    """``MergedCOO.to_csr`` with the copies into pageable host memory
    instead of pinned buffers."""
    _, cols, vals, indptr, _ = compact(merged.rows, merged.cols, merged.vals, merged.valid,
                                       nnz_pad=int(merged.nnz), m=merged.shape[0])
    return CSR(merged.shape, indptr.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy())


def _samples(samples):
    return ", ".join(f"{sum(x[:3]):.3f} [plan {x[0]:.3f}, device {x[1]:.3f}, fetch {x[2]:.3f}, "
                     f"{x[3]} cudaMalloc]" for x in samples)


def time_routes(torch, dev, a):
    """rmat14_ef8 A² (``a``) end to end in ``chip_smoke._split_ms``'s three
    stages. On the gather and tiled pipelines: the fetch to CSR by its
    two earlier routes (every padded slot to pageable memory, masked on
    the host; compacted on the card with pageable copies) beside the
    committed one (compacted, pinned buffers), and the host plan by the
    planner's Python loops beside its native core, and the pinned fetch
    while every earlier result is held. Then gather, tiles and
    flat in that order, ten samples each, each sample with its caching
    allocator cudaMalloc calls; and flat once more after the allocator's
    cache is emptied. Every result is held to scipy's."""
    import numpy as np

    from outerspace_tpu_torch.bench import strategy_fns
    from outerspace_tpu_torch.formats.csr import CSR
    from outerspace_tpu_torch.ops.chain import compact_to_csr_device
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
    from outerspace_tpu_torch.sched import gplanner

    want = spgemm_scipy(a, a)
    a_csc, a_csr = a.to_csc(), a.to_csr()

    def split(st, fetch=lambda merged: merged.to_csr(), samples=3):
        med, every, got = smoke._split_ms(torch, *strategy_fns(st, a_csc, a_csr, dev),
                                          samples=samples, fetch=fetch)
        assert_csr_allclose(got, want, rtol=smoke.VAL_RTOL, atol=smoke.VAL_ATOL)
        return med, every

    for st in ("gather", "tiles"):
        (plan_ms, device_ms, fetch_ms), _ = split(st)
        print(f"rmat14_ef8 {st}: host plan {plan_ms:.3f} ms, device {device_ms:.3f}, fetch to "
              f"CSR compacted to pinned buffers {fetch_ms:.3f}")
        for label, fetch in (
                ("every padded slot to pageable memory, masked on the host",
                 lambda merged: _fetch_every_slot(np, CSR, merged)),
                ("compacted, to pageable memory",
                 lambda merged: _fetch_pageable(CSR, compact_to_csr_device, merged))):
            (_, _, fetch_ms), _ = split(st, fetch)
            print(f"  fetch to CSR, {label}: {fetch_ms:.3f} ms")
        held = []
        _, every = split(st, lambda merged: held.append(merged.to_csr()) or held[-1])
        print(f"  fetch to CSR to pinned buffers, every earlier result still held (the host "
              f"allocator's cache has no free buffer): "
              + ", ".join(f"{x[2]:.3f}" for x in every) + " ms")
        del held
        native = (gplanner._cut_subtiles, gplanner._pack_groups)
        try:
            gplanner._cut_subtiles, gplanner._pack_groups = (gplanner._cut_subtiles_loop,
                                                             gplanner._pack_groups_loop)
            (plan_ms, _, _), _ = split(st)
        finally:
            gplanner._cut_subtiles, gplanner._pack_groups = native
        print(f"  host plan with the planner's Python loops: {plan_ms:.3f} ms")
    for st in ("gather", "tiles", "flat"):
        _, every = split(st, samples=10)
        print(f"rmat14_ef8 {st}, 10 samples, ms: {_samples(every)}")
    torch.cuda.empty_cache()
    _, every = split("flat")
    print(f"rmat14_ef8 flat after torch.cuda.empty_cache(), ms: {_samples(every)}")


def time_k1(torch, dev, plan, parent=None):
    """K1's variants on the gather parts of ``plan``; with ``parent``, a
    checkout of another tree, its K1 source too."""
    from outerspace_tpu_torch.ops.kernels import gexpand
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.runtime.build import device_args, tensor_ptr

    variants = list(K1_VARIANTS)
    if parent is not None:
        src = Path(parent) / "outerspace_tpu_torch" / "csrc" / "gexpand.cu"
        variants.insert(1, (f"K1 of the tree at {parent}", src, True))
    k1_parts = [((p.dev["bases"], p.dev["table"], p.dev["a_pack"], p.dev["b_pack"],
                  p.dev["group_bits"]), p.b_win) for p in plan.parts]
    k1_slots = sum(args[1].shape[0] * 8 * 1024 for args, _ in k1_parts)
    k1_bound = sum(smoke._k1_bytes(args[1].shape[0], p.nab8, p.nbb8, args[1].shape[0] * 8 * 1024)
                   for (args, _), p in zip(k1_parts, plan.parts)) / smoke.HBM_BYTES_PER_S * 1e3
    print(f"K1 on {len(k1_parts)} gather parts, {k1_slots} slots (bound {k1_bound:.4f} ms by bytes):")
    libs = build_variants(build, "gexpand", [v[:2] for v in variants])
    spin = smoke._spin_cycles(torch, ms=60.0)  # room for a stalled host
    # the card's rate for K1's output alone: the same keys and values
    # buffers written by torch's fill (5 x 2 launches)
    outs = [(torch.empty(a[1].shape[0] * 8 * 1024, dtype=torch.int32, device=dev),
             torch.empty(a[1].shape[0] * 8 * 1024, dtype=torch.float32, device=dev))
            for a, _ in k1_parts]
    ms = smoke._device_ms(torch, lambda: [(k.fill_(7), v.fill_(1.0)) for k, v in outs], spin)
    print(f"  torch fill_ of the same output buffers (reference): {ms:.4f} ms, "
          f"{100 * k1_bound / ms:.1f}% of the bound")
    del outs
    for name, _, computes in variants:
        launch = libs[name].gexpand_launch
        launch.argtypes, launch.restype = gexpand.KERNEL.argtypes, ctypes.c_int

        def k1():
            outs = []
            for args, b_win in k1_parts:
                g = args[1].shape[0]
                keys = torch.empty(g * 8 * 1024, dtype=torch.int32, device=dev)
                vals = torch.empty(g * 8 * 1024, dtype=torch.float32, device=dev)
                err = launch(*map(tensor_ptr, args), tensor_ptr(keys), tensor_ptr(vals), g,
                             args[2].shape[0], args[3].shape[0], b_win, *device_args(dev))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                outs.append((keys, vals))
            return outs

        if computes:
            got = k1()
            torch.cuda.synchronize()
            for (args, b_win), (k, v) in zip(k1_parts, got):
                kp, vp = gexpand.expand_gather_plain(*args, b_win=b_win)
                if not (torch.equal(k, kp) and torch.equal(v.view(torch.int32), vp.view(torch.int32))):
                    raise RuntimeError(f"{name} disagrees with the plain version on a gather part")
        ms = smoke._device_ms(torch, k1, spin)
        print(f"  {name}: {ms:.4f} ms, {100 * k1_bound / ms:.1f}% of the bound"
              f"{' (== plain)' if computes else ''}")


def time_k2(torch, dev, plan):
    """K2's variants on the sorted streams of the gather parts of ``plan``."""
    from outerspace_tpu_torch.ops.kernels import gexpand, scan
    from outerspace_tpu_torch.ops.spgemm import I32_MAX
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.runtime.build import device_args, tensor_ptr

    # K2's inputs: the sorted, sentinel-padded streams of each gather part
    streams = []
    for p in plan.parts:
        d = p.dev
        key, val = gexpand.expand_gather(d["bases"], d["table"], d["a_pack"], d["b_pack"],
                                         d["group_bits"], b_win=p.b_win)
        extra = p.merge_pad - key.shape[0]
        key = torch.cat([key, key.new_full((extra,), I32_MAX)])
        val = torch.cat([val, val.new_zeros(extra)])
        skey, order = torch.sort(key)
        streams.append((skey, val[order], p.merge_pad - p.p_real))
    k2_bytes = sum(k.numel() * 21 + 4 for k, _, _ in streams)
    k2_bound = k2_bytes / smoke.HBM_BYTES_PER_S * 1e3

    print(f"K2 on {len(streams)} streams of {streams[0][0].numel()} slots "
          f"(bound {k2_bound:.4f} ms by bytes):")
    libs = build_variants(build, "scan", [(v[0], v[1]) for v in K2_VARIANTS])
    for name, _, tile, exact in K2_VARIANTS:
        launch = libs[name].scan_launch
        launch.argtypes, launch.restype = scan.KERNEL.argtypes, ctypes.c_int
        bufs = []
        for k, v, pad in streams:
            n = k.numel()
            outs = [torch.empty(n, dtype=t, device=dev)
                    for t in (torch.int32, torch.int32, torch.float32, torch.bool)]
            outs.append(torch.empty((), dtype=torch.int32, device=dev))
            outs.append(torch.empty(-(-n // (4 * tile)) * 4 * 6, dtype=torch.int32, device=dev))
            bufs.append((k, v, pad, outs))

        def run():
            for k, v, pad, o in bufs:
                err = launch(tensor_ptr(k), tensor_ptr(v), *map(tensor_ptr, o), o[5].numel(),
                             k.numel(), plan.n, plan.m, int(pad), *device_args(dev))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        if exact:
            for k, v, pad, o in bufs:
                want = scan.merge_epilogue_plain(k, v, pad, n_cols=plan.n, sentinel_row=plan.m)
                if not all(torch.equal(o[i], want[i]) for i in (0, 1, 3, 4)) or not torch.allclose(
                        o[2], want[2], rtol=smoke.VAL_RTOL, atol=smoke.VAL_ATOL):
                    raise RuntimeError(f"{name} disagrees with the plain version")
        ms = device_ms(torch, run)
        print(f"  {name}: {ms:.4f} ms, {100 * k2_bound / ms:.1f}% of the bound"
              f"{' (== plain)' if exact else ''}")



def time_k3(torch, dev, a, parent=None):
    """K3's variants on the class tables of rmat14_ef8's (``a``) tiled row
    parts, one launch per part; the committed kernel also one launch per
    (part, class) table; with ``parent``, the K3 source of another
    checkout, one launch per table (its per-task design takes one class
    at a time)."""
    import numpy as np

    from outerspace_tpu_torch.ops.kernels import expand
    from outerspace_tpu_torch.ops.spgemm import plan_tiled_parts, spgemm_padded_tiled_parts
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.runtime.build import device_args, tensor_ptr

    tplan = plan_tiled_parts(a.to_csc(), a.to_csr(), device=dev)
    kernel = expand.KERNEL_PACKED
    spgemm_padded_tiled_parts(tplan)  # loads the committed library
    groups = [(tp.group, tp.n) for _, _, tp in tplan.parts if tp.group is not None]
    tables = [(s, d, tp.n) for _, _, tp in tplan.parts for s, d in tp.class_tables()]
    nbytes = sum(sum(smoke._expand_bytes(np, s, 8).values()) for s, _, _ in tables)
    bound = smoke._bound(nbytes, sum(s.heavy_p for s, _, _ in tables))[0]
    slots = sum(g.slots for g, _ in groups)
    print(f"K3 on {len(groups)} parts, {len(tables)} class tables "
          f"({[g.layout for g, _ in groups]}), {slots} slots (bound {bound:.4f} ms by bytes):")
    outs = [(torch.empty(g.slots, dtype=torch.int32, device=dev),
             torch.empty(g.slots, dtype=torch.float32, device=dev)) for g, _ in groups]
    wants = []
    for (g, n), _ in zip(groups, outs):
        w = (torch.empty(g.slots, dtype=torch.int32, device=dev),
             torch.empty(g.slots, dtype=torch.float32, device=dev))
        expand.expand_part_packed_plain(g, n_cols=n, out_keys=w[0], out_vals=w[1])
        wants.append(w)
    spin = smoke._spin_cycles(torch, ms=60.0)
    ms = smoke._device_ms(torch, lambda: [(k.fill_(7), v.fill_(1.0)) for k, v in outs], spin)
    print(f"  torch fill_ of the same output buffers (reference, {2 * len(outs)} launches): "
          f"{ms:.4f} ms, {100 * bound / ms:.1f}% of the bound")
    whole = (torch.empty(slots, dtype=torch.int32, device=dev),
             torch.empty(slots, dtype=torch.float32, device=dev))
    ms = smoke._device_ms(torch, lambda: (whole[0].fill_(7), whole[1].fill_(1.0)), spin)
    print(f"  torch fill_ of two buffers of all {slots} slots (reference, 2 launches): "
          f"{ms:.4f} ms, {100 * bound / ms:.1f}% of the bound")
    del whole

    def check(name):
        torch.cuda.synchronize()
        for (k, v), (wk, wv) in zip(outs, wants):
            if not (torch.equal(k, wk) and torch.equal(v.view(torch.int32), wv.view(torch.int32))):
                raise RuntimeError(f"{name} disagrees with the plain version on a part")
            k.fill_(0)
            v.fill_(0.0)

    variants = [v[:2] for v in K3_VARIANTS]
    parent_name = None
    if parent is not None:  # built with the rest: one library name each
        parent_name = f"K3 of the tree at {parent}"
        variants.append((parent_name, Path(parent) / "outerspace_tpu_torch" / "csrc" / "expand.cu"))
    libs = build_variants(build, "expand", variants)
    for name, _, computes in K3_VARIANTS:
        launch = libs[name].expand_packed_launch
        launch.argtypes, launch.restype = expand.KERNEL_PACKED.argtypes, ctypes.c_int

        def run(launch=launch, name=name):
            for (g, n), (k, v) in zip(groups, outs):
                desc = np.ascontiguousarray(g.desc)
                err = launch(ctypes.c_void_p(desc.ctypes.data), desc.shape[0],
                             *map(tensor_ptr, (g.tasks, g.a_rows, g.a_vals, g.b_cols_blk,
                                               g.b_vals_blk, k, v)), n, *device_args(dev))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

        run()
        if computes:
            check(name)
        ms = smoke._device_ms(torch, run, spin)
        pipe = ""
        if computes:  # the tiles device pipeline (expand, sort, K2) with this K3
            committed = kernel._fn, kernel._lib
            kernel._fn, kernel._lib = launch, libs[name]
            try:
                pipe_ms = smoke._device_ms(torch, lambda: spgemm_padded_tiled_parts(tplan), spin)
            finally:
                kernel._fn, kernel._lib = committed
            pipe = f"; the tiles device pipeline with it {pipe_ms:.4f} ms"
        print(f"  {name}: {ms:.4f} ms in {len(groups)} launches, "
              f"{100 * bound / ms:.1f}% of the bound{' (== plain)' if computes else ''}{pipe}")
    # one launch per (part, class) table: the committed kernel on groups
    # of one class, and the parent's per-task kernel
    per_table = [("K3 as built, one launch per table", libs[K3_VARIANTS[0][0]], True)]
    if parent_name is not None:
        per_table.append((f"{parent_name}, one launch per table", libs[parent_name], False))
    t_outs = [(torch.empty(s.padded_heavy, dtype=torch.int32, device=dev),
               torch.empty(s.padded_heavy, dtype=torch.float32, device=dev)) for s, _, _ in tables]
    for name, lib, grouped in per_table:
        launch = lib.expand_packed_launch
        launch.restype = ctypes.c_int
        launch.argtypes = (expand.KERNEL_PACKED.argtypes if grouped else
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_int, ctypes.c_void_p])

        def run(launch=launch, grouped=grouped, name=name):
            for (s, d, n), (k, v) in zip(tables, t_outs):
                args = [tensor_ptr(d[x]) for x in
                        ("tasks", "a_rows_t", "a_vals_t", "b_cols_blk", "b_vals_blk")]
                if grouped:
                    desc = expand.group_descriptor([(s.tile_a, s.ntasks_padded)])
                    err = launch(ctypes.c_void_p(desc.ctypes.data), 1, *args, tensor_ptr(k),
                                 tensor_ptr(v), n, *device_args(dev))
                else:
                    err = launch(*args, tensor_ptr(k), tensor_ptr(v), s.ntasks_padded,
                                 s.tile_a, n, *device_args(dev))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        for (s, d, n), (k, v) in zip(tables, t_outs):
            wk, wv = expand.expand_tiles_packed_plain(
                *(d[x] for x in ("tasks", "a_rows_t", "a_vals_t", "b_cols_blk", "b_vals_blk")),
                tile_a=s.tile_a, n_cols=n)
            if not (torch.equal(k, wk) and torch.equal(v.view(torch.int32), wv.view(torch.int32))):
                raise RuntimeError(f"{name} disagrees with the plain version on a table")
        ms = smoke._device_ms(torch, run, spin)
        print(f"  {name}: {ms:.4f} ms in {len(tables)} launches, "
              f"{100 * bound / ms:.1f}% of the bound (== plain)")


def time_k5(torch, dev):
    """K5's variants on the layers of one MLP1w and one LeNet forward."""
    import numpy as np
    from outerspace_tpu_torch.convert import load_params
    from outerspace_tpu_torch.nn import sparse_infer
    from outerspace_tpu_torch.nn.data import synthetic_mnist
    from outerspace_tpu_torch.ops.kernels import spmm
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.runtime.build import device_args, tensor_ptr

    # K5's inputs: each layer's staged W and padded X from one forward each
    calls = []
    real = sparse_infer.spmm_blockell_device

    def catch(meta, blocks, x, tn):
        calls.append((meta, blocks, x.clone(), tn))
        return real(meta, blocks, x, tn)

    data = synthetic_mnist(smoke.REQUESTS * smoke.MLP_BATCH, seed=0)
    images = np.concatenate([data[k][0] for k in ("train", "val", "test")])
    sparse_infer.spmm_blockell_device = catch
    try:
        sparse_infer.SparseMLP(load_params(smoke.WEIGHTS / "MLP1w" / "prune0p01_finetuned.pkl"),
                               device=dev)(images[:smoke.MLP_BATCH].reshape(-1, 784))
        sparse_infer.SparseLeNet(load_params(smoke.WEIGHTS / "LeNet" / "pruned_finetuned"),
                                 device=dev)(images[:smoke.LENET_BATCH].reshape(-1, 28, 28, 1))
    finally:
        sparse_infer.spmm_blockell_device = real

    print(f"K5 on {len(calls)} layers:")
    wants = [spmm.spmm_blockell_plain(*c[:3]) for c in calls]
    for name, lib in build_variants(build, "spmm", K5_VARIANTS).items():
        launch = lib.spmm_launch
        launch.argtypes, launch.restype = spmm.KERNEL.argtypes, ctypes.c_int
        outs = [torch.empty((c[1].shape[0] * c[1].shape[2], c[2].shape[1]), device=dev)
                for c in calls]

        def one(i):
            meta, blocks, x, tn = calls[i]
            nrb, mb, bm, bn = blocks.shape
            err = launch(tensor_ptr(meta), tensor_ptr(blocks), tensor_ptr(x), tensor_ptr(outs[i]),
                         nrb, mb, bm, bn, x.shape[1], tn, *device_args(dev))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        for i in range(len(calls)):
            one(i)
        torch.cuda.synchronize()
        for o, w in zip(outs, wants):
            if float((o - w).abs().max()) > smoke.K5_REL * float(w.abs().max()):
                raise RuntimeError(f"{name} disagrees with the plain version")
        per = [device_ms(torch, lambda i=i: one(i)) for i in range(len(calls))]
        print(f"  {name}: {sum(per):.4f} ms for the 8 layers (MLP1w {sum(per[:3]):.4f}, "
              f"LeNet {sum(per[3:]):.4f}; per layer {', '.join(f'{p:.4f}' for p in per)}; == plain)")


def world_stamp() -> dict:
    """A rank's clock when it starts the function, after a first op on
    its card, and after a barrier of its world."""
    import time

    import torch
    import torch.distributed as dist

    t0 = time.time()
    torch.zeros(1, device="cuda").sum().item()
    t1 = time.time()
    dist.barrier()
    return {"fn_start": t0, "cuda_ready": t1, "barrier": time.time()}


def time_worlds():
    """Empty worlds on the card (one nccl rank, one and eight gloo ranks):
    the host clock from spawn to the function, to the barrier and to the
    launcher's return."""
    import time

    from outerspace_tpu_torch.shard.mesh import run_world

    for backend, n in (("nccl", 1), ("gloo", 1), ("gloo", 8)):
        t = time.time()
        res = run_world(world_stamp, n, backend=backend, device="cuda", timeout=300)
        end = time.time()
        starts = [r["fn_start"] - t for r in res]
        print(f"empty world, {backend} x{n}: spawn to the function {min(starts):.3f}-"
              f"{max(starts):.3f} s, first op on the card +"
              f"{max(r['cuda_ready'] - r['fn_start'] for r in res):.3f} s, barrier "
              f"{max(r['barrier'] for r in res) - t:.3f} s, spawn to exit {end - t:.3f} s")


def main(argv) -> int:
    """``argv``: what to time (K1, K2, K3, K5, ROUTES, WORLDS), all by default, and
    ``--parent DIR`` (see the module's docstring)."""
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from outerspace_tpu_torch.formats import rmat
    from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather

    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    which = argv or ["K1", "K2", "K3", "K5", "ROUTES", "WORLDS"]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {smoke._card_line()}")
    a = rmat(14, edge_factor=8, seed=1)
    plan = plan_spgemm_gather(a.to_csc(), a.to_csr(), device=dev)
    if "K1" in which:
        time_k1(torch, dev, plan, parent)
    if "K2" in which:
        time_k2(torch, dev, plan)
    if "K3" in which:
        time_k3(torch, dev, a, parent)
    if "K5" in which:
        time_k5(torch, dev)
    if "ROUTES" in which:
        time_routes(torch, dev, a)
    if "WORLDS" in which:
        time_worlds()
    print(smoke._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
