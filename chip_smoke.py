#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels (``outerspace_tpu_torch/csrc/*.cu``,
into ``build/``) and its host libraries (``csrc/*.cpp``, g++: the planner
core, the Matrix Market reader, the CPU reference SpGEMM), and drives ``spgemm(A, A)`` through the user entry point on each path,
checking every result exactly against scipy:

- the windowed-gather pipeline (K1, sort, K2) on rmat14_ef8 and er100k;
- the tiled pipeline on rmat14_ef8, packed (K3, K1, sort, K2) and with
  ``packed=False`` (K4, K1, the two-key merge), K3 / K4 launched once
  per row part over its class tables, and on er100k (rebased row parts);
- the flat strategy (the flat expand, sort, K2) on the three
  ``data/mtx`` fixtures, one with a pinned ``p_pad``;
- ``strategy="auto"`` on rmat14_ef8 and er100k, with the cost model's
  pick and modeled costs beside each strategy's measured time;
- triangle counting on rmat(13, edge_factor=8, seed=4) by the dense
  route, the sparse route (K3, K1, sort, K2, bitmap sum) and "auto",
  each count equal to scipy's;
- Markov clustering on mcl_rmat14_4iter (rmat(14, edge_factor=8,
  seed=7), 4 iterations): cold, warm and cached ``mcl_run``, the exact
  fallbacks and a tiled first squaring, each against scipy's MCL with
  the cluster sets equal; a warm run's launches (the first squaring's
  K1 / K2, prune_compact once, then K2 once plus twice and loop_expand
  once per loop iteration) and host reads (at most 2) counted; K2 held
  to its plain version on the loop's streams, and loop_expand bit for
  bit on the loop's largest expand, timed beside its bound and the plain
  version's time;
- the prune and compaction after the MCL chain's first squaring at the
  shape of the benchmark's rmat15_ef16.mcl4 cell (its graph from the
  benchmark's generator): the merged stream's slots, valid slots and
  survivors, the kernel bit-equal to its plain version, its time beside
  its bound (5 B a slot) and the plain version's;
- the 64-bit-key kernels (n² ≥ 2³²) at the shapes of the benchmark's
  lfr19_k20_mu03.mcl4 cell: a warm ``mcl_run``'s launches (K2_64 and
  loop_expand_64 once a loop iteration, prune_compact_64 once, the
  32-bit prune_compact and loop_expand never); prune_compact_64 on its
  first squaring's stream and loop_expand_64 on its largest loop expand
  bit-equal to their plain versions and K2_64 on its largest loop merge
  equal to its plain version, each timed beside its bound and the plain
  version's time;
- sparse-NN inference: ``SparseMLP`` (MLP1w 784-1000-1000-10, pruned to
  1%) at batch 1024 and ``SparseLeNet`` (pruned LeNet) at batch 256, with
  the committed trained weights, each serving four requests through K5
  and checked against the dense torch model on the card (TF32 off); and
  ``lenet_forward_spgemm`` on 8 images through SpGEMM (K1, K2);
- the NN training pipeline at batch 1024 on ``synthetic_mnist(32768)``:
  MLP1w and LeNet trained for 3 epochs, magnitude-pruned (fc 0.1, conv
  0.25) and finetuned for 2 on the card, no pruned weight back, test
  accuracy above 0.6, each served for four requests through
  ``SparseMLP`` / ``SparseLeNet`` (K5 3 / 5 times per request) within
  ``NN_REL`` of the dense model; three training steps on the card held
  to three on the CPU (float64; one float32 step's loss and gradients);
  ``cli nn --mode pf`` on the card and its pickle served; an exported
  layer (``act_1 × fc2_weightᵀ``) through ``spgemm`` against scipy; and
  each model's step time (CUDA events), images/s, one epoch on the host
  clock and the device's idle share over 10 steps;
- the command line (``cli.main``), its files under
  ``build/chip_smoke_cli/``: rmat14_ef8 written and read back by the
  native and the Python reader, plain and gzipped, all equal; ``spgemm``
  A² by gather, tiles, flat and auto (nnz 8,741,118 and 16,822,071
  flops, each strategy's kernels launched), its measured ms beside its
  roofline lines and the same strategy's end-to-end split; ``spgemm
  --out`` of rmat10_ef8 · rmat10_ef8ᵀ read back against scipy;
  ``graph triangles`` of rmat13 by both routes (315,423) and ``graph
  mcl`` of mcl_rmat14_4iter (its cluster count equal to scipy's MCL);
  the microbench suite; ``ref_spgemm_native`` on rmat14_ef8 against
  scipy, timed beside it;
- the sharded mode (``shard/``, on ``torch.distributed``; the ranks are
  spawned processes, each counting its own launches): a world of one
  nccl rank runs ``spgemm_sharded_tiled`` on rmat(13, edge_factor=8,
  seed=7) A² against scipy and on rmat(16, edge_factor=8, seed=5) A²
  (m·n = 2³², rebased keys) against the single-device ``spgemm``, each
  timed beside the single-device tiles pipeline, the rank's K3 and K1
  inputs held bit for bit to plain and K2 to plain on the received
  buffers; a world of 8 gloo ranks sharing the
  card runs rmat14_ef8 A² by the 1-D, 2-D and tiled programs (the tiled
  one also on (4, 2) with 2 exchange chunks), the JAX dryrun's operands
  (nnz 4546, 5401, the rebased 8) and ``triangle_count_sharded`` of
  rmat13 on (4, 2), each exact; ``spgemm --mesh 1``, ``spgemm --mesh
  4,2 --dist-backend gloo`` and ``graph triangles --mesh 4,2
  --dist-backend gloo`` through the command line, side by side; and in
  the same worlds the sharded Markov clustering of mcl_rmat14_4iter by
  the device-resident loop (one nccl rank, 8 gloo ranks on (8,) and
  (4, 2)) and the host-planned loop (one rank, 8 ranks) against scipy's
  MCL, ``SparseMLP.sharded`` (dp 1 and 8) bit-identical to one device,
  the dp × tp MLP1w training step against one device, the multi-device
  dry run's jobs with its line, and ``graph mcl --mesh`` by both loops.

- the benchmark suite (``outerspace_tpu_torch.bench.run_suite``, in
  process, after the command line) on mtx_rmat10_a2, rmat14_ef8,
  sparse_mlp_infer_b1024_spmm and triangles_rmat13: its records and
  headline printed, the headline's shape and value checked, every
  record's exactness fields true and its path's kernels launched;

- the event model (``perf/perfsim.py`` over ``csrc/perfsim.cpp``, built
  with g++): its machine printed beside the fields ``perf/simcal.py``
  measures on this card, its four selftests passed under that machine;
  ``spgemm``'s event-model multiply and merge over K3's (tiles) or K1's
  (gather) device ms and sort + K2's; ``predict`` of rmat14_ef8 on
  (1,), (4,), (2, 2) and (8,) (host only, no launch); the event model
  of each one-rank nccl program and of the sharded MCL device loop's
  (1,) iteration beside its measured time; ``spgemm --mesh``'s
  event-model line over its measured time.

Each path's kernel launch counts are set to 0 just before its run and
read just after; a kernel of the path that was not launched fails the
run. Then it holds each kernel against its plain PyTorch version on the
card at the main path's shapes (K1 on every gather part and tiled
residue of both operands; K3 and K4 on every class table one by one and
on every part of the rmat14_ef8, er100k and MCL tiled plans at once),
and times the kernels (K3 and K4 one launch per part, and one per table
beside it), ``torch.sort``
and ``torch.matmul`` of K5's densified weights (CUDA events, the
device's time alone and with the host's launches), the plain versions
(CUDA events), each pipeline's end-to-end split (the host clock; the
host plan also with the planner's Python loops, the fetch also by the
pageable copy of every padded slot and by pinned buffers), and each
pipeline's and kernel's device activity (``torch.profiler``). From
device-only times it derives the cost model's per-element weights and
the triangle selector's two weights, and prints them.

Output: one line per phase with its seconds, a ``{"kernels": [...]}``
JSON line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits nonzero and
prints no last line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

# the card's memory rate and float32 peak outside the tensor cores: the
# spec-sheet values of the port's roofline config, one source for the
# kernels' bounds here and the command line's roofline
from outerspace_tpu_torch.perf.roofline import GPUConfig  # noqa: E402

HBM_BYTES_PER_S = GPUConfig().hbm_bw_bytes
FP32_OPS_PER_S = GPUConfig().fp32_ops
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6  # summation order differs from the oracle
NN_REL = 1e-5  # NN output vs the dense model, relative to its max |y|
K5_REL = 1e-6  # K5 vs its plain version, relative to max |y|
ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "data" / "saved_weights"
MLP_BATCH, LENET_BATCH, REQUESTS = 1024, 256, 4
NN_TRAIN_IMAGES, NN_BATCH = 32768, 1024  # the nn training phase's data and batch
MCL_ITERS = 4
MCL_RTOL, MCL_ATOL = 5e-4, 1e-5  # the JAX package's MCL tolerance (tests/test_chain.py)
# device ms (profiler) of the kernels' earlier designs on an NVIDIA H100
# 80GB HBM3 at 700 W, printed beside this run's for comparison
K5_BEFORE_MS = {"MLP1w": "0.3551-0.3603", "LeNet": "0.1444-0.1485"}
K2_BEFORE_MS = "0.3398-0.3462"
K1_BEFORE_MS = {"gather": "0.1644 device-only events, 0.1570 profiler",
                "tiles": "0.1172 profiler"}
K34_BEFORE_MS = ("K3 0.0447 device-only events / 0.3633 with the host's launches in 9, "
                 "K4 0.0552 / 0.4000 in 9")


def _phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _bound(nbytes: int, fp32_ops: int) -> tuple[float, str]:
    """Least time on the card, in ms, and what sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _median_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _spin_cycles(torch, ms: float = 20.0) -> int:
    """Cycles of ``torch.cuda._sleep`` that hold the stream ~``ms``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    return int(ms / start.elapsed_time(end) * 1_000_000)


def _device_ms(torch, fn, spin: int, reps: int = 10) -> float:
    """Median device time of ``fn`` by CUDA events, the host's launch cost
    left out: a spin kernel of ``spin`` cycles holds the stream while the
    host queues every launch of ``fn`` between the two events, so the
    events time the device's work back to back. ``fn`` must not
    synchronise; if the spin ends before the host has queued it all, the
    run fails."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        if start.query():
            raise RuntimeError("the spin ended before the host queued every launch")
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _split_ms(torch, plan_fn, run_fn, samples: int = 3, fetch=lambda merged: merged.to_csr()):
    """End to end in three stages (host plan incl. staging, device
    pipeline, fetch to CSR), host clock. Returns the median sample by
    total, every sample as (plan, device, fetch, the caching allocator's
    cudaMalloc calls during it), and the last sample's fetched result.
    A sample's plan, result and fetched result are released before the
    next sample, so each reuses the blocks the caching allocators hold
    (device memory, and the pinned host buffers of the fetch)."""
    splits = []
    for _ in range(samples):
        got = None
        mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        ta = time.perf_counter()
        plan = plan_fn()
        torch.cuda.synchronize()
        tb = time.perf_counter()
        merged = run_fn(plan)
        torch.cuda.synchronize()
        tc = time.perf_counter()
        got = fetch(merged)
        td = time.perf_counter()
        mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - mallocs
        splits.append(((tb - ta) * 1e3, (tc - tb) * 1e3, (td - tc) * 1e3, mallocs))
        del plan, merged
    return sorted(splits, key=lambda x: sum(x[:3]))[len(splits) // 2][:3], splits, got


# kernel name fragments (as CUPTI reports the demangled names) by kernel;
# K2 is its tile pass and its carry pass
# (the 64-bit instantiations first: their names extend the 32-bit ones')
_FAMILIES = (("K2_64", "::scan_tile_kernel_wide"), ("K2_64 carry", "::scan_carry_kernel_wide"),
             ("prune_compact_64", "::prune_compact_kernel_wide"),
             ("prune_compact_64 tail", "::prune_compact_tail_wide"),
             ("loop_expand_64", "::loop_expand_kernel_wide"),
             ("loop_expand", "::loop_expand_kernel"),
             ("K1", "::gexpand_kernel"), ("K2", "::scan_tile_kernel"),
             ("K2 carry", "::scan_carry_kernel"), ("K3", "::expand_kernel<true>"),
             ("K4", "::expand_kernel<false>"), ("K5", "::spmm_kernel"),
             ("prune_compact", "::prune_compact_kernel"),
             ("prune_compact tail", "::prune_compact_tail"))


def _profile(torch, fn):
    """Device activity over one call of ``fn`` (after a warm-up call),
    from torch.profiler's CUPTI trace: ({kernel: [ms, launches]} with the
    port's kernels by name, the sort kernels as "torch.sort" and
    everything else as "other", busy ms, span ms from the first device
    activity's start to the last one's end, {name: [ms, launches]} of the
    "other" kernels), or None when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    by, others = {}, {}

    def add(table, key, ms):
        entry = table.setdefault(key, [0.0, 0])
        entry[0] += ms
        entry[1] += 1

    for e in dev:
        name = next((k for k, frag in _FAMILIES if frag in e.name),
                    "torch.sort" if "sort" in e.name.lower() else "other")
        add(by, name, e.time_range.elapsed_us() / 1e3)
        if name == "other":
            add(others, e.name, e.time_range.elapsed_us() / 1e3)
    busy = sum(ms for ms, _ in by.values())
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    return by, busy, span, others


def _profile_line(torch, label, fn, top: int = 0) -> dict:
    """Prints the device activity over one call of ``fn`` (with the
    ``top`` costliest "other" kernels by name); returns the device ms by
    kernel (empty when nothing was recorded)."""
    got = _profile(torch, fn)
    if got is None:
        print(f"{label} (profiler): no device activity recorded; not measured")
        return {}
    by, busy, span, others = got
    parts = ", ".join(f"{k} {ms:.4f} ms in {n}" for k, (ms, n) in sorted(by.items()))
    print(f"{label} (profiler): device busy {busy:.4f} ms of a {span:.4f} ms span "
          f"(idle {100 * (1 - busy / span):.1f}%); {parts}")
    if top:
        costly = sorted(others.items(), key=lambda kv: -kv[1][0])[:top]
        print("  its costliest other kernels: " + "; ".join(
            f"{name[:90]} {ms:.4f} ms in {n}" for name, (ms, n) in costly))
    return {k: ms for k, (ms, _) in by.items()}


def _expand_bytes(np, sched, out_bytes: int) -> dict:
    """Bytes K3 / K4 read and write for one class table, each once:
    "tasks", every task row (16 B, padding tasks included: the kernel
    reads each to learn its masks); "a", the (row, value) pair (8 B) of
    each live A element of each task with a live lane (the tables hold
    an A slice per task); "b", the (col, value) pair of each distinct
    live B lane; "out", ``out_bytes`` per output slot of the padded
    table. The group's descriptor travels in the launch's parameters."""
    live = sched.b_hi > sched.b_lo
    a_elems = int(sched.a_len[live].sum())
    starts = sched.b_block.astype(np.int64) * 128 + sched.b_lo
    ends = sched.b_block.astype(np.int64) * 128 + np.maximum(sched.b_hi, sched.b_lo)
    edges = np.zeros((int(sched.b_block.max()) + 1) * 128 + 1, np.int64)
    np.add.at(edges, starts, 1)
    np.add.at(edges, ends, -1)
    b_lanes = int((np.cumsum(edges)[:-1] > 0).sum())
    return {"tasks": 16 * sched.ntasks_padded, "a": 8 * a_elems, "b": 8 * b_lanes,
            "out": out_bytes * sched.padded_heavy}


def _k1_bytes(groups: int, nab8: int, nbb8: int, slots: int) -> int:
    """Bytes K1 must move for one call: per group the base pair, the
    search depth, table lanes 0-3 and 6 of each of its 8 subtiles and
    lane 5 (n_cols) of one; the call's own A and B blocks (not the zero
    blocks that pad parts to one shape, which the clamped reads never
    reach); 8 B per output slot."""
    return (groups * (2 * 4 + 4 + 8 * 5 * 4 + 4) + nab8 * 8 * 4 * 128 * 4
            + nbb8 * 8 * 2 * 128 * 4 + slots * 8)


def _host_ms(fn, samples: int = 3) -> float:
    """Median wall time of ``fn`` (which ends on the host), ms."""
    times = []
    for _ in range(samples):
        ta = time.perf_counter()
        fn()
        times.append((time.perf_counter() - ta) * 1e3)
    return statistics.median(times)


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _k5_work(np, meta, blocks, x) -> tuple[int, int]:
    """Bytes K5 must move for one call (the stored blocks of the valid
    slots, the X rows of each distinct block column they name, the meta,
    Y) and its float32 operations (2·bm·bn·N_pad per valid slot)."""
    nrb, mb, bm, bn = blocks.shape
    n_pad = x.shape[1]
    m = meta.cpu().numpy().reshape(nrb, mb, 3)
    valid = m[:, :, 1] != 0
    pairs = int(valid.sum())
    x_rows = np.unique(m[:, :, 0][valid]).size * bn
    nbytes = 4 * (pairs * bm * bn + x_rows * n_pad + meta.numel() + nrb * bm * n_pad)
    return nbytes, 2 * bm * bn * n_pad * pairs


def _k5_real_work(torch, meta, blocks, dims) -> tuple[int, int, int]:
    """The work a layer's inputs need: bytes of the valid slots' stored
    blocks, of each X row that some nonzero weight needs (once, at the
    unpadded column count) and of the unpadded Y (out_dim × columns);
    operations 2 per weight nonzero and column. Also the nonempty block
    columns (valid slot, k): the list K5 walks."""
    nrb, mb, bm, bn = blocks.shape
    _, out_dim, cols = dims
    valid = meta[:, 1] != 0
    stored = blocks.reshape(nrb * mb, bm, bn)[valid] != 0
    col_nz = stored.any(dim=1)  # [valid slots, bn]
    x_rows = meta[valid, 0].long()[:, None] * bn + torch.arange(bn, device=meta.device)
    needed = int(torch.unique(x_rows[col_nz]).numel())
    nbytes = 4 * (int(valid.sum()) * bm * bn + needed * cols + out_dim * cols)
    return nbytes, 2 * int(stored.sum()) * cols, int(col_nz.sum())


def _dense_w(torch, meta, blocks, k_pad):
    """K5's W as a dense padded (nrb·bm, K_pad) matrix on the card."""
    nrb, mb, bm, bn = blocks.shape
    w = torch.zeros((nrb, bm, k_pad // bn, bn), device=blocks.device)
    m = meta.view(nrb, mb, 3).long()
    for s in range(mb):
        ok = m[:, s, 1] != 0
        rb = torch.arange(nrb, device=blocks.device)[ok]
        w[rb, :, m[ok, s, 0]] += blocks[rb, m[ok, s, 2]]
    return w.reshape(nrb * bm, k_pad)

def _csr_equal(np, got, want, label: str) -> None:
    """nnz, indptr and indices exact, values within the MCL tolerance."""
    if got.nnz != want.nnz:
        raise RuntimeError(f"{label}: nnz {got.nnz}, scipy {want.nnz}")
    for name in ("indptr", "indices"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise RuntimeError(f"{label}: {name} differ from scipy's")
    if not np.allclose(got.data, want.data, rtol=MCL_RTOL, atol=MCL_ATOL):
        err = float(np.abs(got.data - want.data).max())
        raise RuntimeError(f"{label}: values differ from scipy's (max |err| {err:.3e})")


def _stage1_launches(tplan) -> dict:
    """K1, K2 and K3 launches of one first squaring over ``tplan``: per
    gather part K1 and K2; per tiled part K2, K1 on a residue and K3 once
    over its class tables."""
    from outerspace_tpu_torch.ops.gather_pipeline import GatherPipelinePlan

    if isinstance(tplan, GatherPipelinePlan):
        return {"K1": len(tplan.parts), "K2": len(tplan.parts), "K3": 0}
    parts = [tp for _, _, tp in tplan.parts] if hasattr(tplan, "parts") else [tplan]
    return {"K1": sum(1 for tp in parts if tp.gather_ngroups), "K2": len(parts),
            "K3": sum(tp.group is not None for tp in parts)}


def _k1_calls(tplan) -> list:
    """K1's calls over a product plan, as ``(args, b_win)``: one per
    gather part, or one per tiled part with a gather residue."""
    from outerspace_tpu_torch.ops.gather_pipeline import GatherPipelinePlan
    from outerspace_tpu_torch.ops.spgemm import TiledPartsPlan

    def args(d):
        return d["bases"], d["table"], d["a_pack"], d["b_pack"], d["group_bits"]

    if isinstance(tplan, GatherPipelinePlan):
        return [(args(p.dev), p.b_win) for p in tplan.parts]
    parts = tplan.parts if isinstance(tplan, TiledPartsPlan) else [(0, 0, tplan)]
    return [(args(tp.device_args["gather"]), tp.gather_b_win)
            for _, _, tp in parts if tp.gather_ngroups]


def _k1_equal_plain(torch, gexpand, calls, label: str) -> float:
    """K1 against its plain version on ``calls``, bit for bit; returns
    the values' max |err|."""
    err = 0.0
    for args, b_win in calls:
        key, val = gexpand.expand_gather(*args, b_win=b_win)
        key_p, val_p = gexpand.expand_gather_plain(*args, b_win=b_win)
        torch.cuda.synchronize()
        if not (torch.equal(key, key_p)
                and torch.equal(val.view(torch.int32), val_p.view(torch.int32))):
            raise RuntimeError(f"K1 disagrees with its plain version on {label} (want "
                               f"bit-equal): {int((key != key_p).sum())} keys differ")
        err = max(err, float((val - val_p).abs().max()))
    return err


def _grouped_equal_plain(torch, expand, tplan, label: str) -> tuple[int, float, float]:
    """The grouped K3 and K4 (one launch over a part's class tables)
    against their plain versions on every part of ``tplan`` with class
    tables, bit for bit; returns (parts checked, K3's values' max |err|,
    K4's)."""
    parts = tplan.parts if hasattr(tplan, "parts") else [(0, 0, tplan)]
    checked, e3, e4 = 0, 0.0, 0.0
    for lo, hi, tp in parts:
        g = tp.group
        if g is None:
            continue

        def bufs(*dtypes):
            return [torch.empty(g.slots, dtype=dt, device=g.tasks.device) for dt in dtypes]

        k3, k3p = bufs(torch.int32, torch.float32), bufs(torch.int32, torch.float32)
        k4, k4p = (bufs(torch.int32, torch.int32, torch.float32) for _ in range(2))
        expand.expand_part_packed(g, n_cols=tp.n, out_keys=k3[0], out_vals=k3[1])
        expand.expand_part_packed_plain(g, n_cols=tp.n, out_keys=k3p[0], out_vals=k3p[1])
        expand.expand_part_coords(g, sentinel_row=tp.m, out_rows=k4[0], out_cols=k4[1],
                                  out_vals=k4[2])
        expand.expand_part_coords_plain(g, sentinel_row=tp.m, out_rows=k4p[0], out_cols=k4p[1],
                                        out_vals=k4p[2])
        torch.cuda.synchronize()
        for name, got, want in (("K3", k3, k3p), ("K4", k4, k4p)):
            for gt, wt in zip(got, want):
                if not torch.equal(gt.view(torch.int32), wt.view(torch.int32)):
                    raise RuntimeError(
                        f"the grouped {name} disagrees with its plain version on {label}, rows "
                        f"[{lo}, {hi}) (classes {g.layout}): "
                        f"{int((gt.view(torch.int32) != wt.view(torch.int32)).sum())} slots "
                        f"differ; want bit-equal")
        e3 = max(e3, float((k3[1] - k3p[1]).abs().max()))
        e4 = max(e4, float((k4[2] - k4p[2]).abs().max()))
        checked += 1
    return checked, e3, e4


def _event_model_machine(dev) -> None:
    """The event model's machine (``csrc/perfsim.cpp``'s built-in config)
    beside the fields ``perf/simcal.py`` measures on this card, and its
    four selftests, each of which must return 0 under that machine."""
    from outerspace_tpu_torch.perf import perfsim, simcal

    t0 = time.perf_counter()
    machine = perfsim.get_config()
    measured = simcal.measure(str(dev))
    print("event model's machine (built in; measured on this card now): " + ", ".join(
        f"{k} {v}" + (f" ({measured['fields'][k]})" if k in measured["fields"] else "")
        for k, v in machine.items()))
    print(f"event model's machine, raw measurements: {json.dumps(measured['raw'])}")
    tests = perfsim.selftests()
    if any(tests.values()):
        raise RuntimeError(f"event model selftests under the card's machine: {tests}")
    print(f"event model selftests under the card's machine: {tests} (0 = pass)")
    _phase("event model machine", t0)


def _loop_expand_row(torch, loop_expand, args, kw, spin, label: str) -> dict:
    """``loop_expand`` on one loop expand caught from a warm run (``args``,
    ``kw`` as the chain passed them): held bit for bit to its plain
    version, keys and values as bits, then timed (device-only CUDA events;
    with the host's launch; the profiler) beside its bound and the plain
    version's time. The bound reads each input once and writes each slot
    once: the key and value of every one of the p_pad slots, the key,
    value and offset of every element of the stream (the offsets' last
    entry too) and the column starts. Returns the numbers of its row of
    the ``kernels`` line, ``err`` the values' max |kernel − plain|."""
    kcsc, _, starts_ext, offsets, p_clamped = args
    name = "loop_expand_64" if kcsc.dtype == torch.int64 else "loop_expand"
    got = loop_expand.loop_expand(*args, **kw)
    want = loop_expand.loop_expand_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got[1] - want[1]).abs().max())
    if got[0].dtype != kcsc.dtype or not (
            torch.equal(got[0], want[0])
            and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))):
        raise RuntimeError(f"{name} differs from its plain version on {label} (values max "
                           f"|err| {err:.3e}; want bit-equal)")
    del got, want
    torch.cuda.empty_cache()
    slots, products, elems = kw["p_pad"], int(p_clamped), kcsc.numel()
    key_b = kcsc.element_size()
    nbytes = ((key_b + 4) * slots + (key_b + 4) * elems + offsets.numel() * 8
              + starts_ext.numel() * 4)
    kernel = lambda: loop_expand.loop_expand(*args, **kw)  # noqa: E731
    ms = _device_ms(torch, kernel, spin)
    host_ms = _median_ms(torch, kernel)
    plain_ms = _median_ms(torch, lambda: loop_expand.loop_expand_plain(*args, **kw), reps=3,
                          warmup=1)
    prof = _profile_line(torch, f"{name}, {label}", kernel)
    prof_txt = f"{prof[name]:.4f} ms profiler" if name in prof else "profiler not measured"
    bound, by = _bound(nbytes, products)
    print(f"{name} on {label} ({slots:,} slots, {products:,} products, {elems:,} elements, "
          f"m {kw['m']:,}): == plain bit for bit (values max |err| {err:.3e}); {ms:.4f} ms "
          f"device-only events, {host_ms:.4f} ms with the host's launch, {prof_txt}; "
          f"{100 * bound / ms:.1f}% of its {bound:.4f} ms bound ({key_b + 4} B a slot written, "
          f"{key_b + 12} B an element and 4 B a column start read, at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the plain version {plain_ms:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound, "by": by}


def _mcl_phase(torch, np, dev, kernels, spin) -> dict:
    """Markov clustering on mcl_rmat14_4iter (the JAX bench's
    ``bench_mcl``: rmat(14, edge_factor=8, seed=7) with self loops and
    |val|, duplicates summed, columns normalised; 4 iterations): cold and
    warm ``mcl_run`` exact against scipy's MCL, cluster sets equal; the
    warm runs on the fast path, with their K1 / K2 launches and host
    reads counted; the stepwise and fused fallbacks, a forced fallback,
    a tiled first squaring (K3) and ``square_device`` exact; K1 and K3
    held to their plain versions on the first squaring's plans, K2 on
    the loop's streams and loop_expand on the loop's largest expand (bit
    for bit, timed beside its bound); times. Returns the K1, K2,
    prune_compact and loop_expand launches of one warm run, loop_expand's
    numbers for its row of the ``kernels`` line and the warm run itself
    (``"run"``), which ``main`` traces with the profiler last."""
    import importlib
    import os
    import warnings

    from outerspace_tpu_torch.formats import rmat
    from outerspace_tpu_torch.ops import chain, graph
    from outerspace_tpu_torch.ops.kernels import expand, gexpand, loop_expand, scan
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
    from outerspace_tpu_torch.ops.spgemm import MergedCOO, plan_tiled_parts

    t0 = time.perf_counter()
    # the run's own sizing cache, emptied first: the first runs are cold
    cache = ROOT / "build" / "chip_smoke_sizing_cache.json"
    os.environ["OUTERSPACE_SIZING_CACHE"] = str(cache)
    g = rmat(14, edge_factor=8, seed=7)
    flow = graph._mcl_setup(g)
    n = flow.shape[0]
    scipy_ms = []
    for _ in range(3):  # the oracle, timed
        ta = time.perf_counter()
        want = graph.markov_cluster(g, iters=MCL_ITERS, backend="scipy")
        scipy_ms.append((time.perf_counter() - ta) * 1e3)
    scipy_ms = statistics.median(scipy_ms)
    want_clusters = {tuple(sorted(c.tolist())) for c in graph.mcl_clusters(want)}
    _phase("mcl scipy oracle", t0)

    def check(merged, label):
        got = merged.to_csr()
        _csr_equal(np, got, want, label)
        if {tuple(sorted(c.tolist())) for c in graph.mcl_clusters(got)} != want_clusters:
            raise RuntimeError(f"{label}: cluster sets differ from scipy's")
        return got

    def timed(fn):
        ta = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - ta) * 1e3, out

    prepare = [timed(lambda: graph.mcl_prepare(flow, iters=MCL_ITERS, device=dev)) for _ in range(3)]
    fresh = prepare[-1][1]  # no budgets yet

    def unsized(**kw):
        return {k: v for k, v in fresh.items() if k not in ("sizing_key", "flow")} | {"flow": flow} | kw

    # the sweep's P_i and nnz_i, caught from the first mcl_size call
    sweeps = []
    real_sweep = graph._host_mcl_sizing

    def sweep_caught(*args, **kw):
        sweeps.append(real_sweep(*args, **kw))
        return sweeps[-1]

    size_ms = []
    graph._host_mcl_sizing = sweep_caught
    try:
        for _ in range(3):
            p = unsized()
            size_ms.append(timed(lambda: graph.mcl_size(p))[0])
    finally:
        graph._host_mcl_sizing = real_sweep
    sweep = sweeps[0]
    cold_ms = []
    for _ in range(3):
        cache.unlink(missing_ok=True)
        prep = unsized(sizing_key=fresh["sizing_key"])
        ms, out = timed(lambda: graph.mcl_run(prep))
        cold_ms.append(ms)
        check(out, "cold mcl_run")
    if prep.get("sizing_cached") or not cache.exists():
        raise RuntimeError("the cold run did not size and store its budgets")
    budgets = dict(prep["ran_with"])
    print(f"mcl_rmat14_4iter: n {n}, flow nnz {flow.nnz}; sweep P_i {sweep[0]}, nnz_i {sweep[1]}; "
          f"budgets {json.dumps(budgets)}; stage-1 plan {type(prep['tplan']).__name__} with "
          f"{len(getattr(prep['tplan'], 'parts', [0]))} parts")

    # warm runs on the same prep: the fast path, launches and host reads counted
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = graph.mcl_run(prep)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.items()}
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    stage1 = _stage1_launches(prep["tplan"])
    # an rmat14 flow keeps 32-bit keys: no 64-bit instantiation launches
    want_counts = dict(stage1, K2=stage1["K2"] + 1 + 2 * (MCL_ITERS - 1), K4=0, K5=0,
                       prune_compact=1, K2_64=0, prune_compact_64=0,
                       loop_expand=MCL_ITERS - 1, loop_expand_64=0)
    if counts != want_counts:
        raise RuntimeError(f"warm mcl_run launches {counts}, want {want_counts}")
    if len(syncs) > 2:
        raise RuntimeError(f"warm mcl_run read the device {len(syncs)} times, want <= 2: {syncs}")
    warm_ms = []
    for _ in range(3):
        ms, out = timed(lambda: graph.mcl_run(prep))
        warm_ms.append(ms)
        if prep["ran_with"] != budgets or prep["p_pad"] != budgets["p_pad"]:
            raise RuntimeError(f"a warm mcl_run left the fast path: budgets {prep['ran_with']}")
    fetch_ms = _host_ms(lambda: out.to_csr())
    got = check(out, "warm mcl_run")
    warm_cached = graph.mcl_prepare(flow, iters=MCL_ITERS, device=dev)
    check(graph.mcl_run(warm_cached), "mcl_run from the sizing cache")
    if not warm_cached.get("sizing_cached") or warm_cached["ran_with"] != budgets:
        raise RuntimeError("a new prep did not take its budgets from the sizing cache")
    print(f"mcl_rmat14_4iter warm mcl_run: final nnz {got.nnz} == scipy, structure exact, values "
          f"within rtol {MCL_RTOL} atol {MCL_ATOL}, {len(want_clusters)} cluster sets equal; "
          f"launches per run {counts} (the first squaring's {stage1}, then prune_compact once "
          f"and K2 once for its column sums, loop_expand once and K2 twice per loop "
          f"iteration); host reads "
          f"{len(syncs)} (`ok`; nnz is read by to_csr)")
    _phase("mcl main path", t0)

    # the exact fallbacks and the tiled first squaring
    t1 = time.perf_counter()
    sq = chain._stage1_squaring(prep["tplan"])
    v1, valid1, nnz1 = chain.inflate_device(sq.rows, sq.cols, sq.vals, sq.valid, m=n,
                                            inflation=2.0, threshold=1e-4)
    flow1 = MergedCOO(sq.shape, sq.rows, sq.cols, v1, valid1, nnz1)
    f1 = flow1.to_csr()
    assert_csr_allclose(chain.square_device(flow1).to_csr(), spgemm_scipy(f1, f1),
                        rtol=VAL_RTOL, atol=VAL_ATOL)
    for name, fn in (("markov_cluster_device_fused", chain.markov_cluster_device_fused),
                     ("markov_cluster_device", chain.markov_cluster_device)):
        check(fn(flow1, iters=MCL_ITERS - 1), f"{name} from the stage-1 flow")
    forced = unsized(**(budgets | {"elem_pad": 4096, "p_pads": None}))
    check(graph.mcl_run(forced), "mcl_run with elem_pad 4096")
    if forced["ran_with"]["elem_pad"] != 4096 or forced["elem_pad"] != 8192:
        raise RuntimeError("the forced run did not fall back and double its budgets")
    for k in kernels.values():
        k.launches = 0
    # the sized budgets
    tiled = unsized(**budgets, tplan=plan_tiled_parts(flow.to_csc(), flow, device=dev))
    check(graph.mcl_run(tiled), "mcl_run on a tiled first squaring")
    torch.cuda.synchronize()
    tiled_counts = {name: k.launches for name, k in kernels.items()}
    if not tiled_counts["K3"]:
        raise RuntimeError(f"the tiled first squaring did not launch K3: {tiled_counts}")
    # K1 and K3 on the first squarings' own inputs, against plain
    k1_mcl = {"gather plan": _k1_calls(prep["tplan"]), "tiled residue": _k1_calls(tiled["tplan"])}
    k1_mcl_err = max(_k1_equal_plain(torch, gexpand, calls, f"the MCL {label}")
                     for label, calls in k1_mcl.items())
    tparts = getattr(tiled["tplan"], "parts", [(0, 0, tiled["tplan"])])
    k3_mcl_err = 0.0
    for _, _, tp in tparts:
        for sched, d in tp.class_tables():
            args = tuple(d[k] for k in ("tasks", "a_rows_t", "a_vals_t", "b_cols_blk", "b_vals_blk"))
            got_k3 = expand.expand_tiles_packed(*args, tile_a=sched.tile_a, n_cols=tp.n)
            want_k3 = expand.expand_tiles_packed_plain(*args, tile_a=sched.tile_a, n_cols=tp.n)
            torch.cuda.synchronize()
            if not (torch.equal(got_k3[0], want_k3[0])
                    and torch.equal(got_k3[1].view(torch.int32), want_k3[1].view(torch.int32))):
                raise RuntimeError(f"K3 disagrees with its plain version on the MCL tiled first "
                                   f"squaring (tile_a={sched.tile_a}; want bit-equal)")
            k3_mcl_err = max(k3_mcl_err, float((got_k3[1] - want_k3[1]).abs().max()))
    checked, e3, k4_mcl_err = _grouped_equal_plain(torch, expand, tiled["tplan"],
                                                   "the MCL tiled first squaring")
    k3_mcl_err = max(k3_mcl_err, e3)
    if checked != tiled_counts["K3"]:
        raise RuntimeError(f"the tiled first squaring launched K3 {tiled_counts['K3']} times for "
                           f"{checked} parts with class tables; want once per part")
    print("K1 and K3 == plain bit for bit on the MCL first squarings: "
          + ", ".join(f"K1 {label} ({len(calls)} calls)" for label, calls in k1_mcl.items())
          + f", K3 on the tiled plan's {sum(len(tp.class_tables()) for _, _, tp in tparts)} "
          f"tables one by one and the grouped K3 and K4 on its {checked} parts (values max "
          f"|err| K1 {k1_mcl_err:.3e}, K3 {k3_mcl_err:.3e}, K4 {k4_mcl_err:.3e})")
    print(f"mcl fallbacks exact: square_device of the stage-1 flow == scipy; fused and stepwise "
          f"chains from it, elem_pad 4096 (ok false, stepwise, budgets doubled) == scipy's MCL; "
          f"tiled first squaring ({len(tparts)} parts, launches "
          f"{tiled_counts}, fast "
          f"path {tiled['ran_with']['p_pad'] == tiled['p_pad']}) == scipy's MCL")
    _phase("mcl fallbacks and K1 / K3 check", t1)

    # K2 on the loop's streams and the loop's largest expand: caught from
    # one warm run, against plain
    t1 = time.perf_counter()
    calls, expands = [], []
    # the module (the package's ``spgemm`` name is the function)
    spgemm_mod = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
    real, real_le = spgemm_mod.merge_epilogue_scan, chain.loop_expand

    def catch(key, vals, pad_count, *, n_cols, sentinel_row):
        calls.append((key.clone(), vals.clone(), pad_count, n_cols, sentinel_row))
        return real(key, vals, pad_count, n_cols=n_cols, sentinel_row=sentinel_row)

    def catch_le(*args, p_pad, m):
        if not expands or p_pad > expands[0][1]["p_pad"]:
            expands[:] = [(tuple(t.clone() for t in args), dict(p_pad=p_pad, m=m))]
        return real_le(*args, p_pad=p_pad, m=m)

    spgemm_mod.merge_epilogue_scan, chain.loop_expand = catch, catch_le
    try:
        graph.mcl_run(prep)
    finally:
        spgemm_mod.merge_epilogue_scan, chain.loop_expand = real, real_le
    loop = calls[stage1["K2"] + 1:]
    streams = {"loop merge (n_cols = n)": loop[0], "column sums (n_cols = 1)": loop[1]}
    if loop[0][3] != n or loop[1][3] != 1:
        raise RuntimeError(f"unexpected K2 call order: {[c[3] for c in calls]}")
    k2_rows = {}
    for label, (key, vals, pad, n_cols, sentinel) in streams.items():
        got_k2 = scan.merge_epilogue_scan(key, vals, pad, n_cols=n_cols, sentinel_row=sentinel)
        want_k2 = scan.merge_epilogue_plain(key, vals, pad, n_cols=n_cols, sentinel_row=sentinel)
        torch.cuda.synchronize()
        for i, nm in ((0, "rows"), (1, "cols"), (3, "valid"), (4, "nnz")):
            if not torch.equal(got_k2[i], want_k2[i]):
                raise RuntimeError(f"K2 {nm} disagree with plain on the MCL {label} stream")
        if not torch.allclose(got_k2[2], want_k2[2], rtol=VAL_RTOL, atol=VAL_ATOL):
            raise RuntimeError(f"K2 values disagree with plain on the MCL {label} stream")
        # the longest run of real keys (u < n·n_cols), past the tail's
        _, run_len = torch.unique_consecutive(key[key.long() + 2**31 < n * n_cols], return_counts=True)
        ms = _device_ms(torch, lambda: scan.merge_epilogue_scan(
            key, vals, pad, n_cols=n_cols, sentinel_row=sentinel), spin)
        bound = _bound(key.numel() * (4 + 4 + 4 + 4 + 4 + 1) + 4, key.numel())
        k2_rows[label] = (key.numel(), int(run_len.max()), ms, bound[0],
                          float((got_k2[2] - want_k2[2]).abs().max()))
    print("K2 on the MCL streams (device-only CUDA events; == plain, structure exact): " + "; ".join(
        f"{label}: {slots} slots, longest run {run}, {ms:.4f} ms, bound {bound:.4f} ms "
        f"({100 * bound / ms:.1f}%), max |err| {err:.3e}"
        for label, (slots, run, ms, bound, err) in k2_rows.items()))
    _phase("mcl K2 check", t1)
    t1 = time.perf_counter()
    le_row = _loop_expand_row(torch, loop_expand, *expands.pop(), spin,
                              "mcl_rmat14_4iter's largest loop expand")
    _phase("mcl loop_expand check", t1)

    # times: host clock around work that ends in a synchronise, median of 3
    t1 = time.perf_counter()
    med = statistics.median
    print(f"mcl_rmat14_4iter host ms (median of 3; samples): mcl_prepare {med(x[0] for x in prepare):.3f} "
          f"({', '.join(f'{x[0]:.3f}' for x in prepare)}), mcl_size {med(size_ms):.3f} "
          f"({', '.join(f'{x:.3f}' for x in size_ms)}), cold mcl_run {med(cold_ms):.3f} "
          f"({', '.join(f'{x:.3f}' for x in cold_ms)}), warm mcl_run {med(warm_ms):.3f} "
          f"({', '.join(f'{x:.3f}' for x in warm_ms)}), fetch to CSR {fetch_ms:.3f}; "
          f"scipy's MCL {scipy_ms:.3f} ({scipy_ms / med(warm_ms):.2f}x the warm run's time)")
    mcl_spin = _spin_cycles(torch, 200.0)

    def whole(iters=MCL_ITERS - 1):
        p_pads = budgets["p_pads"]
        return lambda: chain.mcl_whole_traced(
            prep["tplan"], p_pad=budgets["p_pad"], nnz_pad=budgets["nnz_pad"], m=n, n_cols=n,
            iters=iters, inflation=2.0, threshold=1e-4, elem_pad=budgets["elem_pad"],
            p_pads=tuple(p_pads[:iters]) if p_pads else None)

    run_ms = _device_ms(torch, whole(), mcl_spin, reps=3)
    first = _device_ms(torch, lambda: chain._stage1_squaring(prep["tplan"]), mcl_spin, reps=3)
    no_loop = _device_ms(torch, whole(iters=0), mcl_spin, reps=3)
    print(f"mcl_rmat14_4iter one warm run's device ms (device-only CUDA events, median of 3): "
          f"{run_ms:.4f}; split: the first squaring {first:.4f}, its prune, compaction and "
          f"normalisation with the final sort {no_loop - first:.4f} (a run with no loop "
          f"iteration, {no_loop:.4f}, less the squaring), the {MCL_ITERS - 1} loop iterations "
          f"{run_ms - no_loop:.4f}")
    _phase("mcl timing", t1)
    # the profiler's trace of a warm run is taken after the other phases'
    # traces: after a trace this large, the next traces in the process
    # dropped device activity
    return {"K1": counts["K1"], "K2": counts["K2"], "prune_compact": counts["prune_compact"],
            "loop_expand": counts["loop_expand"], "loop_expand row": le_row,
            "run": lambda: graph.mcl_run(prep),
            "K1 err": k1_mcl_err, "K3 err": k3_mcl_err, "K4 err": k4_mcl_err,
            "clusters": len(want_clusters), "graph": g, "want": want,
            "want_clusters": want_clusters, "warm_ms": med(warm_ms)}


def _prune_compact_phase(torch, np, dev) -> dict:
    """The prune and compaction after the MCL chain's first squaring
    (``ops/kernels/compact.py``) at the shape of the benchmark's
    rmat15_ef16.mcl4 cell: the configuration's flow (the benchmark's own
    generator), ``mcl_prepare`` and ``mcl_size`` as the cell runs them,
    and the first squaring's merged stream, whose slots, valid slots and
    survivors it prints. The kernel's output, sorted as the chain sorts
    it, is held bit for bit (``ok`` too) to its plain version's and to
    the chain's compaction before the kernel; then each is timed
    (device-only CUDA events; the kernel also with the host's launch and
    by the profiler) beside the kernel's bound, 5 B a slot. Returns the
    kernel's numbers for its row of the ``kernels`` line."""
    from benchmark.reference import generators
    from benchmark.reference import mcl as ref_mcl
    from outerspace_tpu_torch.formats.csr import CSR
    from outerspace_tpu_torch.ops import chain, graph
    from outerspace_tpu_torch.ops.kernels import compact
    from outerspace_tpu_torch.ops.spgemm import I32_MAX, pack_key_biased

    t0 = time.perf_counter()
    config = json.loads((ROOT / "benchmark" / "configs" / "rmat15_ef16.json").read_text())
    inflation, threshold = 2.0, 1e-4
    prep = graph.mcl_prepare(CSR(*ref_mcl.flow_of(generators.make(config))), inflation=inflation,
                             iters=MCL_ITERS, prune_threshold=threshold, device=dev)
    graph.mcl_size(prep)
    sq = chain._stage1_squaring(prep["tplan"])
    n, slots = prep["n"], sq.rows.shape[0]
    # the budgets as mcl_whole_traced applies them
    elem_pad = min(max(prep["elem_pad"], prep["nnz_pad"]), prep["p_pad"])
    thr_root = chain._f32(threshold ** (1.0 / inflation))
    args = (sq.rows, sq.cols, sq.vals, sq.valid)
    kw = dict(thr_root=thr_root, m=n, elem_pad=elem_pad)
    survivors = int((sq.valid & (sq.vals > thr_root)).sum())
    print(f"rmat15_ef16 first squaring: {slots:,} merged slots, {int(sq.nnz):,} valid, "
          f"{survivors:,} survive the prune (v > {thr_root!r}); elem_pad {elem_pad:,}")

    def before():
        """The chain's compaction before the kernel, as mcl_whole_traced
        ran it: the prune and the keys over every slot, then a compaction
        in stream order and a sort."""
        v_raw = torch.where(sq.valid, torch.clamp(sq.vals, min=0.0), 0.0)
        survive = sq.valid & (v_raw > thr_root)
        kcsc = torch.where(survive, pack_key_biased(sq.cols, sq.rows, n), I32_MAX)
        ok = survive.sum() <= elem_pad
        return (*chain._sort_pair(*chain._to_front(survive, elem_pad, (kcsc, I32_MAX),
                                                   (v_raw, 0.0))), ok)

    def sort(out):
        return (*chain._sort_pair(out[0], out[1]), out[2])

    before_launches = compact.KERNEL.launches
    got = sort(compact.prune_compact(*args, **kw))
    plain = sort(compact.prune_compact_plain(*args, **kw))
    old = before()
    torch.cuda.synchronize()
    if compact.KERNEL.launches != before_launches + 1:
        raise RuntimeError("prune_compact: the kernel was not launched once")
    if not (bool(got[2]) and bool(plain[2]) and bool(old[2])):
        raise RuntimeError(f"prune_compact: ok {bool(got[2])}, plain {bool(plain[2])}, before "
                           f"{bool(old[2])}: the cell's budgets do not hold")
    err = 0.0
    for label, want in (("its plain version", plain), ("the chain before it", old)):
        if not torch.equal(got[0], want[0]):
            raise RuntimeError(f"prune_compact: the kernel's keys differ from {label}'s")
        err = max(err, float((got[1] - want[1]).abs().max()))
        if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
            raise RuntimeError(f"prune_compact: the kernel's values differ from {label}'s "
                               f"(max |err| {err:.3e})")
    if int((got[0] != I32_MAX).sum()) != survivors:
        raise RuntimeError("prune_compact: the survivors were not all kept")
    del got, plain, old
    _phase("prune_compact check", t0)

    t0 = time.perf_counter()
    spin = _spin_cycles(torch, 100.0)
    kernel = lambda: compact.prune_compact(*args, **kw)  # noqa: E731
    ms = _device_ms(torch, kernel, spin)
    host_ms = _median_ms(torch, kernel)
    sorted_ms = _device_ms(torch, lambda: sort(kernel()), spin)
    # the plain version reads its survivors' count on the host: events with its host's time
    plain_ms = _median_ms(torch, lambda: compact.prune_compact_plain(*args, **kw), reps=3,
                          warmup=1)
    before_ms = _device_ms(torch, before, spin, reps=3)
    prof = _profile_line(torch, "prune_compact kernel, rmat15_ef16 first squaring", kernel)
    bound, by = _bound(slots * 5, 0)
    dev_ms = prof.get("prune_compact", 0.0) + prof.get("prune_compact tail", 0.0)
    print(f"prune_compact on rmat15_ef16's first squaring: {ms:.4f} ms device-only events, "
          f"{host_ms:.4f} ms with the host's launch, {dev_ms:.4f} ms profiler (main pass "
          f"{prof.get('prune_compact', 0.0):.4f}, tail {prof.get('prune_compact tail', 0.0):.4f}); "
          f"{100 * bound / ms:.1f}% of its {bound:.4f} ms bound ({slots:,} slots x 5 B at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); with the sort of the elem_pad slots "
          f"{sorted_ms:.4f} ms; the plain version {plain_ms:.4f} ms (with its host read); the "
          f"chain's compaction before the kernel {before_ms:.4f} ms; max |err| {err}")
    _phase("prune_compact timing", t0)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound, "by": by}


def _wide_phase(torch, np, dev, kernels) -> dict:
    """The MCL chain's 64-bit-key kernels at the shapes of the benchmark's
    lfr19_k20_mu03.mcl4 cell (n = 2**19, n² ≥ 2³²): the configuration's
    flow (the benchmark's own generator), ``mcl_prepare`` and
    ``mcl_size`` as the cell runs them, then one warm ``mcl_run`` with
    its launches counted (the 64-bit instantiations on the wide path,
    the 32-bit prune-and-compact and expand kernels not at all), whose first
    squaring's merged stream (``prune_compact_64``), largest loop merge
    (``K2_64``) and largest loop expand (``loop_expand_64``) are caught.
    Each kernel is held to its plain version on its stream: the prune and
    compaction bit for bit (sorted as the chain sorts it, ``ok`` too),
    the expand bit for bit, the merge's structure and nnz exactly and its
    values within VAL_RTOL (the plain version's ``index_add_`` sums in
    another order). Then each is timed (device-only CUDA events; with the
    host's launch; the profiler) beside its bound: K2_64 25 B a slot,
    prune_compact_64 5 B a slot and 20 B a survivor, loop_expand_64 12 B
    a slot written and 20 B a stream element read. Returns the kernels' numbers
    for their rows of the ``kernels`` line, and the warm run's
    launches."""
    import importlib

    from benchmark.reference import lfr
    from benchmark.reference import mcl as ref_mcl
    from outerspace_tpu_torch.formats.csr import CSR
    from outerspace_tpu_torch.ops import chain, graph
    from outerspace_tpu_torch.ops.kernels import compact, loop_expand, scan

    t0 = time.perf_counter()
    config = json.loads((ROOT / "benchmark" / "configs" / "lfr19_k20_mu03.json").read_text())
    inflation, threshold = 2.0, 1e-4
    flow = CSR(*ref_mcl.flow_of(lfr.make(config)))
    prep = graph.mcl_prepare(flow, inflation=inflation, iters=MCL_ITERS,
                             prune_threshold=threshold, device=dev)
    graph.mcl_size(prep)
    n = prep["n"]
    if compact.key_dtype(n) != torch.int64:
        raise RuntimeError(f"lfr19_k20_mu03: n {n} does not take 64-bit keys")
    graph.mcl_run(prep).to_csr()  # a first run: the fast path's budgets
    _phase("wide path: lfr19_k20_mu03 graph, prepare and sizing", t0)

    t0 = time.perf_counter()
    spgemm_mod = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
    real_k2 = spgemm_mod.merge_epilogue_scan
    real_pc, real_le = chain.prune_compact, chain.loop_expand
    caught = {"K2_64": None, "prune_compact_64": None, "loop_expand_64": None}

    def catch_k2(key, vals, pad_count, *, n_cols, sentinel_row):
        if key.dtype == torch.int64 and (caught["K2_64"] is None
                                         or key.numel() > caught["K2_64"][0].numel()):
            caught["K2_64"] = (key.clone(), vals.clone(), pad_count, n_cols, sentinel_row)
        return real_k2(key, vals, pad_count, n_cols=n_cols, sentinel_row=sentinel_row)

    def catch_pc(rows, cols, vals, valid, **kw):
        caught["prune_compact_64"] = (tuple(t.clone() for t in (rows, cols, vals, valid)), kw)
        return real_pc(rows, cols, vals, valid, **kw)

    def catch_le(*args, p_pad, m):
        if caught["loop_expand_64"] is None or p_pad > caught["loop_expand_64"][1]["p_pad"]:
            caught["loop_expand_64"] = (tuple(t.clone() for t in args), dict(p_pad=p_pad, m=m))
        return real_le(*args, p_pad=p_pad, m=m)

    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    spgemm_mod.merge_epilogue_scan, chain.prune_compact, chain.loop_expand = (
        catch_k2, catch_pc, catch_le)
    try:
        graph.mcl_run(prep).to_csr()
    finally:
        spgemm_mod.merge_epilogue_scan, chain.prune_compact, chain.loop_expand = (
            real_k2, real_pc, real_le)
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.items()}
    stage1 = _stage1_launches(prep["tplan"])
    want_counts = dict(stage1, K2=stage1["K2"] + MCL_ITERS, K4=0, K5=0, prune_compact=0,
                       K2_64=MCL_ITERS - 1, prune_compact_64=1, loop_expand=0,
                       loop_expand_64=MCL_ITERS - 1)
    if counts != want_counts or prep["ran_with"]["p_pad"] != prep["p_pad"]:
        raise RuntimeError(f"warm wide mcl_run launches {counts}, want {want_counts} on the "
                           f"fast path")
    print(f"lfr19_k20_mu03 warm mcl_run (n {n}, flow nnz {flow.nnz}, "
          f"{len(getattr(prep['tplan'], 'parts', [0]))} first-squaring parts): launches {counts} "
          f"(the first squaring's {stage1}, prune_compact_64 once, K2 once a column "
          f"normalisation, loop_expand_64 and K2_64 once a loop iteration)")
    del prep, flow
    torch.cuda.empty_cache()

    # prune_compact_64 on the first squaring's stream
    (rows, cols, vals, valid), kw = caught.pop("prune_compact_64")
    slots = rows.shape[0]
    survivors = int((valid & (vals > kw["thr_root"])).sum())

    def sort(out):
        return (*chain._sort_pair(out[0], out[1]), out[2])

    got = sort(compact.prune_compact(rows, cols, vals, valid, **kw))
    plain = sort(compact.prune_compact_plain(rows, cols, vals, valid, **kw))
    torch.cuda.synchronize()
    if got[0].dtype != torch.int64 or not (bool(got[2]) and bool(plain[2])):
        raise RuntimeError(f"prune_compact_64: keys {got[0].dtype}, ok {bool(got[2])}, plain "
                           f"ok {bool(plain[2])}")
    pc_err = float((got[1] - plain[1]).abs().max())
    if not (torch.equal(got[0], plain[0])
            and torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32))):
        raise RuntimeError(f"prune_compact_64 differs from its plain version (values max |err| "
                           f"{pc_err:.3e}; want bit-equal)")
    if int((got[0] != chain._sentinel(torch.int64)).sum()) != survivors:
        raise RuntimeError("prune_compact_64: the survivors were not all kept")
    del got, plain
    spin = _spin_cycles(torch, 100.0)
    kernel = lambda: compact.prune_compact(rows, cols, vals, valid, **kw)  # noqa: E731
    pc_ms = _device_ms(torch, kernel, spin)
    pc_host_ms = _median_ms(torch, kernel)
    pc_plain_ms = _median_ms(torch, lambda: compact.prune_compact_plain(
        rows, cols, vals, valid, **kw), reps=3, warmup=1)
    prof = _profile_line(torch, "prune_compact_64, lfr19_k20_mu03 first squaring", kernel)
    pc_prof = (f"{prof['prune_compact_64'] + prof.get('prune_compact_64 tail', 0.0):.4f} ms "
               f"profiler (main pass {prof['prune_compact_64']:.4f}, tail "
               f"{prof.get('prune_compact_64 tail', 0.0):.4f})"
               if "prune_compact_64" in prof else "profiler not measured")
    pc_bound, pc_by = _bound(slots * 5 + survivors * 20, 0)
    print(f"prune_compact_64 on lfr19_k20_mu03's first squaring ({slots:,} slots, {survivors:,} "
          f"survive, elem_pad {kw['elem_pad']:,}): == plain bit for bit; "
          f"{pc_ms:.4f} ms device-only events, {pc_host_ms:.4f} ms with the host's launch, "
          f"{pc_prof}; {100 * pc_bound / pc_ms:.1f}% of its "
          f"{pc_bound:.4f} ms bound (5 B a slot, 20 B a survivor, at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the plain version {pc_plain_ms:.4f} ms (with its "
          f"host read)")
    del rows, cols, vals, valid, kernel
    torch.cuda.empty_cache()
    _phase("wide path: prune_compact_64", t0)

    # K2_64 on the largest loop merge
    t0 = time.perf_counter()
    key, kvals, pad, n_cols, sentinel = caught.pop("K2_64")
    got = scan.merge_epilogue_scan(key, kvals, pad, n_cols=n_cols, sentinel_row=sentinel)
    want = scan.merge_epilogue_plain(key, kvals, pad, n_cols=n_cols, sentinel_row=sentinel)
    torch.cuda.synchronize()
    for i, nm in ((0, "rows"), (1, "cols"), (3, "valid"), (4, "nnz")):
        if not torch.equal(got[i], want[i]):
            raise RuntimeError(f"K2_64 {nm} disagree with plain on the lfr19 loop merge")
    if not torch.allclose(got[2], want[2], rtol=VAL_RTOL, atol=VAL_ATOL):
        raise RuntimeError("K2_64 values disagree with plain on the lfr19 loop merge")
    k2_err = float((got[2] - want[2]).abs().max())
    real = int((key != chain._sentinel(torch.int64)).sum())
    nnz = int(got[4])
    del got, want
    torch.cuda.empty_cache()
    kernel = lambda: scan.merge_epilogue_scan(  # noqa: E731
        key, kvals, pad, n_cols=n_cols, sentinel_row=sentinel)
    k2_ms = _device_ms(torch, kernel, spin)
    k2_host_ms = _median_ms(torch, kernel)
    k2_plain_ms = _median_ms(torch, lambda: scan.merge_epilogue_plain(
        key, kvals, pad, n_cols=n_cols, sentinel_row=sentinel), reps=3, warmup=1)
    prof = _profile_line(torch, "K2_64, lfr19_k20_mu03 largest loop merge", kernel)
    k2_prof = (f"{prof['K2_64'] + prof.get('K2_64 carry', 0.0):.4f} ms profiler (tile pass "
               f"{prof['K2_64']:.4f}, carry {prof.get('K2_64 carry', 0.0):.4f})"
               if "K2_64" in prof else "profiler not measured")
    k2_bound, k2_by = _bound(key.numel() * (8 + 4 + 4 + 4 + 4 + 1) + 4, key.numel())
    print(f"K2_64 on lfr19_k20_mu03's largest loop merge ({key.numel():,} slots, {real:,} "
          f"products, {nnz:,} merged): structure and nnz == plain, values max |err| "
          f"{k2_err:.3e}; {k2_ms:.4f} ms device-only events, {k2_host_ms:.4f} ms with the "
          f"host's launch, {k2_prof}; {100 * k2_bound / k2_ms:.1f}% of its "
          f"{k2_bound:.4f} ms bound (25 B a slot); the plain version {k2_plain_ms:.4f} ms "
          f"(with its host read)")
    del key, kvals, kernel
    torch.cuda.empty_cache()
    _phase("wide path: K2_64", t0)

    # loop_expand_64 on the largest loop expand
    t0 = time.perf_counter()
    le_row = _loop_expand_row(torch, loop_expand, *caught.pop("loop_expand_64"), spin,
                              "lfr19_k20_mu03's largest loop expand")
    _phase("wide path: loop_expand_64", t0)
    return {"launches": counts,
            "K2_64": {"err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound": k2_bound,
                      "by": k2_by},
            "prune_compact_64": {"err": pc_err, "ms": pc_ms, "plain_ms": pc_plain_ms,
                                 "bound": pc_bound, "by": pc_by},
            "loop_expand_64": le_row}


def _cli_phase(torch, np, dev, kernels, splits, tri_want: int, mcl_clusters_want: int,
               kernel_ms: dict) -> dict:
    """The command line on the card, through ``cli.main`` as a user runs
    it, its files under ``build/chip_smoke_cli/`` (with its own sizing
    cache): rmat14_ef8 written and read back (native and Python readers,
    plain and gzipped, all equal); ``spgemm`` A² by each strategy (nnz
    and flops exact, each strategy's kernels launched), its measured ms
    beside its roofline and the earlier phase's end-to-end split;
    ``spgemm --out`` of rmat10_ef8 · rmat10_ef8ᵀ read back against
    scipy; ``graph triangles`` by both routes and ``graph mcl`` against
    scipy's counts; the microbench suite; ``ref_spgemm_native`` against
    scipy, timed beside it. ``spgemm`` prints the event model's multiply
    and merge, each printed here over what it predicts (``kernel_ms``:
    K3's device ms on the tiles path, K1's on the gather path, sort + K2
    on the gather streams); ``predict`` models rmat14_ef8 on four meshes.
    Returns the phase's launches per kernel."""
    import gzip
    import os
    import re

    from outerspace_tpu_torch import cli
    from outerspace_tpu_torch.formats import read_mtx, rmat, write_mtx
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_flops, spgemm_scipy
    from outerspace_tpu_torch.perf import microbench
    from outerspace_tpu_torch.perf.roofline import achieved_fraction
    from outerspace_tpu_torch.runtime.native import ref_spgemm_native
    from outerspace_tpu_torch.sched import autotune

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    os.environ["OUTERSPACE_SIZING_CACHE"] = str(out_dir / "sizing_cache.json")
    launches = dict.fromkeys(kernels, 0)

    def run_cli(argv, path=(), on_card=True):
        """One ``cli.main`` call, counted; returns its standard output.
        ``on_card``: pass ``--device`` (``predict`` takes none)."""
        for k in kernels.values():
            k.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*argv, "--device", str(dev)] if on_card else argv)
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        if rc != 0:
            raise RuntimeError(f"cli {' '.join(argv)}: exit {rc}\n{buf.getvalue()}")
        for n in path:
            if counts[n] == 0:
                raise RuntimeError(f"cli {' '.join(argv)}: kernel {n} was never launched")
        for n, c in counts.items():
            launches[n] += c
        return buf.getvalue(), counts

    def field(text, pattern):
        found = re.search(pattern, text)
        if not found:
            raise RuntimeError(f"no {pattern!r} in the CLI's output:\n{text}")
        return found.group(1)

    # ---- files in: the native and Python readers, plain and gzipped
    a = rmat(14, edge_factor=8, seed=1)
    f14 = str(out_dir / "rmat14_ef8.mtx")
    ta = time.perf_counter()
    write_mtx(f14, a)
    with open(f14, "rb") as src, gzip.open(f14 + ".gz", "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    write_ms = (time.perf_counter() - ta) * 1e3
    reads, read_ms = {}, {}
    for name, path, native in (("native", f14, True), ("python", f14, False),
                               ("native .gz", f14 + ".gz", True), ("python .gz", f14 + ".gz", False)):
        ta = time.perf_counter()
        reads[name] = read_mtx(path, native=native)
        read_ms[name] = (time.perf_counter() - ta) * 1e3
    want_sorted = a.sorted_colmajor()
    for name, got in reads.items():
        if got.shape != a.shape or not all(np.array_equal(getattr(got, f), getattr(want_sorted, f))
                                           for f in ("row", "col", "val")):
            raise RuntimeError(f"rmat14_ef8 read back by the {name} reader differs from what was written")
    print(f"cli files: rmat14_ef8 ({a.nnz} entries) written in {write_ms:.3f} ms (and gzipped); "
          "read back equal to it by each reader, ms: "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in read_ms.items()))
    _phase("cli files in", t0)

    # ---- spgemm A² by each strategy through the command line
    t1 = time.perf_counter()
    want_nnz, want_flops = 8_741_118, 16_822_071
    if spgemm_flops(a.to_csc(), a.to_csr()) != want_flops:
        raise RuntimeError("spgemm_flops of rmat14_ef8 A² is not 16,822,071")
    pick = autotune.autotune(a.to_csc(), a.to_csr())[0]
    paths = {"gather": ("K1", "K2"), "tiles": ("K3", "K1", "K2"), "flat": ("K2",)}
    for st in ("gather", "tiles", "flat", "auto"):
        path = paths[pick if st == "auto" else st]
        text, counts = run_cli(["spgemm", f14, f14, "--no-transpose", "--strategy", st], path)
        nnz, flops = int(field(text, r"nnz: (\d+)")), int(field(text, r"multiply flops: (\d+)"))
        if (nnz, flops) != (want_nnz, want_flops):
            raise RuntimeError(f"cli spgemm {st}: nnz {nnz}, flops {flops}; want "
                               f"{want_nnz}, {want_flops}")
        ms = float(field(text, r"measured \(end-to-end\): ([\d.]+) ms"))
        mult = float(field(text, r"analytical multiply \(roofline\): ([\d.]+) ms"))
        merge = float(field(text, r"analytical merge \(roofline\):\s+([\d.]+) ms"))
        ran = field(text, r"strategy: (\w+)")
        ev_mult = float(field(text, r"event-model multiply:\s+([\d.]+) ms"))
        ev_rate = field(text, r"event-model multiply:.*hit rate (\d+%)")
        ev_merge = float(field(text, r"event-model merge:\s+([\d.]+) ms"))
        kernel = {"tiles": "K3", "gather": "K1"}.get(ran)
        if kernel:
            sort_k2 = kernel_ms["torch.sort"] + kernel_ms["K2"]
            print(f"cli spgemm rmat14_ef8 --strategy {st} (ran {ran}) event model: multiply "
                  f"{ev_mult:.3f} ms (on-chip B-group hit rate {ev_rate}) / {kernel} "
                  f"{kernel_ms[kernel]:.4f} device ms = {ev_mult / kernel_ms[kernel]:.3f}; merge "
                  f"{ev_merge:.3f} ms / sort + K2 {sort_k2:.4f} device ms (gather streams) = "
                  f"{ev_merge / sort_k2:.3f}")
        split = splits["rmat14_ef8", ran]
        print(f"cli spgemm rmat14_ef8 --strategy {st} (ran {ran}): nnz {nnz}, flops {flops} exact; "
              f"measured {ms:.3f} ms end to end; roofline multiply {mult:.3f} + merge {merge:.3f} "
              f"ms, achieved fraction {achieved_fraction(ms, mult + merge):.4f}; the same "
              f"strategy's spgemm in the splits above {sum(split):.3f} ms (host plan "
              f"{split[0]:.3f}, device {split[1]:.3f}, fetch {split[2]:.3f}), so the CLI's own "
              f"cost {ms - sum(split):.3f} ms; launches (warm and measured call) {counts}")
    _phase("cli spgemm", t1)

    # ---- predict: host only, any mesh
    t1 = time.perf_counter()
    for mesh in ("1", "4", "2,2", "8"):
        text, counts = run_cli(["predict", f14, f14, "--no-transpose", "--mesh", mesh],
                               on_card=False)
        if any(counts.values()):
            raise RuntimeError(f"cli predict --mesh {mesh} launched kernels: {counts}")
        for pattern in (r"multiply flops: (\d+)", r"(mesh \d+x\d+ \(.+)",
                        r"analytical sharded \(roofline\):\s+([\d.]+) ms",
                        r"(event-model sharded:\s+[\d.]+ ms.*)"):
            field(text, pattern)
        print(f"cli predict rmat14_ef8 --mesh {mesh}: " + "; ".join(text.strip().splitlines()))
    _phase("cli predict", t1)

    # ---- spgemm --out: rmat10_ef8 · rmat10_ef8ᵀ read back against scipy
    t1 = time.perf_counter()
    f10 = str(ROOT / "data" / "mtx" / "rmat10_ef8.mtx")
    out = str(out_dir / "c10.mtx")
    text, counts = run_cli(["spgemm", f10, f10, "--out", out])
    a10 = read_mtx(f10)
    want10 = spgemm_scipy(a10, a10.transpose())
    got10 = read_mtx(out).to_csr()
    assert_csr_allclose(got10, want10, rtol=VAL_RTOL, atol=VAL_ATOL)
    print(f"cli spgemm --out rmat10_ef8 · rmat10_ef8ᵀ: {got10.nnz} entries read back, structure "
          f"exact against scipy, values within rtol {VAL_RTOL} atol {VAL_ATOL} after %.9g; "
          f"launches {counts}")

    # ---- graph triangles (both routes) and graph mcl against scipy
    g13 = str(out_dir / "triangles_rmat13.mtx")
    write_mtx(g13, rmat(13, edge_factor=8, seed=4))
    for route, path in (("dense", ()), ("sparse", ("K3", "K1", "K2"))):
        text, counts = run_cli(["graph", "triangles", g13, "--strategy", route], path)
        got = int(field(text, r"triangles: (\d+)"))
        if got != tri_want or got != 315_423:
            raise RuntimeError(f"cli graph triangles --strategy {route}: {got}, scipy {tri_want}")
        ms = field(text, r"triangles: \d+ \(([\d.]+) ms\)")
        print(f"cli graph triangles rmat13 --strategy {route}: {got} == scipy, {ms} ms; "
              f"launches {counts}")
    g14 = str(out_dir / "mcl_rmat14.mtx")
    write_mtx(g14, rmat(14, edge_factor=8, seed=7))
    text, counts = run_cli(["graph", "mcl", g14, "--iters", str(MCL_ITERS)],
                           ("K1", "K2", "prune_compact"))
    got = int(field(text, r"mcl: (\d+) clusters"))
    if got != mcl_clusters_want:
        raise RuntimeError(f"cli graph mcl: {got} clusters, scipy's MCL {mcl_clusters_want}")
    ms, model = field(text, r"clusters \(([\d.]+) ms\)"), field(text, r"(analytical model: .+)")
    print(f"cli graph mcl mcl_rmat14_4iter (cold, its own sizing cache): {got} clusters == scipy's "
          f"MCL; measured {ms} ms, {model}; launches {counts}")
    _phase("cli --out and graph", t1)

    # ---- the microbench suite and the native CPU reference
    t1 = time.perf_counter()
    print("microbench suite (seconds per call, CUDA events): "
          + json.dumps(microbench.suite(device=str(dev))))
    a_csc, a_csr = a.to_csc(), a.to_csr()
    ta = time.perf_counter()
    ref = ref_spgemm_native(a_csc, a_csr)
    ref_ms = (time.perf_counter() - ta) * 1e3
    ta = time.perf_counter()
    want = spgemm_scipy(a, a)
    scipy_ms = (time.perf_counter() - ta) * 1e3
    assert_csr_allclose(ref, want, rtol=VAL_RTOL, atol=VAL_ATOL)
    print(f"ref_spgemm_native rmat14_ef8 A²: nnz {ref.nnz}, structure exact against scipy, values "
          f"within rtol {VAL_RTOL} atol {VAL_ATOL}; {ref_ms:.3f} ms, scipy {scipy_ms:.3f} ms "
          "(host clock, one run each)")
    _phase("cli microbench and native reference", t1)
    _phase("cli", t0)
    return launches


# the benchmark suite's workloads the smoke runs, and the kernels each
# record's path must launch (by the strategy or route the record ran)
BENCH_SUBSET = ("mtx_rmat10_a2", "rmat14_ef8", "sparse_mlp_infer_b1024_spmm", "triangles_rmat13")
BENCH_PATHS = {"gather": ("K1", "K2"), "tiles": ("K1", "K2"), "flat": ("K2",),
               "sparse": ("K3", "K1", "K2"), "dense": (), "mlp": ("K5",)}


def _bench_phase(torch, dev, kernels) -> dict:
    """The benchmark suite (``outerspace_tpu_torch.bench``) in process on
    :data:`BENCH_SUBSET`: its records and headline printed here, the
    headline's shape checked (the median speedup of the exact A² records,
    above 0), every record's exactness fields true and its path's kernels
    launched. Returns the phase's launches per kernel."""
    from outerspace_tpu_torch import bench

    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    head, records = bench.run_suite(BENCH_SUBSET, device=dev, out=sys.stdout, err=sys.stdout)
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items()}
    a2 = [r for r in records if r.get("name") in bench.A2_SUITE]
    if (set(head) != {"metric", "value", "unit", "vs_baseline", "records"}
            or head["metric"] != bench.METRIC or head["unit"] != "x"
            or not head["value"] > 0 or head["vs_baseline"] != head["value"]
            or head["records"] != len(a2) or head != bench.headline(a2)):
        raise RuntimeError(f"bench headline {head}")
    ran = [r.get("name") for r in records]
    if ran != [n for n, _, _ in bench.WORKLOADS if n in BENCH_SUBSET] or not bench.passed(records):
        raise RuntimeError(f"bench records failed, were shed or are not exact: {records}")
    for rec in records:
        path = BENCH_PATHS[rec.get("strategy", "mlp")]
        missing = [n for n in path if not rec["launches"][n]]
        if missing:
            raise RuntimeError(f"bench {rec['name']}: kernels {missing} never launched")
    print(f"bench ({', '.join(BENCH_SUBSET)}): headline {head['value']} x over {head['records']} "
          f"A² records, every record exact; launches {counts}")
    _phase("bench", t0)
    return counts


SHARDED_REPS = 3  # warm runs timed per sharded program
# the JAX package's multi-device record (MULTICHIP_r05.json), its dryrun's
# numbers on 8 devices
MULTICHIP_RECORD = ("sharded spgemm nnz=4546, 2-D (4x2) spgemm nnz=4546, pallas-tiled sharded "
                    "nnz=5401 (1-D) / 5401 (2-D), rebased 2^32-key nnz=8 (exact), "
                    "triangles_sharded=416 (exact), mcl_sharded nnz=287 clusters=7 (exact")


def _sharded_phase(torch, np, dev, want1, tri_want: int, f14: str, g13: str, g14: str,
                   mcl: dict) -> dict:
    """The sharded mode on the card (``shard/``, on ``torch.distributed``):

    - a world of one rank on nccl, the JAX bench's (1,1) mesh at full
      size: ``spgemm_sharded_tiled`` of rmat(13, edge_factor=8, seed=7)
      A² against scipy, and of rmat(16, edge_factor=8, seed=5) A² (m·n =
      2³², rebased keys, chunks automatic); plan ms, warm ms per op (CUDA
      events, median of ``SHARDED_REPS``), the single-device tiles
      pipeline beside it; mcl_rmat14_4iter by the device-resident loop
      (its warm ms per iteration, its device synchronisations) and by
      the host-planned loop, each against the MCL phase's scipy oracle;
      MLP1w b1024 through ``SparseMLP.sharded`` (dp = 1), bit-identical
      to the single-device forward;
    - the same programs run here in a gloo world of one on the card:
      rmat16's product held to the single-device ``spgemm``, the rank's
      K3 and K1 inputs on rmat13 and on the MCL host loop's first
      squaring held bit for bit to their plain versions, K2 to its plain
      version on every received buffer the tiled program merges and on
      the device MCL loop's first merge buffer, and K5 to its plain
      version on one dp = 8 rank's shard of the serving batch;
    - one world of 8 ranks sharing the card over gloo (the exchange
      staged through host memory), the counterpart of the JAX dryrun's
      8 devices: rmat14_ef8 A² by ``spgemm_sharded`` on (8,),
      ``spgemm_sharded_2d`` on (4, 2), ``spgemm_sharded_tiled`` on (8,)
      and on (4, 2) with 2 exchange chunks, each gathered to rank 0 and
      held to scipy; ``triangle_count_sharded`` of triangles_rmat13 on
      (4, 2); every job of ``shard.dryrun.dryrun_jobs(8)`` (the JAX
      dryrun's operands: nnz 4546 in 1-D and 4×2, 5401 in 1-D and 2-D
      chunked, the rebased 2³²-key nnz 8, 416 triangles, MCL nnz 287 in
      7 clusters, the dp 4 × tp 2 step, serving) and its line;
      mcl_rmat14_4iter by the device loop on (8,) and (4, 2) and by the
      host loop on (8,); MLP1w b1024 served on dp = 8, bit-identical;
      three dp 4 × tp 2 steps of MLP1w at b1024 held to three
      single-device ``train_step``s on the card (float32 within 1e-5 of
      each tensor's norm, float64 within 1e-10 of its largest |value|),
      and three dp 8 × tp 1 steps in float32 the same way;
    - the command line, five threads side by side: ``spgemm --mesh 1``
      (nccl) and ``spgemm --mesh 4,2 --dist-backend gloo`` of rmat14_ef8
      (nnz and flops exact), ``graph triangles --mesh 4,2 --dist-backend
      gloo`` of triangles_rmat13, ``graph mcl --mesh 1 --loop device``
      (nccl) and ``graph mcl --mesh 4,2 --loop host --dist-backend gloo``
      of mcl_rmat14_4iter (cluster counts exact).

    Every program's kernels are counted in its ranks; returns the
    phase's launches and the K1 / K2 / K3 / K5 errors against plain."""
    import re
    import tempfile

    import torch.distributed as dist

    from outerspace_tpu_torch import cli
    from outerspace_tpu_torch.convert import load_params
    from outerspace_tpu_torch.formats import CSR, rmat
    from outerspace_tpu_torch.nn import train
    from outerspace_tpu_torch.nn.data import synthetic_mnist
    from outerspace_tpu_torch.nn.models import init_lecun_normal_, make_model
    from outerspace_tpu_torch.nn.sparse_infer import TN, SparseMLP
    from outerspace_tpu_torch.ops.graph import _mcl_setup, mcl_clusters
    from outerspace_tpu_torch.ops.kernels import expand, gexpand, scan, spmm
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_flops, spgemm_scipy
    from outerspace_tpu_torch.ops.spgemm import plan_tiled_parts, spgemm, spgemm_padded_tiled_parts
    from outerspace_tpu_torch.perf.perfsim import (simulate_mcl_sharded_iteration,
                                                   simulate_sharded_tiled)
    from outerspace_tpu_torch.perf.roofline import (predict_mcl_sharded_iteration,
                                                    predict_sharded_tiled)
    from outerspace_tpu_torch.shard import mcl as smcl
    from outerspace_tpu_torch.shard import tiled
    from outerspace_tpu_torch.shard.dryrun import dryrun_jobs
    from outerspace_tpu_torch.shard.mesh import Mesh, run_world
    from outerspace_tpu_torch.shard.spgemm_sharded import shard_plan, shard_plan_2d
    from outerspace_tpu_torch.shard.tiled import (build_sharded_tiled, shard_plan_tiled,
                                                  spgemm_sharded_tiled)
    from outerspace_tpu_torch.shard.world import run_jobs

    t0 = time.perf_counter()
    launches = {"K1": 0, "K2": 0, "K3": 0, "K5": 0}
    torch.cuda.empty_cache()  # the ranks share the card with this process
    # mcl_rmat14_4iter (the MCL phase's graph and scipy oracle), the
    # device loop's plans on the three meshes (for the roofline), MLP1w
    # and a b1024 batch, the batch's single-device logits
    g_mcl, mcl_want = mcl["graph"], mcl["want"]
    flow0 = _mcl_setup(g_mcl)
    ta = time.perf_counter()
    mcl_plans = {shape: smcl.plan_mcl_sharded_device(flow0, kx=shape[0], ny=shape[-1] if
                                                     len(shape) > 1 else 1, iters=MCL_ITERS)
                 for shape in ((1,), (8,), (4, 2))}
    mcl_plan_ms = (time.perf_counter() - ta) * 1e3 / len(mcl_plans)
    w1024 = load_params(WEIGHTS / "MLP1w" / "prune0p01_finetuned.pkl")
    mnist = synthetic_mnist(MLP_BATCH, seed=1)
    x_serve = np.concatenate([mnist[k][0] for k in ("train", "val", "test")])[:MLP_BATCH]
    x_serve = np.ascontiguousarray(x_serve.reshape(MLP_BATCH, 784), dtype=np.float32)
    y_serve = np.concatenate([mnist[k][1] for k in ("train", "val", "test")])[:MLP_BATCH]
    serve_single = SparseMLP(w1024, device=dev)
    single_logits = serve_single(x_serve).cpu().numpy()
    x_dev = torch.from_numpy(x_serve).to(dev)
    single_fwd_ms = _median_ms(torch, lambda: serve_single(x_dev))

    def tally(label, results, path):
        counts = {k: sum(r["launches"][k] for r in results) for k in launches}
        for k in path:
            if counts[k] == 0:
                raise RuntimeError(f"{label}: kernel {k} was never launched")
        for k, c in counts.items():
            launches[k] += c
        return counts

    def path_of(plan):
        tiles = (any(bk["tile_as"] for bk in plan.buckets) if plan.rebase else plan.tile_as)
        return ("K3", "K1", "K2") if tiles else ("K1", "K2")

    def csr_of(res):
        shape, indptr, indices, data = res["csr"]
        return CSR(shape, indptr, indices, data)

    def mcl_check(label, results, loop):
        """Every rank's final flow exact against scipy's MCL, cluster sets
        equal, the device loop on its fast path, the path's kernels
        launched; prints the run's line."""
        for r in results:
            got = csr_of(r)
            _csr_equal(np, got, mcl_want, label)
            if {tuple(sorted(c.tolist())) for c in mcl_clusters(got)} != mcl["want_clusters"]:
                raise RuntimeError(f"{label}: cluster sets differ from scipy's")
            if loop == "device" and r["report"]["fast_path"] is not True:
                raise RuntimeError(f"{label}: the device loop left its fast path: {r['report']}")
        path = ("K2",) if loop == "device" else ("K3", "K1", "K2")
        counts = tally(label, results, path)
        slowest = max(r["seconds"][0] for r in results) * 1e3
        text = (f"{label}: final nnz {mcl_want.nnz} == scipy, structure exact, values within "
                f"rtol {MCL_RTOL} atol {MCL_ATOL}, {len(mcl['want_clusters'])} cluster sets "
                f"equal on every rank; the call {slowest:.3f} ms (host clock, slowest rank, "
                f"plan included); launches {counts}")
        if loop == "device":
            rep = results[0]["report"]
            text += (f"; report: fast path, {rep['iterations']} iterations, host reads "
                     f"{rep['host_reads']}, budgets p_pad {rep['p_pad']} cap {rep['cap']} ecap "
                     f"{rep['ecap']} nb {rep['nb']} na {rep['na']}")
            if results[0]["syncs"] is not None:
                text += f"; device synchronisations of the call {[r['syncs'] for r in results]}"
            if "loop_seconds" in results[0]:
                shape = tuple(int(v) for v in re.search(r"shape=\(([\d, ]+?),?\)",
                                                         results[0]["mesh"]).group(1).split(","))
                per = max(statistics.median(r["loop_seconds"]) for r in results) / MCL_ITERS
                pred = predict_mcl_sharded_iteration(mcl_plans[shape])
                event = ""
                if shape == (1,):  # the event model, on the one-rank plan
                    ev = simulate_mcl_sharded_iteration(mcl_plans[shape])["seconds"]
                    event = (f", event model {ev * 1e3:.4f} ms per iteration "
                             f"({ev / per:.3f} of the measured)")
                text += (f"; warm loop {per * 1e3:.4f} ms per iteration (CUDA events, slowest "
                         f"rank, median of {len(results[0]['loop_seconds'])}: "
                         + ", ".join(f"{t * 1e3 / MCL_ITERS:.4f}"
                                     for t in results[0]["loop_seconds"])
                         + f" on rank 0), roofline {pred * 1e3:.4f} ms per iteration{event}, the "
                         f"single-device warm mcl_run {mcl['warm_ms']:.3f} ms a run "
                         f"({mcl['warm_ms'] / MCL_ITERS:.4f} per iteration)")
        print(text)

    def serve_check(label, results):
        for r in results:
            if not np.array_equal(r["logits"], single_logits):
                err = float(np.abs(r["logits"] - single_logits).max())
                raise RuntimeError(f"{label}: logits not bit-identical to the single-device "
                                   f"SparseMLP (max |err| {err:.3e})")
        counts = tally(label, results, ("K5",))
        if counts["K5"] != 3 * len(results) or sum(counts.values()) != counts["K5"]:
            raise RuntimeError(f"{label}: launches {counts}, want K5 3 per rank only")
        per = max(statistics.median(r["seconds"]) for r in results) * 1e3
        print(f"{label}: MLP1w b{MLP_BATCH} logits bit-identical to the single-device SparseMLP "
              f"on every rank; launches {counts}; {per:.4f} ms per request (CUDA events, slowest "
              f"rank, median of {len(results[0]['seconds'])}, the all_gather included), the "
              f"single-device forward {single_fwd_ms:.4f} ms")

    # ---- a world of one rank on nccl: sharded_rmat13_1x1, sharded_rmat16_1x1
    ops = {}
    for name, g in (("sharded_rmat13_1x1", rmat(13, edge_factor=8, seed=7)),
                    ("sharded_rmat16_1x1", rmat(16, edge_factor=8, seed=5))):
        a_csc, b_csr = g.to_csc(), g.to_csr()
        ta = time.perf_counter()
        plan = shard_plan_tiled(a_csc, b_csr, kx=1)
        ops[name] = (g, a_csc, b_csr, plan, (time.perf_counter() - ta) * 1e3)
    g13_, a13, b13, plan13, _ = ops["sharded_rmat13_1x1"]
    g16, a16, b16, plan16, _ = ops["sharded_rmat16_1x1"]
    if plan16.rebase is not True or plan13.rebase:
        raise RuntimeError("rmat16 (m·n = 2^32) must plan rebased keys, rmat13 global ones")
    jobs = [dict(program="tiled", mesh=(1,), plan=plan13, csr=True, entries=False,
                 reps=SHARDED_REPS),
            dict(program="tiled", mesh=(1,), plan=plan16, entries=False, reps=SHARDED_REPS),
            dict(program="mcl", loop="device", mesh=(1,), adj=g_mcl, iters=MCL_ITERS,
                 reps=SHARDED_REPS),
            dict(program="mcl", loop="host", mesh=(1,), adj=g_mcl, iters=MCL_ITERS),
            dict(program="serve", mesh=(1,), params=w1024, x=x_serve, reps=10)]
    ta = time.perf_counter()
    (res13, res16, mcl_dev1, mcl_host1, serve1), = run_world(
        run_jobs, 1, backend="nccl", device="cuda", args=(jobs,), timeout=600)
    world1_s = time.perf_counter() - ta
    assert_csr_allclose(csr_of(res13), spgemm_scipy(g13_, g13_), rtol=VAL_RTOL, atol=VAL_ATOL)
    print(f"world of one nccl rank: {world1_s:.3f} s from spawn to exit; the device MCL "
          f"loop's plans {mcl_plan_ms:.3f} ms each (host, made here for the roofline)")
    mcl_check("mcl_rmat14_4iter device loop (1,) nccl", [mcl_dev1], "device")
    if mcl_dev1["syncs"] > 2:
        raise RuntimeError(f"the device MCL loop on one nccl rank synchronised "
                           f"{mcl_dev1['syncs']} times, want <= 2 (its flags, its flow)")
    mcl_check("mcl_rmat14_4iter host loop (1,) nccl", [mcl_host1], "host")
    serve_check("SparseMLP.sharded dp=1 (nccl)", [serve1])

    # the same program in a world of one gloo rank here, on the card: the
    # rank's K3 and K1 inputs on rmat13 held to their plain versions bit
    # for bit, K2 held to its plain version on every received buffer it
    # merges (rmat13, and rmat16's two chunks), and rmat16's product held
    # to the single-device spgemm (67 M entries stay on this process's
    # side of the spawn)
    merges = []
    real_merge = tiled.merge_epilogue

    def catch(key, vals, n_cols, sentinel_row, pad_count=0):
        merges.append((key, vals, pad_count, n_cols, sentinel_row))
        return real_merge(key, vals, n_cols, sentinel_row, pad_count)

    def rank_expands(prog, label):
        """The rank's K3 group and K1 residue (one stream) expanded by the
        kernels and by their plain versions, bit for bit. Returns
        (K3 slots, K1 slots, K3 max |err|, K1 max |err|)."""
        (rx,) = prog.streams
        if rx.group is None or rx.gather is None:
            raise RuntimeError(f"{label}: the rank has no K3 group or no K1 residue")
        outs = [torch.empty(rx.group.slots, dtype=dt, device=dev)
                for dt in (torch.int32, torch.float32, torch.int32, torch.float32)]
        expand.expand_part_packed(rx.group, n_cols=prog.plan.n, out_keys=outs[0],
                                  out_vals=outs[1])
        expand.expand_part_packed_plain(rx.group, n_cols=prog.plan.n, out_keys=outs[2],
                                        out_vals=outs[3])
        g = rx.gather
        args = (g["bases"], g["table"], g["a_pack"], g["b_pack"], g["group_bits"])
        k1 = gexpand.expand_gather(*args, b_win=rx.b_win)
        k1p = gexpand.expand_gather_plain(*args, b_win=rx.b_win)
        torch.cuda.synchronize()
        for nm, (k, v, kp, vp) in (("K3", outs), ("K1", (*k1, *k1p))):
            if not (torch.equal(k, kp) and torch.equal(v.view(torch.int32), vp.view(torch.int32))):
                raise RuntimeError(f"{nm} on {label} is not bit-equal to plain")
        return (rx.group.slots, rx.slots - rx.group.slots, float((outs[1] - outs[3]).abs().max()),
                float((k1[1] - k1p[1]).abs().max()))

    mcl_merges = []
    real_mcl_merge = smcl.merge_epilogue

    def catch_mcl(key, vals, n_cols, sentinel_row, pad_count=0):
        if not mcl_merges:  # the first iteration's received buffer
            mcl_merges.append((key, vals, pad_count, n_cols, sentinel_row))
        return real_mcl_merge(key, vals, n_cols, sentinel_row, pad_count)

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", world_size=1, rank=0)
        try:
            mesh1 = Mesh((1,), ("x",), device=dev)
            prog13 = build_sharded_tiled(plan13, mesh1, "x")
            k3_slots, k1_slots, k3_err, k1_err = rank_expands(prog13, "the sharded rank's rmat13")
            # the MCL host loop's first squaring on this rank (K3, K1), and
            # the device loop's first merge buffer (K2, below)
            prog_h = build_sharded_tiled(shard_plan_tiled(flow0.to_csc(), flow0, kx=1), mesh1, "x")
            h3_slots, h1_slots, h3_err, h1_err = rank_expands(
                prog_h, "the MCL host loop's first squaring")
            k3_err, k1_err = max(k3_err, h3_err), max(k1_err, h1_err)
            del prog_h
            smcl.merge_epilogue = catch_mcl
            try:
                smcl.build_mcl_sharded_device(mcl_plans[(1,)], mesh1, "x").run()
            finally:
                smcl.merge_epilogue = real_mcl_merge
            tiled.merge_epilogue = catch
            try:
                out13 = prog13.run()
                out16 = spgemm_sharded_tiled(plan16, mesh1, "x")
            finally:
                tiled.merge_epilogue = real_merge
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    print(f"K3 ({k3_slots} / {h3_slots} slots) and K1 ({k1_slots} / {h1_slots} slots) == plain "
          f"bit for bit on the sharded rank's rmat13 inputs / the MCL host loop's first "
          f"squaring")
    merges += mcl_merges
    if len(merges) != 2 + plan16.chunks:
        raise RuntimeError(f"K2 merged {len(merges)} received buffers, want 2 + {plan16.chunks}")
    k2_err, k2_slots = 0.0, []
    for key, vals, pad, n_cols, sentinel in merges:
        got = scan.merge_epilogue_scan(key, vals, pad, n_cols=n_cols, sentinel_row=sentinel)
        want = scan.merge_epilogue_plain(key, vals, pad, n_cols=n_cols, sentinel_row=sentinel)
        torch.cuda.synchronize()
        for i, nm in ((0, "rows"), (1, "cols"), (3, "valid"), (4, "nnz")):
            if not torch.equal(got[i], want[i]):
                raise RuntimeError(f"K2 {nm} disagree with plain on a sharded received buffer")
        if not torch.allclose(got[2], want[2], rtol=VAL_RTOL, atol=VAL_ATOL):
            raise RuntimeError("K2 values disagree with plain on a sharded received buffer")
        k2_err = max(k2_err, float((got[2] - want[2]).abs().max()))
        k2_slots.append(key.numel())
        del got, want
    del merges
    if int(out13.nnz) != res13["nnz"] or int(out16.nnz) != res16["nnz"]:
        raise RuntimeError(f"the gloo rank's nnz ({int(out13.nnz)}, {int(out16.nnz)}) differ from "
                           f"the nccl rank's ({res13['nnz']}, {res16['nnz']})")
    want16 = spgemm(a16, b16, device=dev)
    assert_csr_allclose(out16.to_csr(), want16, rtol=VAL_RTOL, atol=VAL_ATOL)
    del out13, out16
    print(f"K2 == plain (structure and nnz exact, values max |err| {k2_err:.3e}) on the "
          f"received buffers the tiled program merges and the device MCL loop's first "
          f"({k2_slots} slots); sharded_rmat16_1x1 == the single-device spgemm on the card "
          f"(nnz {want16.nnz}), exact, in a gloo world of one")
    del want16
    # K5 on one dp = 8 rank's shard of the serving batch, layer by layer
    h = x_dev[:MLP_BATCH // 8].T
    k5_err = 0.0
    for li, layer in enumerate(serve_single.layers):
        n_cols = h.shape[1]
        hp = h.new_zeros((layer.k_pad, -(-n_cols // TN) * TN))
        hp[:h.shape[0], :n_cols] = h
        y = spmm.spmm_blockell_device(layer.meta, layer.blocks, hp, tn=TN)
        yp = spmm.spmm_blockell_plain(layer.meta, layer.blocks, hp)
        err = float((y - yp).abs().max())
        if not err <= K5_REL * float(yp.abs().max()):
            raise RuntimeError(f"K5 on a dp=8 rank's shard, layer {li}: max |err| {err:.3e}")
        k5_err = max(k5_err, err)
        h = y[:layer.out_dim, :n_cols] + layer.bias[:, None]
        if li < len(serve_single.layers) - 1:
            h = torch.relu(h)
    print(f"K5 == plain on a dp=8 rank's shard ({MLP_BATCH // 8} rows, 3 layers) within "
          f"{K5_REL} of max |y| (max |err| {k5_err:.3e})")
    for name, res, plan in (("sharded_rmat13_1x1", res13, plan13),
                            ("sharded_rmat16_1x1", res16, plan16)):
        counts = tally(name, [res], path_of(plan))
        tp = plan_tiled_parts(ops[name][1], ops[name][2], device=dev)
        single_ms = _median_ms(torch, lambda: spgemm_padded_tiled_parts(tp), reps=SHARDED_REPS)
        del tp
        check = "== scipy" if res is res13 else "== the single-device spgemm on the card"
        event = simulate_sharded_tiled(plan)["seconds"]
        print(f"{name}: {check} (nnz {res['nnz']}), exact; {res['mesh']}; plan "
              f"{ops[name][4]:.3f} ms ({'rebased, ' if plan.rebase else ''}{plan.chunks} "
              f"chunk(s), {plan.merge_parts} merge part(s), capacity {plan.capacity}); warm "
              f"{res['median_s'] * 1e3:.4f} ms per op (CUDA events, median of "
              f"{SHARDED_REPS}: {', '.join(f'{t * 1e3:.4f}' for t in res['seconds'])}); the "
              f"single-device tiles pipeline on the same operand {single_ms:.4f} ms; roofline "
              f"{predict_sharded_tiled(plan) * 1e3:.4f} ms; event model {event * 1e3:.4f} ms "
              f"({event / res['median_s']:.3f} of the measured); launches {counts}")
    _phase("sharded world of 1 (nccl)", t0)

    # ---- one world of 8 ranks sharing the card over gloo
    t1 = time.perf_counter()
    a14 = rmat(14, edge_factor=8, seed=1)
    c14, r14 = a14.to_csc(), a14.to_csr()
    cases = [  # (label, job)
        ("rmat14_ef8 spgemm_sharded (8,)", dict(program="sharded", mesh=(8,),
                                                plan=shard_plan(c14, r14, 8))),
        ("rmat14_ef8 spgemm_sharded_2d (4, 2)",
         dict(program="sharded_2d", mesh=(4, 2), plan=shard_plan_2d(c14, r14, 4, 2))),
        ("rmat14_ef8 spgemm_sharded_tiled (8,)",
         dict(program="tiled", mesh=(8,), plan=shard_plan_tiled(c14, r14, kx=8), reps=3)),
        ("rmat14_ef8 spgemm_sharded_tiled (4, 2) chunks 2",
         dict(program="tiled", mesh=(4, 2), reps=3,
              plan=shard_plan_tiled(c14, r14, kx=4, ny=2, exchange_chunks=2))),
    ]
    jobs = [dict(job, csr=True, entries=False) for _, job in cases]
    jobs.append(dict(program="triangles", mesh=(4, 2), adj=rmat(13, edge_factor=8, seed=4)))
    # the dry run's jobs (the JAX dryrun's operands and seeds) in this world
    d_jobs, d_finish = dryrun_jobs(8, dev)
    d_at = len(jobs)
    jobs += d_jobs
    # mcl_rmat14_4iter by both loops, MLP1w served on dp = 8, and three
    # dp 4 × tp 2 steps of MLP1w at b1024 in float32 and float64
    mcl_at = len(jobs)
    mcl_jobs = [("device loop (8,)", dict(program="mcl", loop="device", mesh=(8,), adj=g_mcl,
                                          iters=MCL_ITERS, reps=SHARDED_REPS)),
                ("device loop (4, 2)", dict(program="mcl", loop="device", mesh=(4, 2), adj=g_mcl,
                                            iters=MCL_ITERS, reps=SHARDED_REPS)),
                ("host loop (8,)", dict(program="mcl", loop="host", mesh=(8,), adj=g_mcl,
                                        iters=MCL_ITERS))]
    jobs += [job for _, job in mcl_jobs]
    jobs.append(dict(program="serve", mesh=(8,), params=w1024, x=x_serve, reps=10))
    tp_cfg = train.TrainConfig(model_type="MLP1w", l2reg=True)
    tp_sd = init_lecun_normal_(make_model("MLP1w"), seed=0).state_dict()
    # (4, 2) in both dtypes; (8, 1), data parallel alone, in float32: its
    # gap to one device is the split batch's, with no tp in it
    tp_runs = (((4, 2), torch.float32), ((4, 2), torch.float64), ((8, 1), torch.float32))
    jobs += [dict(program="train", mesh=mesh, cfg=tp_cfg, steps=3, y=y_serve,
                  state_dict={k: v.to(dt) for k, v in tp_sd.items()},
                  x=x_serve.astype(np.float64 if dt == torch.float64 else np.float32))
             for mesh, dt in tp_runs]
    print(f"sharded world of 8 gloo ranks: plans {time.perf_counter() - t1:.3f} s")
    ta = time.perf_counter()
    world = run_world(run_jobs, 8, backend="gloo", device="cuda", args=(jobs,), timeout=900)
    world8_s = time.perf_counter() - ta
    per_job = [[r[i] for r in world] for i in range(len(jobs))]
    for (label, job), res in zip(cases, per_job):
        got = csr_of(res[0])
        assert_csr_allclose(got, want1, rtol=VAL_RTOL, atol=VAL_ATOL)
        path = ("K2",) if job["program"] != "tiled" else path_of(job["plan"])
        counts = tally(label, res, path)
        timing = ""
        if "median_s" in res[0]:
            slowest = max(r["median_s"] for r in res)
            timing = f"; warm {slowest * 1e3:.4f} ms per op (slowest rank, median of 3)"
        print(f"{label}: nnz {got.nnz} == scipy, exact{timing}; launches (8 ranks) {counts}")
    tri = per_job[len(cases)]
    counts = tally("triangle_count_sharded (4, 2)", tri, ("K1", "K2"))
    if [r["count"] for r in tri] != [tri_want] * 8:
        raise RuntimeError(f"triangle_count_sharded rmat13 (4, 2): {[r['count'] for r in tri]}, "
                           f"scipy {tri_want}")
    print(f"triangle_count_sharded triangles_rmat13 (4, 2): {tri_want} == scipy on every rank "
          f"({max(r['seconds'][0] for r in tri) * 1e3:.3f} ms, plan included); launches {counts}")
    d_res = per_job[d_at:mcl_at]
    line = d_finish(d_res)
    if MULTICHIP_RECORD not in line:
        raise RuntimeError(f"dryrun_multichip(8): {line}; the record says {MULTICHIP_RECORD}")
    for job, res in zip(d_jobs, d_res):
        path = (path_of(job["plan"]) if job["program"] == "tiled" else
                {"train": (), "serve": ("K5",)}.get(job["program"], ("K2",)))
        tally(f"dryrun {job['program']} job", res, path)
    print(f"{line}; launches (8 ranks) "
          + json.dumps({k: sum(r["launches"][k] for res in d_res for r in res) for k in launches}))
    for (label, _), res in zip(mcl_jobs, per_job[mcl_at:]):
        mcl_check(f"mcl_rmat14_4iter {label} gloo", res, label.split()[0])
    serve_check("SparseMLP.sharded dp=8 (gloo)", per_job[mcl_at + len(mcl_jobs)])
    # float64: every element within 1e-10 of the largest |value| of its
    # tensor. float32: each tensor within 1e-5 in norm (‖Δ‖ / ‖ref‖), its
    # largest element gap printed: Adam steps a weight whose gradient is
    # within rounding of zero by up to lr whatever that gradient's size,
    # so a split batch parts single elements further
    for (mesh, dt), res in zip(tp_runs, per_job[mcl_at + len(mcl_jobs) + 1:]):
        x_tp = torch.from_numpy(x_serve).to(dt)
        losses, ref = _steps(torch, train, "MLP1w", {k: v.to(dt) for k, v in tp_sd.items()},
                             x_tp, torch.from_numpy(y_serve).long(), tp_cfg, dev)
        got = {k: torch.from_numpy(v) for k, v in res[0]["state_dict"].items()}
        max_rel = max(float((got[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref)
        norm_rel = max(float((got[k] - ref[k]).norm() / ref[k].norm()) for k in ref)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(res[0]["losses"], losses))
        bar, rel = (1e-10, max_rel) if dt == torch.float64 else (1e-5, norm_rel)
        label = f"dp {mesh[0]} x tp {mesh[1]}"
        if not (rel <= bar and loss_rel <= bar):
            raise RuntimeError(f"the {label} step ({dt}) vs the single-device train_step: "
                               f"params {rel:.3e}, losses {loss_rel:.3e} apart, want {bar}")
        tally(f"{label} step {dt}", res, ())
        step_ms = max(statistics.median(r["seconds"]) for r in res) * 1e3
        print(f"{label} MLP1w b{MLP_BATCH} l2reg, 3 steps in {str(dt)[6:]} against three "
              f"single-device train_steps on the card: losses within {loss_rel:.3e} relative, "
              f"parameters within {norm_rel:.3e} in norm and {max_rel:.3e} elementwise, "
              f"relative (want {bar} {'elementwise' if dt == torch.float64 else 'in norm'}); "
              f"{step_ms:.3f} ms a step (CUDA events, slowest rank, median of 3); losses "
              f"{res[0]['losses']}")
    _phase("sharded world of 8 (gloo, one card)", t1)

    # ---- the command line's --mesh: the five runs side by side, each in
    # a thread of its own with its own world (a process that starts
    # takes ~9 s to reach the card; the times they print share the card
    # and the host's cores)
    t1 = time.perf_counter()
    runs = {
        "spgemm --mesh 1": ["spgemm", f14, f14, "--no-transpose", "--mesh", "1"],
        "spgemm --mesh 4,2 --dist-backend gloo": ["spgemm", f14, f14, "--no-transpose", "--mesh",
                                                  "4,2", "--dist-backend", "gloo"],
        "graph triangles --mesh 4,2 --dist-backend gloo": ["graph", "triangles", g13, "--mesh",
                                                           "4,2", "--dist-backend", "gloo"],
        "graph mcl --mesh 1 --loop device": ["graph", "mcl", g14, "--iters", str(MCL_ITERS),
                                             "--mesh", "1", "--loop", "device"],
        "graph mcl --mesh 4,2 --loop host --dist-backend gloo": [
            "graph", "mcl", g14, "--iters", str(MCL_ITERS), "--mesh", "4,2", "--loop", "host",
            "--dist-backend", "gloo"],
    }
    out = _ThreadStdout(sys.stdout)
    rcs = {}

    def run_cli(label):
        out.bufs[threading.get_ident()] = texts[label] = []
        try:
            rcs[label] = cli.main([*runs[label], "--device", "cuda"])
        except BaseException as e:  # raised below, in the phase's thread
            rcs[label] = e

    texts = {}
    threads = [threading.Thread(target=run_cli, args=(label,)) for label in runs]
    with contextlib.redirect_stdout(out):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    texts = {label: "".join(parts) for label, parts in texts.items()}
    for label, rc in rcs.items():
        if isinstance(rc, BaseException):
            raise RuntimeError(f"cli {label} raised") from rc
        if rc != 0:
            raise RuntimeError(f"cli {label}: exit {rc}\n{texts[label]}")
    counts = {}
    for label, text in texts.items():
        found = re.search(r"kernel launches \(all ranks[^)]*\): (.+)", text)
        counts[label] = {k: int(v) for k, v in re.findall(r"(K\d) (\d+)", found.group(1))}
        for k in launches:
            launches[k] += counts[label].get(k, 0)
    for label in list(runs)[:2]:
        text = texts[label]
        nnz = int(re.search(r"nnz: (\d+)", text).group(1))
        flops = int(re.search(r"multiply flops: (\d+)", text).group(1))
        if (nnz, flops) != (want1.nnz, spgemm_flops(c14, r14)):
            raise RuntimeError(f"cli {label}: nnz {nnz}, flops {flops}")
        if not all(counts[label].get(k) for k in ("K1", "K2")):
            raise RuntimeError(f"cli {label}: launches {counts[label]}")
        measured = re.search(r"measured \(sharded, warm, median of 3\): ([\d.]+) ms", text).group(1)
        roof = re.search(r"analytical sharded \(roofline\):\s+([\d.]+) ms", text).group(1)
        event = re.search(r"event-model sharded:\s+([\d.]+) ms (.*)", text)
        if event is None:
            raise RuntimeError(f"cli {label}: no event-model sharded line\n{text}")
        print(f"cli {label} rmat14_ef8: nnz {nnz}, flops {flops} exact; measured {measured} ms "
              f"(warm, median of 3, slowest rank, beside the other CLI worlds), roofline {roof} "
              f"ms, event model {event.group(1)} ms {event.group(2)} = "
              f"{float(event.group(1)) / float(measured):.3f} of the measured; launches "
              f"{counts[label]}")
    label = list(runs)[2]
    got = int(re.search(r"triangles \(mesh 4x2, gloo\): (\d+)", texts[label]).group(1))
    if got != tri_want:
        raise RuntimeError(f"cli {label}: {got}, scipy {tri_want}")
    if not all(counts[label].get(k) for k in ("K1", "K2")):
        raise RuntimeError(f"cli {label}: launches {counts[label]}")
    print(f"cli {label} triangles_rmat13: {got} == scipy; launches {counts[label]}")
    for label in list(runs)[3:]:
        text = texts[label]
        found = re.search(r"mcl \(mesh (\dx\d), (\w+) loop\): (\d+) clusters \(([\d.]+) ms\)",
                          text)
        if found is None or int(found.group(3)) != len(mcl["want_clusters"]):
            raise RuntimeError(f"cli {label}: {text[-2000:]}; scipy {len(mcl['want_clusters'])} "
                               "clusters")
        if not counts[label].get("K2") or ("device" in label and "fast path True" not in text):
            raise RuntimeError(f"cli {label}: launches {counts[label]}\n{text}")
        print(f"cli {label} mcl_rmat14_4iter: {found.group(3)} clusters == scipy's MCL "
              f"({found.group(4)} ms, beside the other CLI worlds); "
              f"{re.search(r'mcl sharded .*', text).group(0)}; launches {counts[label]}")
    _phase("sharded cli", t1)
    _phase("sharded", t0)
    return {"launches": launches, "K1 err": k1_err, "K2 err": k2_err, "K3 err": k3_err,
            "K5 err": k5_err}


class _ThreadStdout(io.TextIOBase):
    """A stdout that keeps the text of each registered thread apart
    (``bufs[thread id]``, a list); other threads write through."""

    def __init__(self, real):
        self.real, self.bufs = real, {}

    def write(self, text: str) -> int:
        buf = self.bufs.get(threading.get_ident())
        if buf is None:
            return self.real.write(text)
        buf.append(text)
        return len(text)

    def flush(self) -> None:
        self.real.flush()


def _steps(torch, train, model_type, sd, x, y, cfg, device, n=3):
    """``n`` train_steps from ``sd`` on (x, y) on ``device``: the losses
    and the final parameters, on the host."""
    model = train.load_model(model_type, sd, device=device)
    opt = train.make_optimizer(model, cfg)
    xd, yd = x.to(device), y.to(device)
    losses = [float(train.train_step(model, opt, xd, yd, cfg)[0]) for _ in range(n)]
    return losses, {k: v.cpu() for k, v in model.state_dict().items()}


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _nn_training_phase(torch, np, dev, kernels) -> dict:
    """Train, prune, finetune and serve MLP1w and LeNet at batch 1024 on
    the card (TF32 off, set by the caller), hold three steps on the card
    to three on the CPU, run the ``nn`` CLI's ``pf`` and serve its
    pickle, and multiply an exported layer through ``spgemm``. Returns
    the launches of the served and multiplied paths by kernel, and the
    training steps to time and trace."""
    from outerspace_tpu_torch import cli
    from outerspace_tpu_torch.convert import load_params, params_from_state_dict
    from outerspace_tpu_torch.formats import read_mtx
    from outerspace_tpu_torch.nn import prune, sparse_infer, train
    from outerspace_tpu_torch.nn.data import batch_index_sets, synthetic_mnist
    from outerspace_tpu_torch.nn.export import export_mlp1
    from outerspace_tpu_torch.ops import spgemm
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in kernels.items()}

    def serve(name, flax, requests, per_call, dense_params):
        """``requests`` through the sparse model; K5 ``per_call`` times
        per request and nothing else; logits within NN_REL of dense."""
        cls = sparse_infer.SparseLeNet if name == "LeNet" else sparse_infer.SparseMLP
        model = cls(flax, device=dev)
        outs, counts = counted(lambda: [model(x) for x in requests])
        if counts["K5"] != per_call * len(requests) or sum(counts.values()) != counts["K5"]:
            raise RuntimeError(f"{name}: launches {counts}, want K5 {per_call} per request only")
        dense = train.load_model(name, dense_params, device=dev).eval()
        with torch.no_grad():
            errs = [_rel_err(y, dense(torch.from_numpy(x).to(dev))[0]) for y, x in zip(outs, requests)]
        if not all(e < NN_REL for e in errs):
            raise RuntimeError(f"{name}: max |err| / max |y| {errs} over {NN_REL}")
        return counts, errs

    t0 = time.perf_counter()
    data = synthetic_mnist(NN_TRAIN_IMAGES, seed=0)
    pool = np.concatenate([data[k][0] for k in ("train", "val", "test")])
    launches = {n: 0 for n in kernels}
    finetuned, steps = {}, {}
    for name, conv_level in (("MLP1w", None), ("LeNet", 0.25)):
        t1 = time.perf_counter()
        cfg = train.TrainConfig(model_type=name, num_epochs=3, batch_size=NN_BATCH)
        res = train.train(data, cfg, verbose=False, device=dev)
        pruned = prune.prune_params(res.best_params, sparsity_level=0.1,
                                    conv_sparsity_level=conv_level)
        ft = train.finetune(data, dataclasses.replace(cfg, num_epochs=2), pruned, verbose=False,
                            device=dev)
        for label, params in (("final", ft.params), ("best", ft.best_params)):
            for k, w in pruned.items():
                back = int(((params[k] != 0) & (w == 0)).sum()) if k.endswith("weight") else 0
                if back:
                    raise RuntimeError(f"{name}: {back} pruned weights of {k} came back ({label})")
        nnz = sum(int((w != 0).sum()) for k, w in pruned.items() if k.endswith("weight"))
        numel = sum(w.numel() for k, w in pruned.items() if k.endswith("weight"))
        model = train.load_model(name, ft.best_params, device=dev)
        test_loss, test_acc = train.evaluate(model, *data["test"], NN_BATCH)
        trained_acc = train.evaluate(train.load_model(name, res.best_params, device=dev),
                                     *data["test"], NN_BATCH)[1]
        if not test_acc > 0.6:
            raise RuntimeError(f"{name}: test accuracy {test_acc:.4f} after finetune, want > 0.6")
        shape = (NN_BATCH, 784) if name == "MLP1w" else (NN_BATCH, 28, 28, 1)
        requests = [pool[i * NN_BATCH:(i + 1) * NN_BATCH].reshape(shape) for i in range(REQUESTS)]
        per_call = 3 if name == "MLP1w" else 5
        counts, errs = serve(name, params_from_state_dict(ft.best_params), requests, per_call,
                             ft.best_params)
        for k, c in counts.items():
            launches[k] += c
        print(f"nn training {name} b{NN_BATCH}: {NN_TRAIN_IMAGES} synthetic images, 3 epochs, "
              f"test acc {trained_acc:.4f}; pruned to {nnz}/{numel} weights (fc 0.1"
              f"{', conv 0.25' if conv_level else ''}), 2 finetune epochs, no pruned weight back, "
              f"test loss {test_loss:.4f} acc {test_acc:.4f} (> 0.6); served {REQUESTS} requests "
              f"through Sparse{'LeNet' if name == 'LeNet' else 'MLP'}, launches {counts}, each "
              f"within {NN_REL} of the dense model ({', '.join(f'{e:.3e}' for e in errs)}); "
              f"history {json.dumps(ft.history)}")
        finetuned[name] = ft.best_params
        _phase(f"nn training {name} main path", t1)

        # three steps on the card against three on the CPU from the carried
        # params and one batch: float64 (Adam steps a weight whose gradient
        # is within rounding of zero by up to 2·lr, so float32 parameters of
        # two devices part after a few steps), and float32 for one step's
        # loss and gradients
        t1 = time.perf_counter()
        idx = torch.from_numpy(batch_index_sets(data["train"][0].shape[0], NN_BATCH, seed=0)[0])
        x = torch.from_numpy(data["train"][0])[idx]
        y = torch.from_numpy(data["train"][1])[idx].long()
        l2 = train.TrainConfig(model_type=name, l2reg=True)
        host = {k: v.cpu() for k, v in res.best_params.items()}
        h64 = {k: v.double() for k, v in host.items()}
        cpu64, card64 = (_steps(torch, train, name, h64, x.double(), y, l2, d) for d in ("cpu", dev))
        loss_err = max(abs(a - b) for a, b in zip(cpu64[0], card64[0]))
        param_err = _max_diff(cpu64[1], card64[1])
        if not (loss_err <= 1e-5 and param_err <= 1e-5):
            raise RuntimeError(f"{name}: 3 float64 steps on the card vs the CPU: loss {loss_err:.3e}, "
                               f"params {param_err:.3e}, want both within 1e-5")
        grads = []
        for d in ("cpu", dev):
            m = train.load_model(name, host, device=d)
            loss, _ = train.loss_fn(m, x.to(d), y.to(d), l2)
            loss.backward()
            grads.append((loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()}))
        g_loss, g_err = abs(grads[0][0] - grads[1][0]), _max_diff(grads[0][1], grads[1][1])
        if not (g_loss <= 1e-5 and g_err <= 1e-5):
            raise RuntimeError(f"{name}: a float32 step's loss {g_loss:.3e} / gradients {g_err:.3e} "
                               f"apart on the card and the CPU (want 1e-5)")
        cpu32, card32 = (_steps(torch, train, name, host, x, y, l2, d) for d in ("cpu", dev))
        print(f"nn training {name} l2reg, card vs CPU from the trained params, batch {NN_BATCH}: "
              f"3 float64 steps, losses within {loss_err:.3e}, params within {param_err:.3e} "
              f"(want 1e-5); float32 step: loss within {g_loss:.3e}, gradients within {g_err:.3e} "
              f"(want 1e-5); 3 float32 steps for the record: losses "
              f"{max(abs(a - b) for a, b in zip(cpu32[0], card32[0])):.3e}, params "
              f"{_max_diff(cpu32[1], card32[1]):.3e} apart")
        model = train.load_model(name, res.best_params, device=dev)
        opt = train.make_optimizer(model, cfg)
        xs = torch.from_numpy(data["train"][0]).to(dev)
        ys = torch.from_numpy(data["train"][1]).to(dev).long()
        sets = torch.from_numpy(batch_index_sets(xs.shape[0], NN_BATCH, seed=1)).to(dev)
        steps[name] = (model, opt, cfg, xs, ys, sets)
        _phase(f"nn training {name} card vs CPU", t1)

    # the entry point: the nn CLI's pf on the card, its pickle served
    t1 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_nn"
    shutil.rmtree(out_dir, ignore_errors=True)
    pkl = str(out_dir / "pf.pkl")
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        rc = cli.main(["nn", "--mode", "pf", "--model_type", "MLP1", "--data", "synthetic",
                       "--num_epochs", "1", "--saved_model_name", pkl])
    if rc != 0:
        raise RuntimeError(f"cli nn --mode pf exited {rc}: {cli_out.getvalue()[-2000:]}")
    flax = load_params(pkl)
    from outerspace_tpu_torch.convert import state_dict_from_params

    counts, errs = serve("MLP1", flax, [pool[:NN_BATCH].reshape(NN_BATCH, 784)], 3,
                         state_dict_from_params(flax))
    for k, c in counts.items():
        launches[k] += c
    tags = [ln for ln in cli_out.getvalue().splitlines() if ln.split(":")[0] in
            ("trained", "pruned", "finetuned")]
    print(f"cli nn --mode pf (MLP1, synthetic, 1 epoch, on the card): {'; '.join(tags)}; its "
          f"pickle served through SparseMLP, launches {counts}, within {NN_REL} ({errs[0]:.3e})")
    _phase("nn training CLI pf", t1)

    # export: the finetuned MLP1w on 64 test images, one layer through spgemm
    t1 = time.perf_counter()
    files = export_mlp1(finetuned["MLP1w"], data["test"][0][:64], str(out_dir / "mtx"), device=dev)
    act, w = read_mtx(files["act_1"]), read_mtx(files["fc2_weight"])
    want = spgemm_scipy(act, w.T)
    got, counts = counted(lambda: spgemm(act, w.T, device=dev))
    assert_csr_allclose(got, want, rtol=VAL_RTOL, atol=VAL_ATOL)
    if counts["K2"] == 0:
        raise RuntimeError(f"exported act_1 x fc2_weightᵀ: launches {counts}, want K2")
    for k, c in counts.items():
        launches[k] += c
    print(f"exported MLP1w act_1 {act.shape} nnz {act.nnz} x fc2_weightᵀ {w.T.shape} nnz {w.nnz} "
          f"through spgemm: nnz {got.nnz} == scipy, structure exact, values within rtol "
          f"{VAL_RTOL} atol {VAL_ATOL}; launches {counts}")
    _phase("nn training export", t1)

    # time per step (CUDA events), images/s, one epoch's steps (host clock)
    t1 = time.perf_counter()
    for name, (model, opt, cfg, xs, ys, sets) in steps.items():
        batch = iter(range(10**9))

        def step(model=model, opt=opt, cfg=cfg, xs=xs, ys=ys, sets=sets, batch=batch):
            idx = sets[next(batch) % sets.shape[0]]
            return train.train_step(model, opt, xs[idx], ys[idx], cfg)

        ms = _median_ms(torch, step)
        torch.cuda.synchronize()
        ta = time.perf_counter()
        for _ in range(sets.shape[0]):
            step()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - ta
        print(f"nn training {name} b{NN_BATCH} train_step: {ms:.4f} ms by CUDA events (median of "
              f"10), {NN_BATCH / ms * 1e3:.0f} images/s; one epoch of {sets.shape[0]} steps "
              f"{epoch_s:.4f} s on the host clock ({sets.shape[0] * NN_BATCH / epoch_s:.0f} "
              f"images/s)")
        steps[name] = step
    _phase("nn training timing", t1)
    _phase("nn training", t0)
    return {"launches": launches, "steps": steps}


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1

    from outerspace_tpu_torch import bench
    from outerspace_tpu_torch.convert import load_params, state_dict_from_params
    from outerspace_tpu_torch.formats import erdos_renyi, read_mtx, rmat
    from outerspace_tpu_torch.nn import sparse_infer
    from outerspace_tpu_torch.nn.data import synthetic_mnist
    from outerspace_tpu_torch.nn.export import im2col
    from outerspace_tpu_torch.nn.models import make_model
    from outerspace_tpu_torch.ops import graph, spgemm
    from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather
    from outerspace_tpu_torch.ops.kernels import counters, expand, gexpand, scan, spmm
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
    from outerspace_tpu_torch.ops.spgemm import (
        I32_MAX,
        TiledPartsPlan,
        _expand_light_packed,
        merge_biased_keys,
        plan_tiled_parts,
        plan_to_device,
    )
    from outerspace_tpu_torch.ops.symbolic import expansion_plan
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.sched import autotune
    from outerspace_tpu_torch.sched.gplanner import GROUP_SUBS
    from outerspace_tpu_torch.sched.planner import TILE_A_CLASSES

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc: {release[0].strip() if release else nvcc.stdout.strip()}")
    card = _card_line()
    print(f"card: {card}")
    _phase("toolchain", t0)

    t0 = time.perf_counter()
    for name, log in build.build((*build.KERNEL_SOURCES, "simcal")).items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}")
    # the planner core, the .mtx reader, the CPU reference, the event model
    for name in build.HOST_SOURCES:
        print(f"  g++ {name}: {build.build_host(name).name}")
    _phase("build", t0)
    _event_model_machine(dev)

    kernels = counters()

    def drive(name, a, want, path, **kw):
        """One path once through the user entry point, counted: every
        kernel of ``path`` must launch."""
        t0 = time.perf_counter()
        for k in kernels.values():
            k.launches = 0
        got = spgemm(a, a, device=dev, **kw)
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        assert_csr_allclose(got, want, rtol=VAL_RTOL, atol=VAL_ATOL)
        print(f"{name}: A² nnz {got.nnz} == scipy {want.nnz}, structure exact, "
              f"values within rtol {VAL_RTOL} atol {VAL_ATOL}; launches per run {counts}")
        for n in path:
            if counts[n] == 0:
                raise RuntimeError(f"{name}: kernel {n} was never launched")
        _phase(f"{name} main path", t0)
        return counts

    a1 = rmat(14, edge_factor=8, seed=1)
    a2 = erdos_renyi(100_000, 100_000, 1e-4, seed=3)
    t0 = time.perf_counter()
    want1, want2 = spgemm_scipy(a1, a1), spgemm_scipy(a2, a2)
    _phase("scipy oracles", t0)
    launches = drive("rmat14_ef8 gather", a1, want1, ("K1", "K2"), strategy="gather")
    drive("er100k gather", a2, want2, ("K1", "K2"), strategy="gather")
    tiles = drive("rmat14_ef8 tiles", a1, want1, ("K3", "K1", "K2"), strategy="tiles")
    coords = drive("rmat14_ef8 tiles packed=False", a1, want1, ("K4", "K1"),
                   strategy="tiles", packed=False)
    drive("er100k tiles", a2, want2, ("K1", "K2"), strategy="tiles")
    launches["K3"], launches["K4"] = tiles["K3"], coords["K4"]
    # the flat strategy at full size: the packed merge (sort + K2) on
    # rmat14_ef8, the two-key merge past m·n = 2³² on er100k
    flat_k2 = {"rmat14_ef8": drive("rmat14_ef8 flat", a1, want1, ("K2",), strategy="flat")["K2"]}
    drive("er100k flat (two-key merge)", a2, want2, (), strategy="flat")

    # ---- the flat strategy on the fixtures the JAX bench forces onto it,
    # one of them with a pinned p_pad (an odd length past P)
    mtx = ROOT / "data" / "mtx"
    for fname in ("rmat10_ef8", "band2048_p5", "mesh2d_48"):
        a = read_mtx(str(mtx / f"{fname}.mtx"))
        want = spgemm_scipy(a, a)
        flat_k2[fname] = drive(f"{fname} flat", a, want, ("K2",), strategy="flat")["K2"]
    p_fix = expansion_plan(a.to_csc(), a.to_csr()).expansion_size + 5
    flat_k2[f"{fname} p_pad={p_fix}"] = drive(f"{fname} p_pad={p_fix} (flat)", a, want, ("K2",),
                                              p_pad=p_fix)["K2"]
    print(f"flat strategy, K2 launches per product: {json.dumps(flat_k2)}")

    # ---- strategy="auto": the cost model's pick under this card's weights
    auto_path = {"gather": ("K1", "K2"), "tiles": ("K1", "K2"), "flat": ("K2",)}
    for name, a, want in (("rmat14_ef8", a1, want1), ("er100k", a2, want2)):
        pick = autotune.autotune(a.to_csc(), a.to_csr())[0]
        drive(f"{name} auto (picks {pick})", a, want, auto_path[pick], strategy="auto")

    # ---- triangle counting: dense, sparse and auto against scipy
    t0 = time.perf_counter()
    tri_g = rmat(13, edge_factor=8, seed=4)
    tri_want = graph.triangle_count(tri_g, backend="scipy")
    sym = graph._symmetrize_simple(tri_g)
    tri_pick = graph._triangle_strategy(sym)
    for route, path in (("dense", ()), ("sparse", ("K3", "K1", "K2")), ("auto", ())):
        for k in kernels.values():
            k.launches = 0
        got = graph.triangle_count(tri_g, strategy=route, device=dev)
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        if got != tri_want:
            raise RuntimeError(f"triangles by the {route} route: {got}, scipy {tri_want}")
        for n in path:
            if counts[n] == 0:
                raise RuntimeError(f"triangles, {route} route: kernel {n} was never launched")
        print(f"triangles rmat13 {route}{f' (picks {tri_pick})' if route == 'auto' else ''}: "
              f"{got} == scipy; launches {counts}")
    _phase("triangles", t0)

    # ---- Markov clustering: mcl_rmat14_4iter, K1 and K2 on its path
    mcl_launches = _mcl_phase(torch, np, dev, kernels, _spin_cycles(torch))
    pc = _prune_compact_phase(torch, np, dev)
    wide = _wide_phase(torch, np, dev, kernels)

    # ---- sparse-NN inference: the trained weights, four requests per model
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 oracle and
    torch.backends.cudnn.allow_tf32 = False  # yardstick (cuDNN defaults to TF32)
    paths = {"MLP1w": WEIGHTS / "MLP1w" / "prune0p01_finetuned.pkl",
             "LeNet": WEIGHTS / "LeNet" / "pruned_finetuned"}
    missing = [str(p) for p in paths.values() if not p.exists()]
    if missing:
        raise FileNotFoundError(f"trained weights missing: {missing}")
    params = {k: load_params(p) for k, p in paths.items()}
    data = synthetic_mnist(REQUESTS * MLP_BATCH, seed=0)
    images = np.concatenate([data[k][0] for k in ("train", "val", "test")])
    served = {}
    for name, cls, batch, per_call in (("MLP1w", sparse_infer.SparseMLP, MLP_BATCH, 3),
                                       ("LeNet", sparse_infer.SparseLeNet, LENET_BATCH, 5)):
        model = cls(params[name], device=dev)
        dense = make_model(name).to(dev).eval()
        dense.load_state_dict(state_dict_from_params(params[name]))
        shape = (batch, 784) if name == "MLP1w" else (batch, 28, 28, 1)
        requests = [images[i * batch:(i + 1) * batch].reshape(shape) for i in range(REQUESTS)]
        for k in kernels.values():
            k.launches = 0
        outs = [model(x) for x in requests]
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        if counts["K5"] != per_call * REQUESTS or sum(counts.values()) != counts["K5"]:
            raise RuntimeError(f"{name}: launches {counts}, want K5 {per_call} per request only")
        with torch.no_grad():
            errs = [_rel_err(y, dense(torch.from_numpy(x).to(dev))[0])
                    for y, x in zip(outs, requests)]
        if not all(e < NN_REL for e in errs):
            raise RuntimeError(f"{name}: max |err| / max |y| {errs} over {NN_REL}")
        print(f"{name} sparse b{batch}: {REQUESTS} requests, each within {NN_REL} of the dense "
              f"model relative to max |y| ({', '.join(f'{e:.3e}' for e in errs)}); "
              f"launches {counts}")
        served[name] = (model, requests[0], dense)
        launches["K5"] = launches.get("K5", 0) + counts["K5"]
    _phase("sparse-NN main path", t0)

    t0 = time.perf_counter()
    _, x_lenet, dense = served["LeNet"]
    x8 = x_lenet[:8]
    for k in kernels.values():
        k.launches = 0
    got8 = sparse_infer.lenet_forward_spgemm(params["LeNet"], x8, backend="torch", device=dev)
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items()}
    if counts["K1"] == 0 or counts["K2"] == 0:
        raise RuntimeError(f"lenet_forward_spgemm: launches {counts}, want K1 and K2")
    with torch.no_grad():
        want8 = dense(torch.from_numpy(x8).to(dev))[0]
    e8 = _rel_err(torch.from_numpy(got8).to(dev), want8)
    if not e8 < NN_REL:
        raise RuntimeError(f"lenet_forward_spgemm: max |err| / max |y| {e8:.3e} over {NN_REL}")
    print(f"LeNet through SpGEMM, 8 images: within {NN_REL} of the dense model ({e8:.3e}); "
          f"launches {counts}")
    _phase("sparse-NN SpGEMM witness", t0)

    # ---- the NN training pipeline: train, prune, finetune, serve, export
    nn_train = _nn_training_phase(torch, np, dev, kernels)
    for k, c in nn_train["launches"].items():
        launches[k] = launches.get(k, 0) + c

    # ---- each kernel against its plain version, on workload 1's streams
    t0 = time.perf_counter()
    a_csc, b_csr = a1.to_csc(), a1.to_csr()
    plan = plan_spgemm_gather(a_csc, b_csr, device=dev)
    k1_in, k2_in, merge_in = [], [], []
    k1_err = k2_err = 0.0
    for p in plan.parts:
        d = p.dev
        args = (d["bases"], d["table"], d["a_pack"], d["b_pack"], d["group_bits"])
        k1_in.append((args, p))
        key, val = gexpand.expand_gather(*args, b_win=p.b_win)
        key_p, val_p = gexpand.expand_gather_plain(*args, b_win=p.b_win)
        torch.cuda.synchronize()
        key_diff = int((key != key_p).sum())
        val_diff = int((val.view(torch.int32) != val_p.view(torch.int32)).sum())
        k1_err = max(k1_err, float((val - val_p).abs().max()))
        if key_diff or val_diff:
            raise RuntimeError(f"K1 disagrees with its plain version (want bit-equal): "
                               f"{key_diff} keys, {val_diff} values differ")
        extra = p.merge_pad - key.shape[0]
        key = torch.cat([key, key.new_full((extra,), I32_MAX)])
        val = torch.cat([val, val.new_zeros(extra)])
        skey, order = torch.sort(key)
        sval = val[order]
        pad = p.merge_pad - p.p_real
        merge_in.append((key, val, pad))
        k2_in.append((skey, sval, pad))
        got = scan.merge_epilogue_scan(skey, sval, pad, n_cols=plan.n, sentinel_row=plan.m)
        want = scan.merge_epilogue_plain(skey, sval, pad, n_cols=plan.n, sentinel_row=plan.m)
        torch.cuda.synchronize()
        for i, nm in ((0, "rows"), (1, "cols"), (3, "valid"), (4, "nnz")):
            if not torch.equal(got[i], want[i]):
                raise RuntimeError(f"K2 {nm} disagrees with its plain version (want exact)")
        if not torch.allclose(got[2], want[2], rtol=VAL_RTOL, atol=VAL_ATOL):
            raise RuntimeError("K2 values disagree with its plain version")
        again = scan.merge_epilogue_scan(skey, sval, pad, n_cols=plan.n, sentinel_row=plan.m)
        if not torch.equal(again[2].view(torch.int32), got[2].view(torch.int32)):
            raise RuntimeError("K2 gave other values on a second launch (want bit-equal)")
        k2_err = max(k2_err, float((got[2] - want[2]).abs().max()))
    print(f"K1 == plain bit for bit on {len(plan.parts)} parts (values max |err| "
          f"{k1_err:.3e}); K2 structure and nnz exact, values max |err| {k2_err:.3e} "
          f"(rtol {VAL_RTOL}, atol {VAL_ATOL}), bit-equal over two launches")

    # K3 and K4 on every (part, class) table of the rmat14 tiled plan
    tplan = plan_tiled_parts(a_csc, b_csr, device=dev)
    if not isinstance(tplan, TiledPartsPlan):
        raise RuntimeError("rmat14_ef8 tiles: expected a row-parts plan")
    print(f"rmat14_ef8 tiled plan: {len(tplan.parts)} parts, merge_pad {tplan.merge_pad}, "
          f"rebased {tplan.rebased}")
    grouped = sum(tp.group is not None for _, _, tp in tplan.parts)
    if (tiles["K3"], coords["K4"]) != (grouped, grouped):
        raise RuntimeError(f"rmat14_ef8 tiles launched K3 {tiles['K3']} and K4 {coords['K4']} "
                           f"times; want once per part with class tables ({grouped})")
    tables = []
    for lo, hi, tp in tplan.parts:
        print(f"  rows [{lo}, {hi}): tasks per class "
              f"{[(s.tile_a, s.ntasks, s.ntasks_padded) for s in tp.class_plan.classes]}, "
              f"gather groups {tp.gather_ngroups}, stream {tp.padded_total}, group "
              f"{tp.group.layout if tp.group else None} "
              f"({tp.group.desc[:, 5].tolist() + [tp.group.slots // 1024] if tp.group else []} "
              f"unit offsets)")
        for sched, d in tp.class_tables():
            args = tuple(d[k] for k in ("tasks", "a_rows_t", "a_vals_t", "b_cols_blk", "b_vals_blk"))
            tables.append((sched, args, tp.n, tp.m))
    # K1 on the other streams the main paths ran: er100k's gather parts
    # and the tiled plans' residues (rmat14_ef8 and er100k)
    a2_csc, a2_csr = a2.to_csc(), a2.to_csr()
    tplan2 = plan_tiled_parts(a2_csc, a2_csr, device=dev)
    k1_tiles_in = _k1_calls(tplan)
    k1_other = {"er100k gather": _k1_calls(plan_spgemm_gather(a2_csc, a2_csr, device=dev)),
                "rmat14_ef8 tiles residue": k1_tiles_in,
                "er100k tiles residue": _k1_calls(tplan2)}
    for label, calls in k1_other.items():
        if not calls:
            raise RuntimeError(f"{label}: no K1 call to check")
        k1_err = max(k1_err, _k1_equal_plain(torch, gexpand, calls, label))
    print("K1 == plain bit for bit on " + ", ".join(
        f"{label} ({len(calls)} calls)" for label, calls in k1_other.items()))
    k3g_err = k4g_err = 0.0
    grouped_checked = {}
    for label, plan_ in (("rmat14_ef8 tiles", tplan), ("er100k tiles", tplan2)):
        checked, e3, e4 = _grouped_equal_plain(torch, expand, plan_, label)
        grouped_checked[label] = checked
        k3g_err, k4g_err = max(k3g_err, e3), max(k4g_err, e4)
    if not grouped_checked["rmat14_ef8 tiles"]:
        raise RuntimeError("rmat14_ef8 tiles: no part with class tables to check")
    print("the grouped K3 and K4 == plain bit for bit on every part with class tables: "
          + ", ".join(f"{label} {n} parts" for label, n in grouped_checked.items())
          + f" (values max |err| K3 {k3g_err:.3e}, K4 {k4g_err:.3e})")
    del tplan2

    k3_err, k4_err = k3g_err, k4g_err
    for sched, args, n_cols, sentinel in tables:
        ta = sched.tile_a
        got = expand.expand_tiles_packed(*args, tile_a=ta, n_cols=n_cols)
        want = expand.expand_tiles_packed_plain(*args, tile_a=ta, n_cols=n_cols)
        got_c = expand.expand_tiles_coords(*args, tile_a=ta, sentinel_row=sentinel)
        want_c = expand.expand_tiles_coords_plain(*args, tile_a=ta, sentinel_row=sentinel)
        torch.cuda.synchronize()
        k3_err = max(k3_err, float((got[1] - want[1]).abs().max()))
        k4_err = max(k4_err, float((got_c[2] - want_c[2]).abs().max()))
        for nm, g, w in (("K3 keys", got[0], want[0]), ("K4 rows", got_c[0], want_c[0]),
                         ("K4 cols", got_c[1], want_c[1])):
            if not torch.equal(g, w):
                raise RuntimeError(f"{nm} disagree with the plain version on a "
                                   f"tile_a={ta} table: {int((g != w).sum())} differ")
        for nm, g, w in (("K3", got[1], want[1]), ("K4", got_c[2], want_c[2])):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise RuntimeError(f"{nm} values not bit-equal to the plain version "
                                   f"on a tile_a={ta} table")
    print(f"K3 and K4 == plain bit for bit on {len(tables)} (part, class) tables "
          f"(values max |err| K3 {k3_err:.3e}, K4 {k4_err:.3e})")

    # K5 at every layer's real inputs, caught from one forward of each
    # model, with each layer's unpadded (in_dim, out_dim, columns)
    k5_calls, k5_real = {}, {}
    real_k5 = sparse_infer.spmm_blockell_device

    def catching(calls):
        def catch(meta, blocks, x, tn):
            calls.append((meta, blocks, x.clone(), tn))
            return real_k5(meta, blocks, x, tn)
        return catch

    def recording(dims):
        return lambda layer, inp, _: dims.append((layer.in_dim, layer.out_dim, inp[0].shape[1]))

    hooks = []
    try:
        for model_name, (model, x, _) in served.items():
            k5_calls[model_name], k5_real[model_name] = [], []
            sparse_infer.spmm_blockell_device = catching(k5_calls[model_name])
            hooks += [layer.register_forward_hook(recording(k5_real[model_name]))
                      for layer in model.modules() if isinstance(layer, sparse_infer.SparseLayer)]
            model(x)
    finally:
        sparse_infer.spmm_blockell_device = real_k5
        for h in hooks:
            h.remove()
    k5_err = 0.0
    for model_name, calls in k5_calls.items():
        for li, call in enumerate(calls):
            got, want = spmm.spmm_blockell_device(*call), spmm.spmm_blockell_plain(*call[:3])
            torch.cuda.synchronize()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            if not err <= K5_REL * scale:
                raise RuntimeError(f"K5 disagrees with its plain version on {model_name} layer "
                                   f"{li}: max |err| {err:.3e}, max |y| {scale:.3e}")
            k5_err = max(k5_err, err)
            nrb, mb, bm, bn = call[1].shape
            print(f"  K5 {model_name} layer {li}: W {nrb}x{mb} slots of ({bm}, {bn}), "
                  f"{int((call[0][:, 1] != 0).sum())} stored, X {tuple(call[2].shape)}: "
                  f"max |err| {err:.3e} (max |y| {scale:.3e})")
    print(f"K5 within {K5_REL} x max |y| of plain at all "
          f"{sum(map(len, k5_calls.values()))} layer shapes (max |err| {k5_err:.3e})")
    _phase("kernel check", t0)

    # ---- timing at workload 1's shapes (all parts of one run)
    t0 = time.perf_counter()

    def run_k1(fn):
        return lambda: [fn(*args, b_win=p.b_win) for args, p in k1_in]

    def run_k2(fn):
        return lambda: [fn(k, v, pad, n_cols=plan.n, sentinel_row=plan.m)
                        for k, v, pad in k2_in]

    def run_k3(fn):  # the earlier route: one launch per (part, class) table
        return lambda: [fn(*args, tile_a=s.tile_a, n_cols=n) for s, args, n, _ in tables]

    def run_k4(fn):
        return lambda: [fn(*args, tile_a=s.tile_a, sentinel_row=m) for s, args, _, m in tables]

    # the pipeline's route: one launch per part over its class tables,
    # into buffers allocated once (the pipeline writes its part stream)
    groups = [(tp.group, tp.n, tp.m) for _, _, tp in tplan.parts if tp.group is not None]
    g_out = [[torch.empty(g.slots, dtype=dt, device=dev)
              for dt in (torch.int32, torch.int32, torch.float32)] for g, _, _ in groups]

    def run_k3g(fn):
        return lambda: [fn(g, n_cols=n, out_keys=o[0], out_vals=o[2])
                        for (g, n, _), o in zip(groups, g_out)]

    def run_k4g(fn):
        return lambda: [fn(g, sentinel_row=m, out_rows=o[0], out_cols=o[1], out_vals=o[2])
                        for (g, _, m), o in zip(groups, g_out)]

    keys_raw = [gexpand.expand_gather(*args, b_win=p.b_win)[0] for args, p in k1_in]
    all_k5 = [c for calls in k5_calls.values() for c in calls]
    dense_ws = [_dense_w(torch, c[0], c[1], c[2].shape[0]) for c in all_k5]
    # the kernels and the library calls by CUDA events, the device's time
    # alone (_device_ms) and with the host's launches (_median_ms); the
    # plain versions synchronise inside, so only the latter
    runs = {"K1": run_k1(gexpand.expand_gather), "K2": run_k2(scan.merge_epilogue_scan),
            "torch.sort": lambda: [torch.sort(k) for k in keys_raw],
            "K3": run_k3g(expand.expand_part_packed), "K4": run_k4g(expand.expand_part_coords),
            "K3 per table": run_k3(expand.expand_tiles_packed),
            "K4 per table": run_k4(expand.expand_tiles_coords),
            "K5": lambda: [spmm.spmm_blockell_device(*c) for c in all_k5],
            "torch.matmul": lambda: [torch.matmul(w, c[2]) for w, c in zip(dense_ws, all_k5)]}
    spin = _spin_cycles(torch)
    dev_ms = {k: _device_ms(torch, fn, spin) for k, fn in runs.items()}
    call_ms = {k: _median_ms(torch, fn) for k, fn in runs.items()}
    k1_ms, k2_ms, sort_ms, k3_ms, k4_ms, k5_ms, k5_lib_ms = (
        dev_ms[k] for k in ("K1", "K2", "torch.sort", "K3", "K4", "K5", "torch.matmul"))
    run_k1_tiles = lambda: [gexpand.expand_gather(*args, b_win=b) for args, b in k1_tiles_in]
    k1_tiles_ms = _device_ms(torch, run_k1_tiles, spin)
    call_ms["K1 tiles residue"] = _median_ms(torch, run_k1_tiles)
    k1_plain_ms = _median_ms(torch, run_k1(gexpand.expand_gather_plain), reps=3, warmup=1)
    k2_plain_ms = _median_ms(torch, run_k2(scan.merge_epilogue_plain), reps=3, warmup=1)
    k3_plain_ms = _median_ms(torch, run_k3g(expand.expand_part_packed_plain), reps=3, warmup=1)
    k4_plain_ms = _median_ms(torch, run_k4g(expand.expand_part_coords_plain), reps=3, warmup=1)
    k5_plain_ms = _median_ms(torch, lambda: [spmm.spmm_blockell_plain(*c[:3]) for c in all_k5],
                             reps=3, warmup=1)
    k5_layer_ms = [_device_ms(torch, lambda c=c: spmm.spmm_blockell_device(*c), spin)
                   for c in all_k5]
    print("by CUDA events with the host's launches, ms: "
          + ", ".join(f"{k} {ms:.4f}" for k, ms in call_ms.items()))
    _phase("timing: kernels by CUDA events", t0)

    # bound: the larger of bytes moved (each input byte the function needs
    # read once, each output written once) over the HBM rate and float32
    # operations (K1, K3, K4: one multiply per real product; K2: one add
    # per real slot) over the peak. K1: see _k1_bytes (the tiles residue's
    # packs are its own, unpadded); K3 and K4: see _expand_bytes.
    k1_bytes = sum(_k1_bytes(args[1].shape[0], p.nab8, p.nbb8, k.numel())
                   for (args, p), k in zip(k1_in, keys_raw))
    k1_tiles_bytes = sum(_k1_bytes(args[1].shape[0], args[2].shape[0], args[3].shape[0],
                                   args[1].shape[0] * GROUP_SUBS * 1024)
                         for args, _ in k1_tiles_in)
    k2_bytes = sum(k.numel() * (4 + 4 + 4 + 4 + 4 + 1) + 4 for k, _, _ in k2_in)
    tile_products = sum(s.heavy_p for s, _, _, _ in tables)
    k3_parts = {k: sum(_expand_bytes(np, s, 8)[k] for s, _, _, _ in tables)
                for k in ("tasks", "a", "b", "out")}
    k3_bytes = sum(k3_parts.values())
    k4_bytes = k3_bytes + 4 * sum(s.padded_heavy for s, _, _, _ in tables)
    k1_bound, k1_by = _bound(k1_bytes, plan.flops)
    k1_tiles_bound = _bound(k1_tiles_bytes, 0)[0]
    k2_bound, k2_by = _bound(k2_bytes, plan.flops)
    k3_bound, k3_by = _bound(k3_bytes, tile_products)
    k4_bound, k4_by = _bound(k4_bytes, tile_products)
    n_slots = sum(k.numel() for k in keys_raw)
    tile_slots = sum(s.padded_heavy for s, _, _, _ in tables)
    print(f"rmat14_ef8 gather streams: {len(k1_in)} parts, {n_slots} slots "
          f"({plan.flops} real products)")
    pad_task_slots = sum((s.ntasks_padded - s.ntasks) * s.tile_a * 128 for s, _, _, _ in tables)
    print(f"rmat14_ef8 tile tables: {len(tables)} in {len(groups)} groups, {tile_slots} slots "
          f"({tile_products} real products; {pad_task_slots} slots of padding tasks); "
          f"K3 moves {k3_bytes} B (reads {k3_parts['tasks']} B of task rows, {k3_parts['a']} of "
          f"A, {k3_parts['b']} of B; writes {k3_parts['out']}), K4 {k4_bytes} B (4 B more per "
          f"slot written)")
    print("device time by CUDA events, ms (plain versions: each call, host included):")
    print(f"K1 {k1_ms:.4f} ms/run (plain {k1_plain_ms:.4f}, bound {k1_bound:.4f}); "
          f"K2 {k2_ms:.4f} ms/run (plain {k2_plain_ms:.4f}, bound {k2_bound:.4f}); "
          f"torch.sort {sort_ms:.4f} ms/run")
    print(f"K3 {k3_ms:.4f} ms/run in {len(groups)} launches, one per part (plain "
          f"{k3_plain_ms:.4f}, bound {k3_bound:.4f}, {100 * k3_bound / k3_ms:.1f}% of it; one "
          f"launch per table: {dev_ms['K3 per table']:.4f} in {len(tables)}); K4 {k4_ms:.4f} "
          f"ms/run in {len(groups)} (plain {k4_plain_ms:.4f}, bound {k4_bound:.4f}, "
          f"{100 * k4_bound / k4_ms:.1f}%; per table {dev_ms['K4 per table']:.4f}); before the "
          f"redesign, on an NVIDIA H100 80GB HBM3 at 700 W: {K34_BEFORE_MS}")
    # K5: the nominal work (2·bm·bn·N_pad flop per valid slot, every X row
    # of every stored block) is no floor for a kernel that skips empty
    # columns; its bound is the work these inputs need (_k5_real_work)
    k5_nominal = [_k5_work(np, c[0], c[1], c[2]) for c in all_k5]
    k5_need = [_k5_real_work(torch, c[0], c[1], d)
               for name in k5_calls for c, d in zip(k5_calls[name], k5_real[name])]
    k5_bound, k5_by = _bound(sum(w[0] for w in k5_need), sum(w[1] for w in k5_need))
    li = 0
    for model_name, calls in k5_calls.items():
        sl = slice(li, li + len(calls))
        layers = ", ".join(
            f"{ms:.4f} ms ({nz} nonempty columns; bound {_bound(b, f)[0]:.4f} by "
            f"{_bound(b, f)[1]}, {b} B, {f} flop; nominal {_bound(*nom)[0]:.4f})"
            for ms, (b, f, nz), nom in zip(k5_layer_ms[sl], k5_need[sl], k5_nominal[sl]))
        fwd_ms = sum(k5_layer_ms[sl])
        need_b, need_f = sum(w[0] for w in k5_need[sl]), sum(w[1] for w in k5_need[sl])
        fwd_bound, fwd_by = _bound(need_b, need_f)
        nom_bound, nom_by = _bound(sum(w[0] for w in k5_nominal[sl]),
                                   sum(w[1] for w in k5_nominal[sl]))
        print(f"K5 {model_name} per layer: {layers}")
        print(f"K5 {model_name} summed {fwd_ms:.4f} ms per forward; the work its inputs need: "
              f"{need_f} flop, {need_b} B, bound {fwd_bound:.4f} ms by {fwd_by} "
              f"({100 * fwd_bound / fwd_ms:.1f}% of the summed time); nominal bound "
              f"{nom_bound:.4f} ms by {nom_by}")
        li += len(calls)
    print(f"K5 {k5_ms:.4f} ms for one MLP1w and one LeNet forward's {len(all_k5)} layers "
          f"(plain {k5_plain_ms:.4f}, torch.matmul of the densified W {k5_lib_ms:.4f}, "
          f"bound {k5_bound:.4f} by {k5_by}); K5 {'below' if k5_ms < k5_lib_ms else 'NOT below'} "
          f"torch.matmul, {k5_lib_ms / k5_ms:.2f}x")

    # ---- the cost model's per-element weights on this card, ns per slot
    # (device-only CUDA events on rmat14_ef8's streams): K1 per gather
    # slot, torch.sort + K2 per merge-stream slot, the flat expand per
    # slot of the flat plan, K3 per padded slot of each tile class
    merge_ms = _device_ms(torch, lambda: [merge_biased_keys(k, v, plan.n, plan.m, pad)
                                          for k, v, pad in merge_in], spin)
    merge_slots = sum(k.numel() for k, _, _ in merge_in)
    fplan = expansion_plan(a_csc, b_csr)
    fdev, f_pad = plan_to_device(fplan, dev), fplan.padded_size()
    flat_ms = _device_ms(torch, lambda: _expand_light_packed(
        **fdev, p_pad=f_pad, sentinel_row=fplan.m, n_cols=fplan.n), spin)
    tile_ns = {}
    for ta in TILE_A_CLASSES:
        sel = [(s, args, n) for s, args, n, _ in tables if s.tile_a == ta]
        if sel:
            ms = _device_ms(torch, lambda sel=sel, ta=ta: [
                expand.expand_tiles_packed(*args, tile_a=ta, n_cols=n) for _, args, n in sel], spin)
            tile_ns[ta] = ms * 1e6 / sum(s.padded_heavy for s, _, _ in sel)
    del fdev
    weights = {"GATHER_NS": k1_ms * 1e6 / n_slots, "SORT_NS": merge_ms * 1e6 / merge_slots,
               "FLAT_NS": flat_ms * 1e6 / f_pad, "TILE_NS_BY_CLASS": tile_ns}
    print(f"cost-model weights measured on this card, ns per slot (device-only CUDA events; "
          f"K1 {k1_ms:.4f} ms over {n_slots} slots, sort + K2 {merge_ms:.4f} ms over "
          f"{merge_slots}, flat expand {flat_ms:.4f} ms over {f_pad}): {json.dumps(weights)}")
    print("cost-model weights in use: " + json.dumps({
        "GATHER_NS": autotune.GATHER_NS, "SORT_NS": autotune.SORT_NS, "FLAT_NS": autotune.FLAT_NS,
        "TILE_NS_BY_CLASS": autotune.TILE_NS_BY_CLASS, "GATHER_FILL": autotune.GATHER_FILL,
        "TILES_MARGIN": autotune.TILES_MARGIN}))

    t1 = time.perf_counter()
    splits = {}
    for op, x_csc, x_csr, want in (("rmat14_ef8", a_csc, b_csr, want1),
                                   ("er100k", a2_csc, a2_csr, want2)):
        for st in ("gather", "tiles", "flat"):
            splits[op, st], samples, got = _split_ms(torch, *bench.strategy_fns(st, x_csc, x_csr, dev))
            assert_csr_allclose(got, want, rtol=VAL_RTOL, atol=VAL_ATOL)
            plan_ms, device_ms, fetch_ms = splits[op, st]
            print(f"{op} {st} end to end {plan_ms + device_ms + fetch_ms:.3f} ms: host plan "
                  f"{plan_ms:.3f}, device {device_ms:.3f}, fetch to CSR {fetch_ms:.3f} "
                  f"(result == scipy; samples: "
                  + ", ".join(f"{sum(x[:3]):.3f} [device {x[1]:.3f}, {x[3]} cudaMalloc]"
                              for x in samples) + ")")
    for op, x_csc, x_csr, x_plan in (("rmat14_ef8", a_csc, b_csr, plan),
                                     ("er100k", a2_csc, a2_csr, None)):
        cost, wl, padded = autotune.strategy_costs(x_csc, x_csr)
        if x_plan is None:
            x_plan = plan_spgemm_gather(x_csc, x_csr, device=dev)
        fill = sum(p.merge_pad for p in x_plan.parts) / x_plan.flops
        print(f"{op} auto picks {autotune.autotune(x_csc, x_csr)[0]} (waste limit {wl}, padded "
              f"tile stream {padded}); modeled device ms under the weights in use: "
              + ", ".join(f"{st} {ns / 1e6:.4f}" for st, ns in cost.items())
              + "; measured end to end ms (device ms): "
              + ", ".join(f"{st} {sum(splits[op, st]):.3f} ({splits[op, st][1]:.3f})"
                          for st in cost)
              + f"; gather merge stream {fill:.4f} x the products")
    _phase("timing: end-to-end splits", t1)

    # ---- the command line: spgemm, graph, the readers, the reference
    cli_launches = _cli_phase(torch, np, dev, kernels, splits, tri_want, mcl_launches["clusters"],
                              dev_ms)
    for k, c in cli_launches.items():
        launches[k] = launches.get(k, 0) + c

    # ---- the benchmark suite's smoke subset, in process
    for k, c in _bench_phase(torch, dev, kernels).items():
        launches[k] += c

    # ---- the sharded mode: a world of 1 on nccl, 8 ranks sharing the card, --mesh
    cli_dir = ROOT / "build" / "chip_smoke_cli"
    sharded = _sharded_phase(torch, np, dev, want1, tri_want, str(cli_dir / "rmat14_ef8.mtx"),
                             str(cli_dir / "triangles_rmat13.mtx"), str(cli_dir / "mcl_rmat14.mtx"),
                             mcl_launches)
    for k, c in sharded["launches"].items():
        launches[k] += c

    pipelines = [(st, *bench.strategy_fns(st, a_csc, b_csr, dev)) for st in ("gather", "tiles")]
    pipelines = [(st, plan_fn(), run_fn) for st, plan_fn, run_fn in pipelines]

    # the triangle routes, each from the symmetric adjacency on the host
    # to the count (the selector's weights) and on the device alone
    t1 = time.perf_counter()
    n_pad = graph._n_pad(sym)
    products = int((np.bincount(sym.row, minlength=sym.shape[0]).astype(np.int64) ** 2).sum())
    dense_ms = _host_ms(lambda: graph.triangle_count_dense(sym, device=dev))
    sparse_ms = _host_ms(lambda: graph.triangle_count_device(graph.triangle_prepare(sym, device=dev)))
    rows_d = torch.from_numpy(sym.row.astype(np.int64)).to(dev)
    cols_d = torch.from_numpy(sym.col.astype(np.int64)).to(dev)
    prep = graph.triangle_prepare(sym, device=dev)
    dense_dev = _median_ms(torch, lambda: graph._tri_dense_total(rows_d, cols_d, n_pad))
    sparse_dev = _median_ms(torch, lambda: graph._tri_sparse_total(prep))
    print(f"triangles rmat13 (n_pad {n_pad}, {products} sparse products): dense route "
          f"{dense_ms:.3f} ms end to end ({dense_dev:.4f} by CUDA events from the staged "
          f"inputs), sparse route {sparse_ms:.3f} ms ({sparse_dev:.4f} from the staged plan); "
          f"selector weights measured on this card: "
          + json.dumps({"DENSE_NS_PER_NPAD3": dense_ms * 1e6 / n_pad ** 3,
                        "SPARSE_NS_PER_PRODUCT": sparse_ms * 1e6 / products})
          + "; in use: " + json.dumps({"DENSE_NS_PER_NPAD3": graph.DENSE_NS_PER_NPAD3,
                                       "SPARSE_NS_PER_PRODUCT": graph.SPARSE_NS_PER_PRODUCT}))
    del prep, rows_d, cols_d
    _phase("timing: triangle routes", t1)
    t1 = time.perf_counter()
    for model_name, (model, x, _) in served.items():
        model(x)
        torch.cuda.synchronize()
        req = []
        for _ in range(10):
            ta = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            req.append((time.perf_counter() - ta) * 1e3)
        x_dev = torch.from_numpy(x).to(dev)
        fwd_ms = _median_ms(torch, lambda: model(x_dev))
        print(f"{model_name} b{x.shape[0]} per request (host batch in, host clock, median of 10) "
              f"{statistics.median(req):.4f} ms; forward on the card's batch (CUDA events) {fwd_ms:.4f} ms")
        if model_name == "LeNet":
            x4 = x_dev.reshape(-1, 28, 28, 1)
            pool1 = torch.rand((x4.shape[0], 14, 14, 6), device=dev)

            def unfold_rows(h, k, pad):  # the same rows by F.unfold
                cols = torch.nn.functional.unfold(h.permute(0, 3, 1, 2), k, padding=pad)
                return cols.transpose(1, 2).reshape(-1, cols.shape[1])

            for h, pad in ((x4, 2), (pool1, 0)):
                if not torch.equal(im2col(h, 5, pad), unfold_rows(h, 5, pad)):
                    raise RuntimeError("im2col disagrees with F.unfold")
            i2c_ms = _median_ms(torch, lambda: (im2col(x4, 5, 2), im2col(pool1, 5, 0)))
            unfold_ms = _median_ms(torch, lambda: (unfold_rows(x4, 5, 2), unfold_rows(pool1, 5, 0)))
            print(f"LeNet b{x.shape[0]} im2col (both convs) {i2c_ms:.4f} ms, "
                  f"{100 * i2c_ms / fwd_ms:.1f}% of the forward (the same rows by F.unfold "
                  f"{unfold_ms:.4f} ms)")
    _phase("timing: sparse-NN end to end", t1)
    pipe_dev = {name: _profile_line(torch, f"rmat14_ef8 {name} device pipeline",
                                    lambda: run_fn(pl))
                for name, pl, run_fn in pipelines}
    fwd_dev = {}
    for model_name, (model, x, _) in served.items():
        x_dev = torch.from_numpy(x).to(dev)
        fwd_dev[model_name] = _profile_line(
            torch, f"{model_name} b{x.shape[0]} sparse forward", lambda: model(x_dev))
    # one trace for the four kernels (each profiler session adds time),
    # each run once at the main path's shapes; the split is by name
    kernel_runs = (run_k1(gexpand.expand_gather), run_k2(scan.merge_epilogue_scan),
                   run_k3g(expand.expand_part_packed), run_k4g(expand.expand_part_coords),
                   lambda: [spmm.spmm_blockell_device(*c) for c in all_k5])
    alone = _profile_line(torch, "K1, K2, K3, K4 alone, one run each; K5 one layer set",
                          lambda: [fn() for fn in kernel_runs])
    for model_name, by in fwd_dev.items():
        if "K5" in by:
            print(f"K5 device {by['K5']:.4f} ms per {model_name} forward (profiler; the "
                  f"row-tile design it replaced: {K5_BEFORE_MS[model_name]} ms on an NVIDIA "
                  f"H100 80GB HBM3 at 700 W)")

    def share(bound, ms):
        return f"{100 * bound / ms:.1f}%" if ms else "not measured"

    k1_prof = {"gather": alone.get("K1"), "tiles": pipe_dev["tiles"].get("K1")}
    for path, ev_ms, bound, prof_src in (
            ("gather", k1_ms, k1_bound, "K1 alone"),
            ("tiles", k1_tiles_ms, k1_tiles_bound, "the tiles pipeline's trace")):
        prof = k1_prof[path]
        prof_txt = f"{prof:.4f} ms profiler ({prof_src})" if prof else "profiler not measured"
        print(f"K1 device per rmat14_ef8 run, {path}{' residue' if path == 'tiles' else ''}: "
              f"{ev_ms:.4f} ms device-only events, {prof_txt}; {share(bound, ev_ms)} (events) / "
              f"{share(bound, prof)} (profiler) of its {bound:.4f} ms bound (before redesign: "
              f"{K1_BEFORE_MS[path]} on an NVIDIA H100 80GB HBM3 at 700 W)")
    if "K2" in alone:
        k2_dev = alone["K2"] + alone.get("K2 carry", 0.0)
        print(f"K2 device {k2_dev:.4f} ms per rmat14_ef8 run (profiler; tile pass "
              f"{alone['K2']:.4f}, carry pass {alone.get('K2 carry', 0.0):.4f}): "
              f"{100 * k2_bound / k2_dev:.1f}% of its {k2_bound:.4f} ms bound (the per-slot "
              f"design it replaced: {K2_BEFORE_MS} ms on the same card model)")
    for name, step in nn_train["steps"].items():
        _profile_line(torch, f"nn training {name} b{NN_BATCH}, 10 train_steps",
                      lambda step=step: [step() for _ in range(10)])
    if not _profile_line(torch, "mcl_rmat14_4iter warm mcl_run", mcl_launches["run"], top=10):
        _profile_line(torch, "mcl_rmat14_4iter warm mcl_run, again", mcl_launches["run"], top=10)
    _phase("timing", t0)
    _phase("total (torch import to here)", t_start)

    def row(name, route, source, replaces, key, err, ms, plain_ms, bound, by, library_ms):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms}

    # the MCL path's warm run launches them too
    for k in ("K1", "K2", "prune_compact", "loop_expand"):
        launches[k] += mcl_launches[k]
    for k, c in wide["launches"].items():  # and the wide path's warm run
        launches[k] += c
    k1_err, k3_err = max(k1_err, mcl_launches["K1 err"]), max(k3_err, mcl_launches["K3 err"])
    k1_err, k3_err = max(k1_err, sharded["K1 err"]), max(k3_err, sharded["K3 err"])
    k2_err, k5_err = max(k2_err, sharded["K2 err"]), max(k5_err, sharded["K5 err"])
    k4_err = max(k4_err, mcl_launches["K4 err"])
    record = {"kernels": [
        row("K1 gexpand (windowed-gather expand)", "cuda",
            "outerspace_tpu_torch/csrc/gexpand.cu", "outerspace_tpu/ops/pallas/gexpand.py:60",
            "K1", k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by, None),
        row("K2 scan (merge epilogue)", "cuda",
            "outerspace_tpu_torch/csrc/scan.cu", "outerspace_tpu/ops/pallas/scan.py:57",
            "K2", k2_err, k2_ms, k2_plain_ms, k2_bound, k2_by, sort_ms),
        row("K3 expand_part_packed (dense-tile expand, packed keys; one launch per row part)",
            "cuda",
            "outerspace_tpu_torch/csrc/expand.cu", "outerspace_tpu/ops/pallas/expand.py:45",
            "K3", k3_err, k3_ms, k3_plain_ms, k3_bound, k3_by, None),
        row("K4 expand_part_coords (dense-tile expand, coordinates; one launch per row part)",
            "cuda",
            "outerspace_tpu_torch/csrc/expand.cu", "outerspace_tpu/ops/pallas/expand.py:87",
            "K4", k4_err, k4_ms, k4_plain_ms, k4_bound, k4_by, None),
        row("K5 spmm_blockell_device (block-ELL SpMM)", "cuda",
            "outerspace_tpu_torch/csrc/spmm.cu", "outerspace_tpu/ops/pallas/spmm_kernel.py:30",
            "K5", k5_err, k5_ms, k5_plain_ms, k5_bound, k5_by, k5_lib_ms),
        row("prune_compact (the MCL first squaring's prune and compaction)", "cuda",
            "outerspace_tpu_torch/csrc/prune_compact.cu", None,
            "prune_compact", pc["err"], pc["ms"], pc["plain_ms"], pc["bound"], pc["by"], None),
        *(row(name, "cuda", source, None, key, w["err"], w["ms"], w["plain_ms"], w["bound"],
              w["by"], None)
          for name, source, key, w in (
              ("loop_expand (the MCL loop squaring's expand into biased 32-bit keys)",
               "outerspace_tpu_torch/csrc/loop_expand.cu", "loop_expand",
               mcl_launches["loop_expand row"]),
              ("K2_64 scan (merge epilogue over 64-bit keys; the MCL loop past n² = 2³²)",
               "outerspace_tpu_torch/csrc/scan.cu", "K2_64", wide["K2_64"]),
              ("prune_compact_64 (the MCL first squaring's prune and compaction into 64-bit "
               "keys)", "outerspace_tpu_torch/csrc/prune_compact.cu", "prune_compact_64",
               wide["prune_compact_64"]),
              ("loop_expand_64 (the MCL loop squaring's expand into 64-bit keys)",
               "outerspace_tpu_torch/csrc/loop_expand.cu", "loop_expand_64",
               wide["loop_expand_64"]))),
    ]}
    print(json.dumps(record))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
