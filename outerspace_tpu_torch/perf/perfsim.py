"""ctypes wrapper of the event model: a discrete-event performance model
of the card running the port's kernels (``csrc/perfsim.cpp``, built with
the host's ``g++`` into ``build/`` at first use; a failed build raises
with the compiler's output).

The port of the JAX package's ``perf/perfsim.py``: the same entry points
and return dicts, its machinery line for line, on the card's machine. A
cycle is one SM clock cycle. The built-in machine (``SimConfig``'s
defaults, snapshotted into :data:`CARD_CONFIG` at load), one NVIDIA H100
SXM at its 700 W limit:

=====================  ============  ==============================================
field                  value         source
=====================  ============  ==============================================
clock_hz               1.98e9        the card's max SM clock, ``nvidia-smi
                                     clocks.max.sm`` (``perf/simcal.py``, PERF.md §6)
hbm_bytes_per_cycle    1691.9...     ``GPUConfig.hbm_bw_bytes`` (3.35e12 B/s, spec
                                     sheet) ÷ clock_hz
hbm_channels           80            spec sheet: a 5,120-bit HBM3 interface, 5
                                     stacks of 16 64-bit channels
hbm_latency            299           one dependent load that hits L2, cycles
                                     (``perf/simcal.py``, PERF.md §6)
dma_max_outstanding    594           Little's law: the card's random 16-byte
                                     gather rate × the random load's latency
                                     (``perf/simcal.py``, PERF.md §6)
vpu_lanes              33838.3...    ``GPUConfig.fp32_ops`` (67e12, spec sheet) ÷
                                     clock_hz
mxu_ops_per_cycle      499494.9...   ``GPUConfig.tensor_ops`` (989e12 bf16 dense,
                                     spec sheet) ÷ clock_hz
grid_overhead          1             one more block of an empty grid, cycles
                                     (``perf/simcal.py``, PERF.md §6)
sort_pairs_per_cycle   2704.9...     xla_bitonic only: the pair-stage rate at which
                                     the bitonic formula gives ``SORT_NS`` (the
                                     card's torch.sort + K2 per slot,
                                     ``sched/autotune.py``) on rmat14_ef8's gather
                                     parts (3.4 M slots, 22² stages)
hbm_row_bytes          1024          HBM3's page per pseudo-channel (JESD238), not
                                     measured
hbm_banks              32            HBM3: 2 pseudo-channels of 16 banks per
                                     channel (JESD238), not measured
hbm_row_hit            398           one dependent load past L2 at consecutive
                                     lines, less hbm_latency (``perf/simcal.py``)
hbm_row_miss           408           the same at random lines, less hbm_latency
sort_impl              cub_radix     the port's ``torch.sort`` (``roofline
                                     .sort_bytes``); xla_bitonic keeps the JAX
                                     package's network formula
topology               switch        NVSwitch, one hop on the source's egress
                                     link; ring keeps the ring
link_bw_bytes          4.5e11        ``GPUConfig.nvlink_bw_bytes`` (spec sheet)
gather_cyc             0.40494       ``sched/autotune.py FLAT_NS`` (the card's flat
                                     expand per slot, ns) × clock_hz: the sharded
                                     MCL tail's per-element gather
=====================  ============  ==============================================

``set_config`` overrides any field (``get_config`` reads them back);
``set_config(**CARD_CONFIG)`` restores the built-in machine. The tests
reach the JAX package's machine only by passing its constants in
(``topology="ring"``, ``sort_impl="xla_bitonic"``, its clock, link rate
and gather cost), and then every entry point gives the JAX package's
integers. One divergence by design: a rebased sharded plan charges each
bucket's sort at that bucket's stream length, as
``roofline.predict_sharded_tiled`` does.

Readers: the command line's ``predict`` and the event-model lines of
``spgemm`` and ``spgemm --mesh``, each beside the roofline; a model
failure raises there.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from outerspace_tpu_torch.perf.roofline import SORT_IMPLS

TOPOLOGIES = ("switch", "ring")
_CFG_KEYS = (
    "hbm_bytes_per_cycle",
    "hbm_channels",
    "hbm_latency",
    "dma_max_outstanding",
    "vpu_lanes",
    "mxu_ops_per_cycle",
    "grid_overhead",
    "sort_pairs_per_cycle",
    "hbm_row_bytes",
    "hbm_banks",
    "hbm_row_hit",
    "hbm_row_miss",
    "sort_impl",
    "topology",
    "clock_hz",
    "link_bw_bytes",
    "gather_cyc",
)
_NAMED = {"sort_impl": SORT_IMPLS, "topology": TOPOLOGIES}  # fields passed as a code
# The speed-of-light machine: the built-in rates are the spec sheet's
# already; this drops the measured per-block overhead.
SPEC_CONFIG = dict(grid_overhead=0)
CARD_CONFIG: dict = {}  # the built-in machine, snapshotted at load
# What K3 keeps on chip (csrc/expand.cu): a unit holds one 128-lane B
# block of int32 columns and float32 values (1 KiB) in registers, a block
# of 8 warps holds kUnroll = 2 units, and at 58 registers a thread
# (ptxas, PERF.md §6) an SM holds 4 blocks: 132 SMs × 4 × 2 B blocks.
K3_LINE_BLOCKS = 1
K3_LINE_BYTES = 128 * (4 + 4)
K3_BLOCKS_ON_CHIP = 132 * 4 * 2

_LIB = None
_P64 = ctypes.POINTER(ctypes.c_int64)


class _Serialised:
    """The library's functions behind one lock: it keeps the simulated
    machine's modules, its config and the stats dump in process globals,
    so calls from several threads (the command line's sharded runs side
    by side) take turns."""

    _lock = threading.Lock()

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            with self._lock:
                return fn(*args)

        return call


def load():
    """The loaded library, built at first use; raises if the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from outerspace_tpu_torch.runtime.build import host_library

    lib = host_library("perfsim")
    sigs = {
        "osp_sim_kernel": (ctypes.c_int64, [ctypes.c_int64, _P64, _P64, _P64, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_kernel_uniform": (ctypes.c_int64, [ctypes.c_int64] * 4 + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_kernel_cached": (ctypes.c_int64, [ctypes.c_int64, _P64, _P64, _P64, _P64,
                                                   ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                                   ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_merge": (ctypes.c_int64, [ctypes.c_int64, _P64, _P64,
                                           ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_sharded": (ctypes.c_int64, [ctypes.c_int, _P64, _P64, ctypes.c_int, _P64,
                                             ctypes.c_int, _P64, _P64, ctypes.c_double,
                                             ctypes.c_int, ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_sort_cycles": (ctypes.c_int64, [ctypes.c_int64]),
        "osp_sim_fifo_selftest": (ctypes.c_int, []),
        "osp_sim_arbiter_selftest": (ctypes.c_int, []),
        "osp_sim_ici_selftest": (ctypes.c_int, []),
        "osp_sim_rowbuffer_selftest": (ctypes.c_int, []),
        "osp_sim_set_stats_dump": (None, [ctypes.c_char_p, ctypes.c_int64]),
        "osp_sim_set_config": (None, [ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_get_config": (None, [ctypes.POINTER(ctypes.c_double)]),
        "osp_sim_config_fields": (ctypes.c_int, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    if lib.osp_sim_config_fields() != len(_CFG_KEYS):
        raise RuntimeError(f"csrc/perfsim.cpp has {lib.osp_sim_config_fields()} config fields, "
                           f"the wrapper {len(_CFG_KEYS)}")
    _LIB = _Serialised(lib)
    CARD_CONFIG.update(get_config())
    return _LIB


def available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return load() is not None


def get_config() -> dict:
    """The current machine, every field (``sort_impl`` and ``topology`` by name)."""
    vals = (ctypes.c_double * len(_CFG_KEYS))()
    load().osp_sim_get_config(vals)
    out = {k: float(vals[i]) for i, k in enumerate(_CFG_KEYS)}
    for k, names in _NAMED.items():
        out[k] = names[int(out[k])]
    return out


def set_config(**kw) -> None:
    """Override machine fields at runtime (unset keys keep their current
    values); ``sort_impl`` and ``topology`` take their names."""
    unknown = set(kw) - set(_CFG_KEYS)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    vals = (ctypes.c_double * len(_CFG_KEYS))(*[-1.0] * len(_CFG_KEYS))
    for i, k in enumerate(_CFG_KEYS):
        if k not in kw:
            continue
        v = kw[k]
        if k in _NAMED:
            if v not in _NAMED[k]:
                raise ValueError(f"{k} {v!r}: expected one of {_NAMED[k]}")
            v = _NAMED[k].index(v)
        vals[i] = float(v)
    load().osp_sim_set_config(vals)


def _clock(clock_hz):
    return get_config()["clock_hz"] if clock_hz is None else clock_hz


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P64)


def simulate_kernel(in_bytes, out_bytes, flops, use_mxu: bool = False) -> tuple[int, float]:
    """Simulate a kernel with per-task byte/flop profiles.

    Returns (cycles, compute_utilization)."""
    ib, ob, fl = _i64(in_bytes), _i64(out_bytes), _i64(flops)
    util = ctypes.c_double(0.0)
    cycles = load().osp_sim_kernel(ib.shape[0], _ptr(ib), _ptr(ob), _ptr(fl),
                                   1 if use_mxu else 0, ctypes.byref(util))
    return int(cycles), float(util.value)


def simulate_expand_schedule(sched, clock_hz: float | None = None) -> dict:
    """Predict the dense-tile expand's runtime from its task table: each
    task reads its A slice plus one 128-lane B block and writes its
    (key, value) stream at 8 B per slot."""
    from outerspace_tpu_torch.sched.planner import TILE_B

    n = sched.ntasks
    if n == 0:
        return dict(cycles=0, seconds=0.0, util=0.0)
    tile_a = getattr(sched, "tile_a", 8)
    in_bytes = np.full(n, (tile_a * 8) + TILE_B * 8, dtype=np.int64)
    out_bytes = np.full(n, tile_a * TILE_B * 8, dtype=np.int64)
    flops = np.full(n, tile_a * TILE_B, dtype=np.int64)
    cycles, util = simulate_kernel(in_bytes, out_bytes, flops)
    return dict(cycles=cycles, seconds=cycles / _clock(clock_hz), util=util)


def simulate_kernel_cached(in_bytes, out_bytes, flops, b_blocks,
                           cache_slots: int = K3_BLOCKS_ON_CHIP,
                           line_bytes: int = K3_LINE_BYTES,
                           use_mxu: bool = False) -> dict:
    """Simulate a kernel whose per-task B line goes through a timed
    blocking-miss LRU on-chip cache of ``cache_slots`` lines (the
    reference's timed ``Cache``, ``SimOuterSPACE.cpp:278-359``).
    ``in_bytes`` is the A-side traffic only: the B side is charged by the
    cache on each miss. Defaults: what K3 keeps on chip.

    Returns dict(cycles, util, hits, misses, hbm_grants, hbm_stalls,
    hbm_contended); the grants and stalls are per requester port
    (in_dma, out_dma, the cache)."""
    ib, ob, fl, bb = _i64(in_bytes), _i64(out_bytes), _i64(flops), _i64(b_blocks)
    stats = (ctypes.c_double * 10)(*([0.0] * 10))
    cycles = load().osp_sim_kernel_cached(ib.shape[0], _ptr(ib), _ptr(ob), _ptr(fl), _ptr(bb),
                                          int(cache_slots), int(line_bytes),
                                          1 if use_mxu else 0, stats)
    return dict(
        cycles=int(cycles),
        util=float(stats[0]),
        hits=int(stats[1]),
        misses=int(stats[2]),
        hbm_grants=(int(stats[3]), int(stats[4]), int(stats[5])),
        hbm_stalls=(int(stats[6]), int(stats[7]), int(stats[8])),
        hbm_contended=int(stats[9]),
    )


def simulate_expand_cached(sched, cache_slots: int = K3_BLOCKS_ON_CHIP,
                           clock_hz: float | None = None,
                           line_blocks: int = K3_LINE_BLOCKS) -> dict:
    """Cached-pipeline prediction over a real task table: the per-task
    ``b_block`` stream (B-major order) drives the block cache, so the
    prediction reflects the on-chip residency that ordering gets (the
    event-model counterpart of ``sched/policies.py``'s residency study).
    A line is ``line_blocks`` consecutive 128-lane B blocks; the defaults
    are K3's (one block a line); the JAX package's machine keeps 8 in a
    line and 16 lines."""
    from outerspace_tpu_torch.sched.planner import TILE_B

    n = sched.ntasks
    if n == 0:
        return dict(cycles=0, seconds=0.0, util=0.0, hits=0, misses=0)
    tile_a = getattr(sched, "tile_a", 8)
    in_bytes = np.full(n, tile_a * 8, dtype=np.int64)
    out_bytes = np.full(n, tile_a * TILE_B * 8, dtype=np.int64)
    flops = np.full(n, tile_a * TILE_B, dtype=np.int64)
    b_blocks = np.asarray(sched.b_block, dtype=np.int64) // line_blocks
    out = simulate_kernel_cached(in_bytes, out_bytes, flops, b_blocks, cache_slots=cache_slots,
                                 line_bytes=line_blocks * TILE_B * 8)
    out["seconds"] = out["cycles"] / _clock(clock_hz)
    return out


def simulate_merge_parts(pair_counts, out_bytes=None, clock_hz: float | None = None) -> dict:
    """Cycle-stepped merge-phase prediction: one row part per task, each
    a padded (key, value) pair stream pulled from HBM, sorted by the sort
    unit (``sort_impl``), swept by the epilogue and written back; no
    block cache in the wiring (the reference's merge machine dropped its
    caches between phases, ``SimOuterSPACE.cpp:800-857``).

    ``pair_counts``: each part's padded stream length; ``out_bytes``
    defaults to the whole stream (8 B a pair). Returns dict(cycles,
    seconds, sort_util, sort_busy_cycles, total_stages)."""
    pc = _i64(pair_counts)
    ob = pc * 8 if out_bytes is None else _i64(out_bytes)
    if ob.shape != pc.shape:
        raise ValueError("out_bytes must match pair_counts in shape")
    stats = (ctypes.c_double * 3)(0.0, 0.0, 0.0)
    cycles = load().osp_sim_merge(pc.shape[0], _ptr(pc), _ptr(ob), stats)
    return dict(
        cycles=int(cycles),
        seconds=int(cycles) / _clock(clock_hz),
        sort_util=float(stats[0]),
        sort_busy_cycles=int(stats[1]),
        total_stages=int(stats[2]),
    )


def _link(link_bw_bytes):
    return get_config()["link_bw_bytes"] if link_bw_bytes is None else link_bw_bytes


def simulate_sharded_pipeline(ndev: int, expand_cycles, sort_pairs, xfer_bytes, merge_pairs,
                              merge_out_bytes=None, merge_sort_skip: bool = False,
                              link_bw_bytes: float | None = None,
                              clock_hz: float | None = None) -> dict:
    """Event-model the SPMD sharded SpGEMM program (raw-arrays entry):
    per device the expand and the local owner sort, then per chunk the
    exchange over the interconnect (``topology``) behind a barrier and
    ``merge_parts`` key-range merges, whose IO shares the device's HBM
    with the links.

    ``expand_cycles`` / ``sort_pairs``: int64[ndev]; ``xfer_bytes``:
    int64[nchunks, ndev, ndev]; ``merge_pairs`` / ``merge_out_bytes``:
    int64[ndev, nchunks, merge_parts]. The cycle-level counterpart of
    ``roofline.predict_sharded_tiled``."""
    clock = _clock(clock_hz)
    ec, sp, xb, mp = _i64(expand_cycles), _i64(sort_pairs), _i64(xfer_bytes), _i64(merge_pairs)
    mo = mp * 8 if merge_out_bytes is None else _i64(merge_out_bytes)
    if ec.shape != (ndev,):
        raise ValueError("expand_cycles must be int64[ndev]")
    if sp.shape != (ndev,):
        raise ValueError("sort_pairs must be int64[ndev]")
    if xb.ndim != 3 or xb.shape[1:] != (ndev, ndev):
        raise ValueError("xfer_bytes must be [nchunks, ndev, ndev]")
    nchunks = xb.shape[0]
    if mp.ndim != 3 or mp.shape[:2] != (ndev, nchunks):
        raise ValueError("merge_pairs must be [ndev, nchunks, parts]")
    if mo.shape != mp.shape:
        raise ValueError("merge_out_bytes must match merge_pairs in shape")
    stats = (ctypes.c_double * 4)(*([0.0] * 4))
    cycles = load().osp_sim_sharded(
        int(ndev), _ptr(ec), _ptr(sp), int(nchunks), _ptr(xb), int(mp.shape[2]), _ptr(mp),
        _ptr(mo), float(_link(link_bw_bytes) / clock), 1 if merge_sort_skip else 0, stats)
    return dict(
        cycles=int(cycles),
        seconds=int(cycles) / clock,
        expand_sort_cycles=int(stats[0]),
        exchange_done_cycles=int(stats[1]),
        max_link_busy=int(stats[2]),
        ici_hop_bytes=int(stats[3]),  # bytes × hops over the links (the JAX key)
    )


def simulate_sharded_tiled(plan, link_bw_bytes: float | None = None,
                           clock_hz: float | None = None) -> dict:
    """Event-model a ``shard.tiled.ShardedTiledPlan``: per-device expand
    cycles from the common class task tables and gather groups, the local
    owner sort of the padded stream (a rebased plan: each bucket's expand
    and its sort at that bucket's stream length), the per-(chunk, src,
    dst) capacity buckets over the interconnect, and ``merge_parts``
    key-range merges per chunk (sort-skipped on kx = 1, as the program
    does). ``ny`` columns run independent identical x axes, so one axis
    is the model."""
    from outerspace_tpu_torch.sched.gplanner import GROUP_SUBS, SUB_P, SUPER_A, SUPER_B
    from outerspace_tpu_torch.sched.planner import TILE_B
    from outerspace_tpu_torch.shard.tiled import _bucket_stream_len

    ndev = plan.kx

    def _expand_cycles(class_T, tile_as, ngroups):
        cyc = 0
        for T, ta in zip(class_T, tile_as):
            if T:
                ib = np.full(T, ta * 8 + TILE_B * 8, dtype=np.int64)
                ob = np.full(T, ta * TILE_B * 8, dtype=np.int64)
                fl = np.full(T, ta * TILE_B, dtype=np.int64)
                cyc += simulate_kernel(ib, ob, fl)[0]
        if ngroups:
            g = int(ngroups)
            in_b = (SUPER_A * 8 * 4 * 128 + SUPER_B * 8 * 2 * 128 + 8 * 128) * 4
            ib = np.full(g, in_b, dtype=np.int64)
            ob = np.full(g, GROUP_SUBS * SUB_P * 8, dtype=np.int64)
            fl = np.full(g, GROUP_SUBS * SUB_P, dtype=np.int64)
            cyc += simulate_kernel(ib, ob, fl)[0]
        return cyc

    if plan.rebase:
        exp_cycles = 0
        for bk in plan.buckets:
            exp_cycles += _expand_cycles(bk["class_T"], bk["tile_as"], bk["ngroups"])
            exp_cycles += sort_cycles(_bucket_stream_len(bk))
        expand = np.full(ndev, exp_cycles, dtype=np.int64)
        sort_pairs = np.zeros(ndev, dtype=np.int64)
    else:
        exp_cycles = _expand_cycles(plan.class_T, plan.tile_as, plan.ngroups)
        expand = np.full(ndev, exp_cycles, dtype=np.int64)
        sort_pairs = np.full(ndev, plan.stream_len, dtype=np.int64)
    xfer = np.full((plan.chunks, ndev, ndev), int(plan.capacity) * 8, dtype=np.int64)
    mp = np.full((ndev, plan.chunks, plan.merge_parts), int(plan.kx) * int(plan.mcap),
                 dtype=np.int64)
    out = simulate_sharded_pipeline(ndev, expand, sort_pairs, xfer, mp,
                                    merge_sort_skip=(plan.kx == 1),
                                    link_bw_bytes=link_bw_bytes, clock_hz=clock_hz)
    out["expand_cycles_per_dev"] = int(exp_cycles)
    return out


def simulate_mcl_sharded_iteration(plan, link_bw_bytes: float | None = None,
                                   clock_hz: float | None = None) -> dict:
    """Event-model one iteration of the device-resident sharded MCL loop
    (``shard/mcl.py``): the expand → sort → exchange → merge phase runs
    through the sharded machine, the inflate / column-normalise and CSC
    re-shard tail is charged closed-form (two sorts, the second
    exchange's bytes over the links, and ``gather_cyc`` cycles a slot for
    the flat expand and the column-sum gather). The roofline counterpart
    is ``roofline.predict_mcl_sharded_iteration``."""
    cfg = get_config()
    clock = cfg["clock_hz"] if clock_hz is None else clock_hz
    link = cfg["link_bw_bytes"] if link_bw_bytes is None else link_bw_bytes
    gather_cyc = cfg["gather_cyc"]
    ndev = plan.kx
    exp = np.full(ndev, int(int(plan.p_pad) * gather_cyc), dtype=np.int64)
    sort_pairs = np.full(ndev, int(plan.p_pad), dtype=np.int64)
    xfer = np.full((1, ndev, ndev), int(plan.cap) * 8, dtype=np.int64)
    merged = ndev * int(plan.cap)
    mp = np.full((ndev, 1, 1), merged, dtype=np.int64)
    out = simulate_sharded_pipeline(ndev, exp, sort_pairs, xfer, mp, merge_sort_skip=False,
                                    link_bw_bytes=link, clock_hz=clock)
    link_per_cycle = link / clock
    if cfg["topology"] == "ring":
        hops = sum(min(h, ndev - h) for h in range(1, ndev)) if ndev > 1 else 0
        reshard = int(int(plan.ecap) * 8 * hops / 2.0 / link_per_cycle)
    else:  # one hop, kx − 1 buckets out of each device's link
        reshard = int(int(plan.ecap) * 8 * (ndev - 1) / link_per_cycle)
    tail = (
        int(merged * gather_cyc)  # column-sum gather
        + sort_cycles(merged)  # column-major re-sort
        + sort_cycles(int(plan.na))  # A-side CSC sort
        + reshard
        + (int(plan.m * 4 * 2 * (ndev - 1) / ndev / link_per_cycle) if ndev > 1 else 0)
    )
    cycles = int(out["cycles"]) + tail
    return dict(cycles=cycles, seconds=cycles / clock, pipeline_cycles=int(out["cycles"]),
                tail_cycles=int(tail))


def sort_cycles(pairs: int) -> int:
    """The sharded machine's sort charge for one stream of ``pairs`` under
    the current config (cub_radix: the radix passes and the gather at the
    HBM rate; xla_bitonic: the network's stages and 2 HBM passes; each
    plus the grid overhead)."""
    return int(load().osp_sim_sort_cycles(int(pairs)))


def fifo_selftest() -> int:
    """0 = the FIFO framework's double-access detection fires."""
    return int(load().osp_sim_fifo_selftest())


def arbiter_selftest() -> int:
    """0 = the HBM crossbar's round-robin grants split two saturating
    ports near-evenly and progress both."""
    return int(load().osp_sim_arbiter_selftest())


def ici_selftest() -> int:
    """0 = the ring's hop timing, an all-to-all on it, and the sharded
    pipeline's phase order hold."""
    return int(load().osp_sim_ici_selftest())


def rowbuffer_selftest() -> int:
    """0 = the gather-vs-stream asymmetry emerges from the row-buffer
    mechanism under the current machine."""
    return int(load().osp_sim_rowbuffer_selftest())


def selftests() -> dict[str, int]:
    """The four selftests' codes under the current machine (0 = pass)."""
    return {"fifo": fifo_selftest(), "arbiter": arbiter_selftest(), "ici": ici_selftest(),
            "rowbuffer": rowbuffer_selftest()}


def set_stats_dump(path: str | None, interval: int) -> bool:
    """Enable periodic per-module stats dumps (every ``interval``
    simulated cycles, appended to ``path``; None: the standard error;
    interval <= 0 disables), as the reference printed every module every
    100k cycles (``SimOuterSPACE.cpp:775-780``). Returns True."""
    load().osp_sim_set_stats_dump(path.encode() if path else None, int(interval))
    return True
