"""Measure on the card the event model's machine fields that the spec
sheet does not give (``perf/perfsim.py``'s table names each field's
source; ``csrc/perfsim.cpp``'s ``SimConfig`` holds the values).

- the SM clock: ``nvidia-smi``'s ``clocks.max.sm`` (the cycle of the
  model), beside the clock the card ran at;
- ``hbm_latency``: one dependent load that hits L2 (``csrc/simcal.cu``'s
  chase over a 2 MiB chain, warmed), in cycles: the path to the memory
  side before any DRAM row is touched;
- ``hbm_row_hit`` / ``hbm_row_miss``: one dependent load past L2 (a 1 GiB
  chain, L2 flushed first), at consecutive 128-byte lines (DRAM rows
  left open) or at random lines, less ``hbm_latency``;
- ``dma_max_outstanding``: Little's law on the random case, the card's
  random 16-byte gather rate (``torch.index_select`` of random rows of a
  1 GiB table, CUDA events) times the random load's latency: the loads
  the card keeps in flight;
- ``grid_overhead``: what one more block of an empty grid costs the card
  (a launch of 2²⁰ blocks against one of a single block), in cycles.

Run on the card::

    python -m outerspace_tpu_torch.perf.simcal

It prints one JSON object: the raw measurements and the fields derived
from them. There is no CPU mode: without a card it raises.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr

CHASE = CudaKernel(
    "simcal", "simcal_chase",
    [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)
NOOP = CudaKernel("simcal", "simcal_noop", [ctypes.c_int] * 3 + [ctypes.c_void_p])

LINE_WORDS = 32  # one chain entry per 128-byte line
L2_CHAIN_LINES = 1 << 14  # 2 MiB: resident in the 50 MB L2
DRAM_CHAIN_LINES = 1 << 23  # 1 GiB
FLUSH_BYTES = 1 << 27  # written between chases: 128 MiB, past L2
CHASE_STEPS = 4096
GATHER_ROWS = 1 << 24  # random 16-byte rows gathered
BIG_GRID = 1 << 20


def sm_clocks_mhz() -> tuple[float, float]:
    """(max, current) SM clock in MHz, by ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0]
    mx, cur = (float(x) for x in out.split(","))
    return mx, cur


def _chase_cycles(torch, nxt, start: int, steps: int, dev) -> float:
    """Cycles per load of ``steps`` dependent loads from ``start``."""
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    CHASE.launch(tensor_ptr(nxt), start, steps, LINE_WORDS, tensor_ptr(cycles), tensor_ptr(sink),
                 *device_args(dev))
    return int(cycles.item()) / steps


def _chain(torch, lines: int, dev, random: bool):
    """A cyclic chain over ``lines`` 128-byte lines: at random, or each
    line to the next."""
    nxt = torch.zeros(lines * LINE_WORDS, dtype=torch.int32, device=dev)
    order = torch.randperm(lines, device=dev, dtype=torch.int64) if random else \
        torch.arange(lines, device=dev, dtype=torch.int64)
    nxt.view(lines, LINE_WORDS)[order, 0] = order.roll(-1).to(torch.int32)
    return nxt, int(order[0].item())


def _event_ms(torch, fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(device: str = "cuda") -> dict:
    """The raw measurements and the machine fields derived from them."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the event model's machine is measured on the card only")
    torch.manual_seed(0)
    max_mhz, cur_mhz = sm_clocks_mhz()
    clock = max_mhz * 1e6
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    nxt, start = _chain(torch, L2_CHAIN_LINES, dev, random=True)
    _chase_cycles(torch, nxt, start, L2_CHAIN_LINES, dev)  # warm L2
    l2 = _chase_cycles(torch, nxt, start, CHASE_STEPS, dev)
    del nxt
    lat = {}
    for kind in ("sequential", "random"):
        nxt, start = _chain(torch, DRAM_CHAIN_LINES, dev, random=kind == "random")
        flush.fill_(1)
        torch.cuda.synchronize(dev)
        lat[kind] = _chase_cycles(torch, nxt, start, CHASE_STEPS, dev)
        del nxt

    table = torch.rand(DRAM_CHAIN_LINES * LINE_WORDS // 4, 4, device=dev)  # 1 GiB of 16-byte rows
    idx = torch.randint(0, table.shape[0], (GATHER_ROWS,), device=dev)
    gather_ms = _event_ms(torch, lambda: torch.index_select(table, 0, idx), reps=10)
    del table, idx, flush
    gather_per_s = GATHER_ROWS / (gather_ms * 1e-3)

    args = device_args(dev)
    one_ms = _event_ms(torch, lambda: NOOP.launch(1, 32, *args), reps=200)
    big_ms = _event_ms(torch, lambda: NOOP.launch(BIG_GRID, 32, *args), reps=20)
    block_cyc = (big_ms - one_ms) * 1e-3 / (BIG_GRID - 1) * clock

    raw = {
        "sm_clock_max_mhz": max_mhz, "sm_clock_mhz": cur_mhz,
        "l2_hit_cycles": l2, "dram_sequential_cycles": lat["sequential"],
        "dram_random_cycles": lat["random"],
        "random_16b_gather_per_s": gather_per_s, "random_16b_gather_ms": gather_ms,
        "empty_launch_ms": one_ms, "empty_grid_2p20_ms": big_ms, "cycles_per_block": block_cyc,
    }
    fields = {
        "clock_hz": clock,
        "hbm_latency": round(l2),
        "hbm_row_hit": round(lat["sequential"] - l2),
        "hbm_row_miss": round(lat["random"] - l2),
        "dma_max_outstanding": round(gather_per_s / clock * lat["random"]),
        "grid_overhead": round(block_cyc),
    }
    return {"device": torch.cuda.get_device_name(dev), "raw": raw, "fields": fields}


if __name__ == "__main__":
    print(json.dumps(measure()))
