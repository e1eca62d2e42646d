"""Micro-benchmarks of the primitives the port's pipelines are built
from, each timed at a product-stream size ``p``, an element (table) size
``e`` and a column count ``m``:

- ``sort2_p``: ``torch.sort`` of ``p`` int32 keys and the float32 values
  gathered by its order (the merge's sort);
- ``merge_epilogue_sorted_p``: K2 (``ops.spgemm.merge_epilogue``) over an
  already sorted stream of ``p`` biased keys;
- ``sort1_u64_p``: ``torch.sort`` of ``p`` int64 keys (key and value bits
  packed into one word);
- ``scatter_bcast_lane``: ``index_add_`` of ``e`` ones into ``p`` int32
  slots;
- ``pair_gather_random`` / ``pair_gather_sorted``: ``p`` reads of an
  (int32, float32-bits) pair from an ``e``-row table, at random or
  sorted rows; ``i32_gather_random`` one int32 lane,
  ``two_single_gathers_random`` two lanes gathered apart;
- ``searchsorted_probes``: ``torch.searchsorted`` of ``m + 1`` probes into
  ``e`` sorted keys (int64 result); ``rank_trick_probes``: the chain's
  ``ranks_in_sorted`` (the same binary search, int32 result);
- ``slice_fill_buckets``: the sharded exchange's bucket fill
  (``shard.spgemm_sharded._slice_fill_buckets``) of the ``p`` keys and
  values into 8 buckets of ``p / 8`` slots (rounded up to 256, plus 256).

Each rate is seconds per call: ``k`` calls back to back, timed by
``perf.timer.time_device`` (CUDA events on the card, the host clock on
the CPU), the least of 3 runs after one warm run. Run as a module for
the JSON table::

    python -m outerspace_tpu_torch.perf.microbench            # default sizes, on the card
    python -m outerspace_tpu_torch.perf.microbench --small    # small sizes
"""

from __future__ import annotations

import numpy as np

from outerspace_tpu_torch.perf.timer import time_device


def suite(p: int = 917_504, e: int = 196_608, m: int = 16_384,
          k: int = 20, seed: int = 0, device: str = "cuda") -> dict[str, float]:
    """Time each primitive of the module's list on ``device``; returns
    {name: seconds per call}."""
    import torch

    from outerspace_tpu_torch.ops.chain import ranks_in_sorted
    from outerspace_tpu_torch.ops.spgemm import KEY_BIAS, merge_epilogue

    dev = torch.device(device)
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    raw = rng.integers(0, 2**30, size=p)
    kP = put(raw.astype(np.int32))
    vP = put(rng.random(p).astype(np.float32))
    kS = put((np.sort(raw) + KEY_BIAS).astype(np.int32))  # biased, sorted
    pk = put(((raw.astype(np.uint64) << np.uint64(32))
              | rng.random(p, dtype=np.float32).view(np.uint32).astype(np.uint64)).view(np.int64))
    seg = put(np.sort(rng.choice(p, size=e, replace=False)).astype(np.int64))
    ones_e = torch.ones(e, dtype=torch.int32, device=dev)
    acc_p = torch.zeros(p, dtype=torch.int32, device=dev)
    jr_np = rng.integers(0, e, size=p)
    jr, js = put(jr_np.astype(np.int64)), put(np.sort(jr_np).astype(np.int64))
    ti = put(rng.integers(0, m, size=e).astype(np.int32))
    tf_bits = put(rng.random(e).astype(np.float32)).view(torch.int32)
    pair = torch.stack([ti, tf_bits], dim=1)
    kE = put((np.sort(rng.integers(0, m * m, size=e)) + KEY_BIAS).astype(np.int32))
    probes = (torch.arange(m + 1, device=dev, dtype=torch.int64) * m + KEY_BIAS).to(torch.int32)

    from outerspace_tpu_torch.shard.spgemm_sharded import _slice_fill_buckets

    ndst = 8
    cap = max(256, (p // ndst) // 256 * 256 + 256)
    fstarts = put(np.linspace(0, max(p - cap, 0), ndst).astype(np.int32))
    fends = torch.clamp(fstarts + cap - 7, max=p)

    def sort2():
        key, order = torch.sort(kP)
        return key, vP[order]

    def gather_pair(idx):
        g = pair[idx]
        return g[:, 0] + g[:, 1]

    runs = {
        "sort2_p": sort2,
        "merge_epilogue_sorted_p": lambda: merge_epilogue(kS, vP, n_cols=1 << 15,
                                                          sentinel_row=1 << 15),
        "sort1_u64_p": lambda: torch.sort(pk),
        "scatter_bcast_lane": lambda: acc_p.index_add_(0, seg, ones_e),
        "pair_gather_random": lambda: gather_pair(jr),
        "pair_gather_sorted": lambda: gather_pair(js),
        "i32_gather_random": lambda: ti[jr],
        "two_single_gathers_random": lambda: ti[jr] + tf_bits[jr],
        "searchsorted_probes": lambda: torch.searchsorted(kE, probes),
        "rank_trick_probes": lambda: ranks_in_sorted(kE, probes),
        "slice_fill_buckets": lambda: _slice_fill_buckets(fstarts, fends, cap, ndst,
                                                          (kP, 0), (vP, 0.0)),
    }
    return {name: time_device(lambda fn=fn: [fn() for _ in range(k)], reps=3, warmup=1) / k
            for name, fn in runs.items()}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="outerspace_tpu_torch.perf.microbench")
    ap.add_argument("--small", action="store_true", help="small sizes (quick; rates not meaningful)")
    ap.add_argument("--p", type=int, default=None)
    ap.add_argument("--e", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    a = ap.parse_args(argv)
    if a.small:
        p, e, m, k = 16_384, 4_096, 512, 3
    else:
        p, e, m, k = 917_504, 196_608, 16_384, 20
    res = suite(p=a.p or p, e=a.e or e, m=m, k=a.k or k, device=a.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
