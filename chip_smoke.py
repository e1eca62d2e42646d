#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels (``outerspace_tpu_torch/csrc/*.cu``,
into ``build/``), drives the main path — ``spgemm(A, A)`` through the
windowed-gather pipeline — on two workloads and checks each result
exactly against scipy, holds each kernel against its plain PyTorch
version on the card at the main path's shapes, and times the kernels,
their plain versions, ``torch.sort`` and the whole product.

Output: one line per phase with its seconds, a ``{"kernels": [...]}``
JSON line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits nonzero and
prints no last line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6  # summation order differs from the oracle


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
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1

    from outerspace_tpu_torch.formats import erdos_renyi, rmat
    from outerspace_tpu_torch.ops import spgemm
    from outerspace_tpu_torch.ops.gather_pipeline import (
        plan_spgemm_gather,
        spgemm_gather_padded,
    )
    from outerspace_tpu_torch.ops.kernels import gexpand, scan
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
    from outerspace_tpu_torch.ops.spgemm import I32_MAX
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.sched.gplanner import GROUP_SUBS

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
    for name, log in build.build().items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}")
    _phase("build", t0)

    kernels = {"K1": gexpand.KERNEL, "K2": scan.KERNEL}

    def drive(name, a):
        """The main path once through the user entry point, counted."""
        t0 = time.perf_counter()
        want = spgemm_scipy(a, a)
        for k in kernels.values():
            k.launches = 0
        got = spgemm(a, a, device=dev)
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        assert_csr_allclose(got, want, rtol=VAL_RTOL, atol=VAL_ATOL)
        print(f"{name}: A² nnz {got.nnz} == scipy {want.nnz}, structure exact, "
              f"values within rtol {VAL_RTOL} atol {VAL_ATOL}; launches {counts}")
        for n, c in counts.items():
            if c == 0:
                raise RuntimeError(f"{name}: kernel {n} was never launched")
        _phase(f"{name} main path", t0)
        return counts

    a1 = rmat(14, edge_factor=8, seed=1)
    launches = drive("rmat14_ef8", a1)
    a2 = erdos_renyi(100_000, 100_000, 1e-4, seed=3)
    drive("er100k", a2)

    # ---- each kernel against its plain version, on workload 1's streams
    t0 = time.perf_counter()
    a_csc, b_csr = a1.to_csc(), a1.to_csr()
    plan = plan_spgemm_gather(a_csc, b_csr, device=dev)
    k1_in, k2_in = [], []
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
        k2_in.append((skey, sval, pad))
        got = scan.merge_epilogue_scan(skey, sval, pad, n_cols=plan.n, sentinel_row=plan.m)
        want = scan.merge_epilogue_plain(skey, sval, pad, n_cols=plan.n, sentinel_row=plan.m)
        torch.cuda.synchronize()
        for i, nm in ((0, "rows"), (1, "cols"), (3, "valid"), (4, "nnz")):
            if not torch.equal(got[i], want[i]):
                raise RuntimeError(f"K2 {nm} disagrees with its plain version (want exact)")
        if not torch.allclose(got[2], want[2], rtol=VAL_RTOL, atol=VAL_ATOL):
            raise RuntimeError("K2 values disagree with its plain version")
        k2_err = max(k2_err, float((got[2] - want[2]).abs().max()))
    print(f"K1 == plain bit for bit on {len(plan.parts)} parts (values max |err| "
          f"{k1_err:.3e}); K2 structure and nnz exact, values max |err| {k2_err:.3e} "
          f"(rtol {VAL_RTOL}, atol {VAL_ATOL})")
    _phase("kernel check", t0)

    # ---- timing at workload 1's shapes (all parts of one run)
    t0 = time.perf_counter()

    def run_k1(fn):
        return lambda: [fn(*args, b_win=p.b_win) for args, p in k1_in]

    def run_k2(fn):
        return lambda: [fn(k, v, pad, n_cols=plan.n, sentinel_row=plan.m)
                        for k, v, pad in k2_in]

    keys_raw = [gexpand.expand_gather(*args, b_win=p.b_win)[0] for args, p in k1_in]
    k1_ms = _median_ms(torch, run_k1(gexpand.expand_gather))
    k1_plain_ms = _median_ms(torch, run_k1(gexpand.expand_gather_plain), reps=3)
    k2_ms = _median_ms(torch, run_k2(scan.merge_epilogue_scan))
    k2_plain_ms = _median_ms(torch, run_k2(scan.merge_epilogue_plain), reps=3)
    sort_ms = _median_ms(torch, lambda: [torch.sort(k) for k in keys_raw])

    # bound: the larger of bytes moved (each input byte the function needs
    # read once, each output written once) over the HBM rate and float32
    # operations (K1: one multiply per real product; K2: one add per real
    # slot) over the peak. K1 needs, per group, the base pair, the search
    # depth, table lanes 0-3 and 6 of each subtile and lane 5 (n_cols) of
    # one; the part's own A and B blocks (not the zero blocks that pad the
    # parts to one shape, which the clamped reads never reach); and writes
    # 8 B per slot.
    k1_bytes = 0
    for (args, p), k in zip(k1_in, keys_raw):
        groups = args[1].shape[0]
        k1_bytes += groups * (2 * 4 + 4 + GROUP_SUBS * 5 * 4 + 4)
        k1_bytes += p.nab8 * 8 * 4 * 128 * 4 + p.nbb8 * 8 * 2 * 128 * 4
        k1_bytes += k.numel() * 8
    k2_bytes = sum(k.numel() * (4 + 4 + 4 + 4 + 4 + 1) + 4 for k, _, _ in k2_in)
    k1_bound, k1_by = _bound(k1_bytes, plan.flops)
    k2_bound, k2_by = _bound(k2_bytes, plan.flops)
    n_slots = sum(k.numel() for k in keys_raw)
    print(f"rmat14_ef8 streams: {len(k1_in)} parts, {n_slots} slots "
          f"({plan.flops} real products)")
    print(f"K1 {k1_ms:.4f} ms/run (plain {k1_plain_ms:.4f}, bound {k1_bound:.4f}); "
          f"K2 {k2_ms:.4f} ms/run (plain {k2_plain_ms:.4f}, bound {k2_bound:.4f}); "
          f"torch.sort {sort_ms:.4f} ms/run")

    # end to end, split into host plan, device pipeline and fetch to CSR
    splits = []
    for _ in range(3):
        ta = time.perf_counter()
        pl = plan_spgemm_gather(a_csc, b_csr, device=dev)
        torch.cuda.synchronize()
        tb = time.perf_counter()
        merged = spgemm_gather_padded(pl)
        torch.cuda.synchronize()
        tc = time.perf_counter()
        merged.to_csr()
        td = time.perf_counter()
        splits.append(((tb - ta) * 1e3, (tc - tb) * 1e3, (td - tc) * 1e3))
    plan_ms, device_ms, fetch_ms = sorted(splits, key=lambda s: sum(s))[1]
    print(f"rmat14_ef8 end to end {plan_ms + device_ms + fetch_ms:.3f} ms: host plan "
          f"{plan_ms:.3f}, device {device_ms:.3f}, fetch to CSR {fetch_ms:.3f}")
    _phase("timing", t0)

    record = {"kernels": [
        {"name": "K1 gexpand (windowed-gather expand)", "route": "cuda",
         "source": "outerspace_tpu_torch/csrc/gexpand.cu",
         "replaces": "outerspace_tpu/ops/pallas/gexpand.py:60",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "K2 scan (merge epilogue)", "route": "cuda",
         "source": "outerspace_tpu_torch/csrc/scan.cu",
         "replaces": "outerspace_tpu/ops/pallas/scan.py:57",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": sort_ms},
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
