"""One run of one benchmark cell on the card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the mix names the entry driver
(``benchmark/entries/``) that builds the inputs from ``--seed`` and
calls the program (``outerspace_tpu_torch``). The run

1. sets up: builds the inputs, stages the program and warms every shape
   the mix uses (``setup_s``: from process start to the window's start;
   the kernels' first build happens here, into ``build/`` in the
   checkout);
2. runs a closed loop for ``--seconds``: one call at a time, the next
   one's inputs drawn when the last returns; with ``--trace 1`` the
   profiler records the first ``trace_calls`` calls of the window;
3. reads the device's memory peak, frees the program's state, and
   checks the sampled answers against the plain reference
   (``benchmark/reference/``), each number beside its limit
   (``benchmark/workloads/<cell>.json``);
4. prints one JSON line last on stdout: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and ``checks`` last; the same checks are the last
   lines of stderr.

It exits 2, printing no result, without a CUDA card (or fewer than the
cell asks for), and 3 if a module of JAX or of the JAX package
(``outerspace_tpu``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import trace as tracing  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from benchmark.sample import Sample  # noqa: E402
from benchmark.work.peaks import peaks_for  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "outerspace_tpu")


def pin_caches(repo: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(repo / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(repo / "build" / "triton")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def stat(kind: str, durations: list[float], window_s: float) -> float:
    """An end-to-end statistic of the window: ``ms_per_call`` (the window
    over the calls completed) or ``p95_ms`` (the 95th percentile of the
    calls' own times)."""
    if kind == "ms_per_call":
        return 1e3 * window_s / len(durations)
    if kind == "p95_ms":
        return 1e3 * float(np.percentile(np.asarray(durations), 95))
    raise ValueError(f"unknown statistic {kind!r}")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm(entry, calls: int, device) -> float:
    """The warm-up calls of set-up (negative call numbers); returns the
    last one's seconds, the pace of a warm call."""
    call_s = 0.0
    for j in range(calls):
        c0 = time.perf_counter()
        entry.call(entry.operand(-1 - j))
        _sync(device)
        call_s = time.perf_counter() - c0
    return max(call_s, 1e-6)


def closed_loop(entry, seconds: float, trace_calls: int, device) -> dict:
    """Calls ``entry`` one at a time until ``seconds`` have passed. With
    ``trace_calls`` the profiler, started just before the window, records
    the first that many calls, each inside a :data:`trace.CALL_SPAN`
    span, and its trace is written to a temporary file once the window
    has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    durations, cpu_ms, failed, first_error = [], [], 0, None
    prof = None
    if trace_calls:
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while time.perf_counter() < deadline:
        operand = entry.operand(i)
        c0, p0 = time.perf_counter(), time.process_time()
        try:
            if prof is not None and i < trace_calls:
                with record_function(tracing.CALL_SPAN):
                    out = entry.call(operand)
            else:
                out = entry.call(operand)
        except Exception:  # a failed call counts; the loop goes on
            failed += 1
            first_error = first_error or traceback.format_exc()
            out = None
        durations.append(time.perf_counter() - c0)
        cpu_ms.append(1e3 * (time.process_time() - p0))
        if out is not None:
            entry.observe(i, out)
        i += 1
        if prof is not None and i == trace_calls:
            _sync(device)
            prof.stop()
    window_s = time.perf_counter() - t_start
    if prof is not None and i < trace_calls:
        _sync(device)
        prof.stop()
    trace_path = None
    if prof is not None:
        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_path)
    return {"durations": durations, "failed": failed, "first_error": first_error,
            "window_s": window_s, "trace_path": trace_path, "cpu_ms": cpu_ms}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool, device,
             t_process: float = T_PROCESS) -> dict:
    """Set-up, window and check of cell ``name``; returns the result line
    (without ``device``'s card fields, which :func:`main` adds)."""
    import torch

    cell = manifest.cell(name)
    traffic = manifest.traffic(cell["traffic"])
    cell_file = manifest.cell_file(name)
    Entry = manifest.entry(traffic["entry"])
    entry = Entry(manifest.config(cell["config"]), traffic, seed, device,
                  **cell_file.get("check", {}))
    call_s = warm(entry, traffic["warm_calls"], device)
    entry.stage(math.ceil(2 * seconds / call_s) + 8)
    setup_s = time.perf_counter() - t_process
    entry.sample = Sample.paced(traffic["check_calls"], seed, seconds, call_s)

    loop = closed_loop(entry, seconds, traffic["trace_calls"] if trace else 0, device)
    attempted, durations = len(loop["durations"]), loop["durations"]
    is_cuda = torch.device(device).type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    entry.release()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    if loop["first_error"]:
        print(loop["first_error"], file=sys.stderr)

    numbers = entry.check() if attempted > loop["failed"] else {}
    limits = cell_file["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    correct = (loop["failed"] == 0 and attempted > 0
               and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))

    result = {"correct": correct, "attempted": attempted, "failed": loop["failed"]}
    device_info = {"memory_peak_bytes": int(memory_peak)}
    if not trace:
        units = {m["name"]: m["unit"] for m in manifest.end_to_end(name)}
        metrics = {m: {"value": stat(kind, durations, loop["window_s"]), "unit": units[m]}
                   for m, kind in traffic["end_to_end"].items() if durations}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    else:
        kind = torch.cuda.get_device_name() if is_cuda else "cpu"
        rec = tracing.load(loop["trace_path"], entry.work(), peaks_for(kind))
        os.unlink(loop["trace_path"])
        metrics = {}
        for m in manifest.per_layer(name):
            value = manifest.reader(m["name"])(rec) if rec.calls else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if rec.calls:
            device_info["busy_s"] = tracing.busy_us(rec) / 1e6
            device_info["window_s"] = (rec.window[1] - rec.window[0]) / 1e6
            result["breakdown"] = tracing.breakdown(rec)
    result["metrics"] = metrics
    result["device"] = device_info
    ms = 1e3 * np.asarray(durations) if durations else np.zeros(1)
    quantiles = [0, 25, 50, 75, 95, 100]
    result["info"] = {"setup_s": setup_s, "window_s": loop["window_s"],
                      "call_ms": [float(x) for x in np.percentile(ms, quantiles)],
                      # the process's CPU time in each call: where it tracks
                      # call_ms, the call is the host's
                      "call_cpu_ms": [float(x) for x in np.percentile(loop["cpu_ms"] or [0], quantiles)],
                      **entry.info()}
    if trace:
        result["info"].update(traced_calls=len(rec.calls), work=rec.work, peaks=rec.peaks)
    result["durations"] = durations
    result["checks"] = checks
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    pin_caches(REPO)
    manifest = Manifest(REPO)
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                        "count": cell["chips"], **result["device"]}
    if args.trace:
        result["info"]["card"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result["info"]), file=sys.stderr)
    print("call_ms " + " ".join(f"{1e3 * d:.1f}" for d in result.pop("durations")), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
