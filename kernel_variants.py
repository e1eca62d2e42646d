#!/usr/bin/env python3
"""Time variants of K2 (``csrc/scan.cu``) and K5 (``csrc/spmm.cu``) on one
NVIDIA card, at the shapes ``chip_smoke.py`` drives: the five sorted
streams of rmat14_ef8 A² on the gather path (K2) and the eight layers of
one MLP1w b1024 and one LeNet b256 forward with the committed weights
(K5). Run from the repository root:

    python3 kernel_variants.py

Each variant is the kernel's source with some of its constants (or one
line) replaced, built with the port's ``nvcc`` flags into
``build/variants/``. A variant that computes the same function is held
against the plain PyTorch version; one marked "timing only" does not.
It prints each variant's device ms (``torch.profiler``, the sum of its
kernels' durations, mean of 5 runs) and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import chip_smoke as smoke

# K2: (name, replacements, slots per tile, computes the kernel's function)
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
    """One library per variant, all built together; returns name → CDLL."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / f"{source}.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(variants):
        src = text
        for old, new in subs:
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from outerspace_tpu_torch.convert import load_params
    from outerspace_tpu_torch.formats import rmat
    from outerspace_tpu_torch.nn import sparse_infer
    from outerspace_tpu_torch.nn.data import synthetic_mnist
    from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather
    from outerspace_tpu_torch.ops.kernels import gexpand, scan, spmm
    from outerspace_tpu_torch.ops.spgemm import I32_MAX
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.runtime.build import device_args, tensor_ptr

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {smoke._card_line()}")

    # K2's inputs: the sorted, sentinel-padded streams of each gather part
    a = rmat(14, edge_factor=8, seed=1)
    plan = plan_spgemm_gather(a.to_csc(), a.to_csr(), device=dev)
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
    print(smoke._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
