"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``gexpand`` (K1, the windowed-gather expand), ``scan`` (K2, the merge
epilogue), ``expand`` (K3/K4, the dense-tile expands), ``spmm`` (K5,
the block-ELL SpMM) and ``compact`` (the prune and compaction after the
MCL chain's first squaring, which replaces no Pallas kernel); K2 and
``compact`` each have a 64-bit-key instantiation beside the 32-bit one."""


def counters() -> dict:
    """Each kernel's wrapper by name ("K1"-"K5", "prune_compact", and the
    64-bit-key instantiations "K2_64", "prune_compact_64"); its
    ``launches`` counts the launches of the kernel in this process."""
    from outerspace_tpu_torch.ops.kernels import compact, expand, gexpand, scan, spmm

    return {"K1": gexpand.KERNEL, "K2": scan.KERNEL, "K3": expand.KERNEL_PACKED,
            "K4": expand.KERNEL_COORDS, "K5": spmm.KERNEL, "prune_compact": compact.KERNEL,
            "K2_64": scan.KERNEL_64, "prune_compact_64": compact.KERNEL_64}
