"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``gexpand`` (K1, the windowed-gather expand), ``scan`` (K2, the merge
epilogue), ``expand`` (K3/K4, the dense-tile expands), ``spmm`` (K5,
the block-ELL SpMM), ``compact`` (the prune and compaction after the
MCL chain's first squaring, and after each loop squaring in order) and
``loop_expand`` (the expand of each MCL loop squaring), the last two
replacing no Pallas kernel; K2, ``compact``'s two kernels and
``loop_expand`` each have a 64-bit-key instantiation beside the 32-bit
one."""


def counters() -> dict:
    """Each kernel's wrapper by name ("K1"-"K5", "prune_compact",
    "loop_expand", "loop_compact", and the 64-bit-key instantiations
    "K2_64", "prune_compact_64", "loop_expand_64", "loop_compact_64"); its
    ``launches`` counts the launches of the kernel in this process."""
    from outerspace_tpu_torch.ops.kernels import compact, expand, gexpand, loop_expand, scan, spmm

    return {"K1": gexpand.KERNEL, "K2": scan.KERNEL, "K3": expand.KERNEL_PACKED,
            "K4": expand.KERNEL_COORDS, "K5": spmm.KERNEL, "prune_compact": compact.KERNEL,
            "K2_64": scan.KERNEL_64, "prune_compact_64": compact.KERNEL_64,
            "loop_expand": loop_expand.KERNEL, "loop_expand_64": loop_expand.KERNEL_64,
            "loop_compact": compact.LOOP_KERNEL, "loop_compact_64": compact.LOOP_KERNEL_64}
