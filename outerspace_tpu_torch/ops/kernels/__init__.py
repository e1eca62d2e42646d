"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``gexpand`` (K1, the windowed-gather expand), ``scan`` (K2, the merge
epilogue), ``expand`` (K3/K4, the dense-tile expands) and ``spmm`` (K5,
the block-ELL SpMM)."""
