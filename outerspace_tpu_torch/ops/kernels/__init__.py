"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version: ``gexpand`` (K1, the windowed-gather expand) and
``scan`` (K2, the merge epilogue)."""
