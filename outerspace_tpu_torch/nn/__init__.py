"""Sparse-NN inference: the pruned MLP and LeNet forwards through K5, the
block-ELL SpMM kernel (``sparse_infer``), their dense torch models
(``models``), the lowering helpers (``export``) and synthetic inputs
(``data``)."""
