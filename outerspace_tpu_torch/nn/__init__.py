"""The NN pipeline: training, evaluation and finetuning (``train``),
magnitude pruning (``prune``), the torch models and their flax
initialisation (``models``), MNIST and synthetic data (``data``), export
of layers as ``.mtx`` SpGEMM operands (``export``), and sparse-NN
inference: the pruned MLP and LeNet forwards through K5, the block-ELL
SpMM kernel (``sparse_infer``)."""
