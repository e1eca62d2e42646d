"""The benchmark of the PyTorch / CUDA port (``outerspace_tpu_torch``):
``python -m benchmark.run`` runs one cell of ``BENCHMARK.json`` on the
card (see ``benchmark/run.py``)."""
