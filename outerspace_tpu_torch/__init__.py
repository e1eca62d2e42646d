"""outerspace_tpu_torch — the PyTorch / CUDA port of the outer-product
SpGEMM framework, for one NVIDIA H100.

It mirrors the JAX package's layout so each module's counterpart is easy
to find, and it imports nothing of that package:

- ``formats``  — COO / CSR / CSC containers, Matrix Market reader,
  Erdős–Rényi and R-MAT generators (numpy, bit-identical to the JAX
  package's for the same seed).
- ``sched``    — the windowed-gather host planner (numpy).
- ``ops``      — the single-device SpGEMM main path: host plan, the
  gather expand kernel (K1), ``torch.sort``, the merge epilogue kernel
  (K2), and compaction to CSR.
- ``runtime``  — builds the hand-written CUDA kernels in ``csrc/`` with
  ``nvcc`` at first use and loads them with ``ctypes``.

Entry points take an explicit ``device`` ("cuda" by default; pass "cpu"
to run each kernel's plain PyTorch version).
"""

__version__ = "0.1.0"

from outerspace_tpu_torch.formats import COO, CSC, CSR, read_mtx  # noqa: F401
