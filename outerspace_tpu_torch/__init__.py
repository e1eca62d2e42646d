"""outerspace_tpu_torch — the PyTorch / CUDA port of the outer-product
SpGEMM framework, for one NVIDIA H100.

It mirrors the JAX package's layout so each module's counterpart is easy
to find, and it imports nothing of that package:

- ``formats``  — COO / CSR / CSC containers, ``CompactCOO``, block-ELL,
  the Matrix Market reader (native by default, or Python) and writer,
  Erdős–Rényi, R-MAT and banded generators (numpy, bit-identical to the
  JAX package's for the same seed).
- ``sched``    — the windowed-gather and tile host planners (numpy, with
  a native C++ core built by g++) and the cost model's strategy pick.
- ``ops``      — single-device SpGEMM (strategies gather, tiles, flat and
  "auto"): host plan, the expand kernels (K1 gather, K3 / K4 dense
  tiles), ``torch.sort``, the merge epilogue kernel (K2), and compaction
  to CSR on the card; triangle counting (``ops.graph``); and K5, the
  block-ELL SpMM; the host reference (``ops.reference``: the task lists,
  the FLOP count, ``compare_coo``).
- ``nn``       — sparse-NN inference: ``SparseMLP`` / ``SparseLeNet``
  through K5, the SpGEMM forwards, the dense torch models; and the
  training pipeline: train, magnitude-prune, finetune, export ``.mtx``
  operands.
- ``cli``      — ``python -m outerspace_tpu_torch.cli``: ``spgemm M1.mtx
  M2.mtx`` (C = M1·M2ᵀ with the roofline beside the measured time),
  ``graph {triangles,mcl} G.mtx`` and ``nn ...`` (the NN pipeline).
- ``perf``     — the card's roofline (``perf.roofline``), the program's
  spans and counters and timing with CUDA events (``perf.timer``) and
  primitive micro-benchmarks (``perf.microbench``).
- ``convert``  — operands, plans and trained weights carried across from
  the JAX package's formats.
- ``runtime``  — builds the hand-written CUDA kernels in ``csrc/`` with
  ``nvcc`` (and the host libraries with ``g++``: the planner core, the
  Matrix Market reader and the CPU reference SpGEMM of
  ``runtime.native``) at first use and loads them with ``ctypes``.

Entry points take an explicit ``device`` ("cuda" by default; pass "cpu"
to run each kernel's plain PyTorch version).
"""

__version__ = "0.1.0"

from outerspace_tpu_torch.formats import COO, CSC, CSR, read_mtx  # noqa: F401
