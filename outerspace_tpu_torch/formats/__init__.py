"""Sparse format layer: containers, ``CompactCOO``, block-ELL, Matrix
Market reader (native and Python) and writer, generators."""

from outerspace_tpu_torch.formats.coo import (  # noqa: F401
    COO,
    INDEX_DTYPE,
    VALUE_DTYPE,
    DuplicateCoordinateError,
)
from outerspace_tpu_torch.formats.compact import BlockELL, CompactCOO  # noqa: F401
from outerspace_tpu_torch.formats.csr import CSC, CSR  # noqa: F401
from outerspace_tpu_torch.formats.generators import (  # noqa: F401
    banded,
    erdos_renyi,
    rmat,
)
from outerspace_tpu_torch.formats.mtx import read_mtx, write_mtx  # noqa: F401
