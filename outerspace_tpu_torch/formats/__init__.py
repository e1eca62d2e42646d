"""Sparse format layer: containers, Matrix Market reader, generators."""

from outerspace_tpu_torch.formats.coo import (  # noqa: F401
    COO,
    INDEX_DTYPE,
    VALUE_DTYPE,
)
from outerspace_tpu_torch.formats.csr import CSC, CSR  # noqa: F401
from outerspace_tpu_torch.formats.generators import (  # noqa: F401
    erdos_renyi,
    rmat,
)
from outerspace_tpu_torch.formats.mtx import read_mtx  # noqa: F401
