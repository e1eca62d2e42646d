"""State carried across from the JAX package.

The main path has no weights: its state is the operands and the plan.
These take an operand's compressed arrays as numpy arrays (for example
the ``indptr``/``indices``/``data`` of one of the JAX package's
containers) and return the port's containers, so both packages can be
fed the same operand.
"""

from __future__ import annotations

import numpy as np

from outerspace_tpu_torch.formats.csr import CSC, CSR


def csr_from_arrays(shape, indptr, indices, data) -> CSR:
    """The port's CSR from compressed-row arrays (copied)."""
    return CSR(tuple(shape), np.array(indptr), np.array(indices), np.array(data))


def csc_from_arrays(shape, indptr, indices, data) -> CSC:
    """The port's CSC from compressed-column arrays (copied)."""
    return CSC(tuple(shape), np.array(indptr), np.array(indices), np.array(data))
