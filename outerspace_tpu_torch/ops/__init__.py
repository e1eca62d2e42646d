"""The single-device SpGEMM main path and its oracles."""

from outerspace_tpu_torch.ops.reference import (  # noqa: F401
    assert_csr_allclose,
    spgemm_scipy,
)
from outerspace_tpu_torch.ops.spgemm import MergedCOO, spgemm  # noqa: F401
from outerspace_tpu_torch.ops.symbolic import expansion_plan  # noqa: F401
