"""Performance models and instrumentation: the card's roofline
(``perf/roofline.py``), the event model of the card's machine
(``perf/perfsim.py`` over ``csrc/perfsim.cpp``; ``perf/simcal.py``
measures its fields on the card), the program's spans and counters and
device-synchronised timing (``perf/timer.py``, imported on its own), and
primitive micro-benchmarks (``perf/microbench.py``)."""

from outerspace_tpu_torch.perf.perfsim import (  # noqa: F401
    CARD_CONFIG,
    SPEC_CONFIG,
    get_config,
    set_config,
    simulate_expand_cached,
    simulate_mcl_sharded_iteration,
    simulate_merge_parts,
    simulate_sharded_tiled,
)
from outerspace_tpu_torch.perf.roofline import (  # noqa: F401
    GPUConfig,
    predict_merge_time,
    predict_multiply_time,
    predict_spgemm_time,
)
