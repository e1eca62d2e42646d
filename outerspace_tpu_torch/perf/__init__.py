"""Performance models and instrumentation: the card's roofline
(``perf/roofline.py``), scope timers and device-synchronised timing
(``perf/timer.py``), and primitive micro-benchmarks
(``perf/microbench.py``)."""

from outerspace_tpu_torch.perf.roofline import (  # noqa: F401
    GPUConfig,
    predict_merge_time,
    predict_multiply_time,
    predict_spgemm_time,
)
from outerspace_tpu_torch.perf.timer import Timer, timed  # noqa: F401
