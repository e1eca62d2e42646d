"""Settings of the port's ``spgemm``. The JAX package's ``Config`` holds
more (kernel tiling, mesh, benchmark selection); a field comes over when
a module of the port reads it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # Tile planner waste limit; None = the cost model's per-operand pick
    # (sched/autotune.py).
    waste_limit: float | None = None


DEFAULT = Config()
