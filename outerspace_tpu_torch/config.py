"""Settings of the port's ``spgemm``, with the command line's
``--set key=value`` overrides (``Config.override``, the JAX package's
``config.py`` parsing rules). The JAX package's ``Config`` holds more
(kernel tiling, mesh, benchmark selection); a field comes over when a
module of the port reads it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # Tile planner waste limit; None = the cost model's per-operand pick
    # (sched/autotune.py).
    waste_limit: float | None = None

    def override(self, assignments: list[str]) -> "Config":
        """A copy with ``key=value`` strings applied. A value is parsed by
        the field's current type (a field at None takes a float where the
        value is one, else the string); an unknown key raises KeyError."""
        out = dataclasses.replace(self)
        for a in assignments:
            key, _, value = a.partition("=")
            if not hasattr(out, key):
                raise KeyError(f"unknown config key {key!r}")
            current = getattr(out, key)
            if current is None:
                try:
                    parsed = float(value)
                except ValueError:
                    parsed = value
            elif isinstance(current, bool):
                parsed = value.lower() in ("1", "true", "yes")
            elif isinstance(current, int):
                parsed = int(value)
            elif isinstance(current, float):
                parsed = float(value)
            elif isinstance(current, tuple):
                parsed = tuple(int(v) if v.isdigit() else v for v in value.split(",") if v)
            else:
                parsed = value
            setattr(out, key, parsed)
        return out


DEFAULT = Config()
