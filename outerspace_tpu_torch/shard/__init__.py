"""Partitioning helpers (numpy). The sharded mode is not ported yet."""
