"""Test-size cuts of the configurations added after the benchmark's first
tests, registered with their fixtures (``tests/conftest.py``'s ``TINY``,
which cuts each configuration it names when it copies the benchmark)."""

from benchmark.tests import conftest as _fixtures

_fixtures.TINY.setdefault("lfr19_k20_mu03", {"n_vertices": 1024})
