"""Drivers of the program's entry points, one module per entry, each
with an ``Entry`` class that ``benchmark.run`` drives:

- ``Entry(config, traffic, seed, device, program=None, **check)`` builds
  the inputs from ``seed`` and stages the system under test (``program``
  replaces it, as the control and the tests do);
- ``operand(i)`` gives call ``i``'s inputs (outside the call's time;
  set-up's warm-up calls take negative numbers), ``stage(calls)``
  draws the first ``calls`` of the window's in set-up,
  ``call(operand)`` runs one call and returns its answer as a host CSR
  ``(shape, indptr, indices, data)``, ``observe(i, answer)`` keeps what
  the check needs;
- ``release()`` frees the program's state once the window has closed;
- ``check()`` returns the compared numbers, ``info()`` what a run
  reports beside them, ``work()`` one call's work for the rooflines.
"""
