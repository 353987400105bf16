"""Drivers: one module a kind of workload, named by the traffic mix's
``driver`` key and found as ``drivers/<driver>.py``.

A driver module exposes ``prepare(cell, seed, device)``, which builds
the cell's work for a seed and returns an object with:

- ``warm()``: set-up at the cell's own shapes, before the window;
- ``call()``: one unit of the window's work, finished on the device; its
  outputs, which ``check`` judges;
- ``slots``: the simulated steps a call runs (the per-layer readers'
  unit), and ``shape``: the sizes that the cost counts read;
- ``end_to_end(calls, seconds)``: the window's end-to-end metrics other
  than ``setup_s``, by name;
- ``attempted(calls)``: the answers that ``calls`` calls produced;
- ``check(outputs)``: after the window, the comparison with the plain
  reference, ``({name: {"value", "limit"}}, failed)``.

and ``control(cell, seed, device, program)``, the readings that set the
limits (``python3 -m portbench.control``): a dict with the control's
readings under ``control_<check>`` and, with ``program``, the program's
under ``program_<check>``.
"""
