"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

One command runs one cell (a configuration under a traffic mix) once::

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric,
kernel cost or reference sits in a file of its own that the harness finds by
the name `BENCHMARK.json` gives it:

* ``configs/<config>.json`` (sizes as run) and ``configs/<config>.py`` (the
  app adapter, weight init, FLOP count and kernel calls);
* ``traffic/<traffic>.json`` (generator parameters, reorder, band, splits);
* ``cells/<cell>.json`` (the limits of the numbers that decide ``correct``);
* ``metrics/<metric>.py`` (a reader: ``read(ctx) -> float | None``);
* ``costs/<kernel>.py`` (operations and bytes of one call);
* ``reference/<config>.py`` (plain float32 PyTorch, no package of this repo).
"""
