"""The benchmark of madarch_tpu_torch on one CUDA card.

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix) and prints one JSON line: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Everything is found by name: a configuration is ``configs/<name>.json``,
a traffic mix ``traffic/<name>.json`` (read by the one generator in
``traffic.py``), a per-layer metric the reader ``metrics/<name>.py``, a
cell's correctness limits ``limits/<cell>.json``.  ``program.py`` is the
only module that imports the port; ``reference/`` is the plain reference
(a frozen copy of the port's plain path), ``check.py`` the comparison that
decides ``correct``, ``tracing.py`` and ``roofline.py`` the yardstick's
readers and peaks.
"""
