"""The benchmark of madarch_tpu_torch on one CUDA card.

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix) and prints one JSON line: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Everything is found by name: a configuration is ``configs/<name>.json``,
a traffic mix ``traffic/<name>.json`` (read by the one generator in
``traffic.py``), a per-layer metric the reader ``metrics/<name>.py``, a
cell's correctness limits ``limits/<cell>.json``, a configuration's plain
reference the package its ``reference`` key names (``reference/``, a
frozen copy of the port's plain path, without one).  ``program.py`` is
the only module that imports the port; ``check.py`` is the comparison
that decides ``correct`` and states what it takes from a reference
package; ``tracing.py`` and ``roofline.py`` are the yardstick's readers
and peaks.
"""
