"""The benchmark of ``repro_torch``: one cell a run, driven by
``BENCHMARK.json`` (``python3 bench/run.py --workload <cell> ...``).

Everything that decides a measurement lives here and not in the
program: the traffic generator (``corpus.py``), the
roofline counts (``roofline.py``), the trace reduction (``trace.py``),
the per-layer readers (``metrics/``), the plain reference and the
comparison that decides ``correct`` (``reference/``). Configurations,
traffic mixes and limits are data files found by name.
"""
