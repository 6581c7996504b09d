"""The benchmark of ``netrep_tpu_torch`` on one NVIDIA H100: a harness
driven by data (``BENCHMARK.json`` at the checkout's root names the cells;
each configuration, traffic mix, check limit and per-layer metric is a file
of its own here). ``python portbench/run.py --help`` runs one cell once."""
