"""The benchmark of ``repro_torch``: the live cascade's server on one card.

``python3 cascade_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. See ``harness.py`` for what a run does and ``check.py`` for
what decides ``correct``.
"""
