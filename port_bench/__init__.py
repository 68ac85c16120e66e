"""The benchmark of dafoam_tpu_torch on one NVIDIA H100.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations, traffic mixes, cells and per-layer metrics are
files under this folder, found by the names ``BENCHMARK.json`` gives
(README.md).
"""
