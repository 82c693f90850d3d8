"""The benchmark of ``retto_tpu_torch`` on NVIDIA H100 cards: ``python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line."""
