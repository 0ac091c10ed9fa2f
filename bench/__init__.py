"""The benchmark of repro_torch: see bench/harness.py and BENCHMARK.json."""
