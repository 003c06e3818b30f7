"""The benchmark of kgdet_tpu_torch (see BENCHMARK.json and PERF.md)."""
