"""Per-layer metrics, one module each, named as in BENCHMARK.json."""
